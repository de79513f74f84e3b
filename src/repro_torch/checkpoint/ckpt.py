"""Checkpointing: atomic, step-stamped (``repro.checkpoint.ckpt``).

Layout, the reference's, so that a checkpoint written by either package
restores in the other:

    <dir>/step_000000123/
        meta.json        step, {flat key: file}, {flat key: dtype name}, extra
        <file>.npy       one array per leaf, on the host
    <dir>/step_000000123.tmp-*   staging directory, renamed atomically

A partial checkpoint is never visible (the rename), ``all_steps`` skips
directories without a ``meta.json``, and ``save`` prunes to the newest
``keep``. bfloat16 leaves are stored as a uint16 view with the dtype name
``"bfloat16"`` and read back through a torch view.

Flat keys are the reference's pytree paths joined by ``::``: a
:class:`~repro_torch.core.parafac2.Parafac2State` gives ``.H``, ``.V``,
``.W`` (``.W::0``, ``.W::1``, ... for the bucketed layout), ``.fit`` and
``.aux::v::0``, ``.aux::w::0::1``, ...; a NamedTuple its fields (an
``AdamWState`` in a ``(params, opt)`` tuple: ``1::.step``, ``1::.m::embed::
tokens``, ...); a dict gives its keys (``H``, ``sub_resid``); a list or
tuple its indices. Empty containers (a direct
constraint's ``()``) have no leaves. Leaves are torch tensors or numpy
arrays; ``restore`` gives each the template leaf's dtype and, for a
tensor, its device.

Across the mesh engine's ranks (``shardings=``, a tree of
``torch.distributed.tensor.placement_types`` placements shaped like the
state, and ``mesh=``, a ``DeviceMesh``): ``save`` gathers every
``Shard(0)`` leaf (a bucketed W and its duals) over the subject dimensions
and rank 0 alone writes the globally unsharded arrays, the reference's
layout, so that either package, and any number of ranks, can read them;
the ranks wait for the write. ``restore`` gives each rank its contiguous
chunk of a ``Shard(0)`` leaf and the whole of a ``Replicate()`` leaf, as the
reference's ``jax.device_put(arr, sharding)`` does: a checkpoint written
under n ranks restores under m ranks where m divides the leaf's rows (the
plan's ``subject_align``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save", "restore", "latest_step", "all_steps"]

_SEP = "::"


def _children(node) -> Optional[list]:
    """``[(path entry, child), ...]`` of a container, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):     # a NamedTuple
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    flat: Dict[str, Any] = {}
    for name, child in kids:
        flat.update(_flatten(child, prefix + (name,)))
    return flat


def _rebuild(tree, leaf_fn, prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``leaf_fn(key, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return leaf_fn(_SEP.join(prefix), tree)
    vals = [_rebuild(c, leaf_fn, prefix + (n,)) for n, c in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    if isinstance(tree, (list, tuple)):
        return type(tree)(vals)
    return dataclasses.replace(tree, **{f.name: v for f, v in
                                        zip(dataclasses.fields(tree), vals)})


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:          # numpy has no bf16: its bits
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _shard_of(mesh) -> Tuple[int, int, Any]:
    """(this rank's chunk index, the chunk count, the subject group) on
    ``mesh``: (0, 1, None) without one."""
    from repro_torch.dist import sharding as dsh

    if mesh is None:
        return 0, 1, None
    axes = dsh.subject_mesh_axes(mesh)
    index, count = dsh.subject_shard(mesh, axes)
    return index, count, dsh.axis_group(mesh, axes)


def _sharded_keys(shardings) -> Dict[str, bool]:
    """flat key -> whether the leaf is split by its first dimension."""
    if shardings is None:
        return {}
    return {k: bool(p.is_shard(0)) for k, p in _flatten(shardings).items()}


def _gathered(leaf: torch.Tensor, count: int, group) -> torch.Tensor:
    parts = [torch.empty_like(leaf) for _ in range(count)]
    dist.all_gather(parts, leaf.contiguous(), group=group)
    return torch.cat(parts)


def _fname(key: str) -> str:
    return f"{abs(hash(key)) % 10**12:012d}.npy"


def save(directory: str, step: int, tree: Any, *, extra: Optional[Dict] = None,
         keep: int = 3, shardings: Any = None, mesh=None) -> str:
    """Atomically write a checkpoint; prune to the newest ``keep``. With
    ``shardings`` and ``mesh`` every rank calls it: the ``Shard(0)`` leaves
    are gathered, rank 0 writes, and every rank returns after the write."""
    final = os.path.join(directory, f"step_{step:09d}")
    flat = _flatten(tree)
    _, count, group = _shard_of(mesh)
    if count > 1:
        split = _sharded_keys(shardings)
        flat = {k: _gathered(v, count, group) if split.get(k) else v for k, v in flat.items()}
    if mesh is None or dist.get_rank() == 0:
        _write(directory, step, final, flat, extra, keep)
    if mesh is not None:
        dist.barrier(group=group)
    return final


def _write(directory: str, step: int, final: str, flat: Dict[str, Any],
           extra: Optional[Dict], keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp-", dir=directory)
    dtypes = {}
    for key, leaf in flat.items():
        arr = _to_numpy(leaf)
        dtypes[key] = (str(leaf.dtype).removeprefix("torch.") if isinstance(leaf, torch.Tensor)
                       else arr.dtype.name)
        np.save(os.path.join(staging, _fname(key)), arr)
    meta = {"step": step, "keys": {key: _fname(key) for key in flat},
            "dtypes": dtypes, "extra": extra or {}}
    with open(os.path.join(staging, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(staging, final)
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(directory, name, "meta.json")):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree_like: Any, *, step: Optional[int] = None,
            shardings: Any = None, mesh=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (the newest step by
    default): each leaf takes the template leaf's dtype, and a tensor leaf
    its device; a leaf the checkpoint lacks raises ``KeyError``. With
    ``shardings`` and ``mesh`` a ``Shard(0)`` leaf is this rank's chunk of
    the stored rows (the rows must divide by the chunk count)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    base = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    arrays = {}
    for key in _flatten(tree_like):
        fname = meta["keys"].get(key)
        if fname is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arrays[key] = np.load(os.path.join(base, fname))
    index, count, _ = _shard_of(mesh)
    for key, split in _sharded_keys(shardings).items():
        if split and count > 1 and key in arrays:
            rows = arrays[key].shape[0]
            if rows % count:
                raise ValueError(f"checkpoint leaf {key!r} has {rows} rows, which do not "
                                 f"divide into {count} subject shards")
            n = rows // count
            arrays[key] = arrays[key][index * n:(index + 1) * n]

    def leaf(key, like):
        arr = arrays[key]
        bf16 = meta.get("dtypes", {}).get(key) == "bfloat16"
        t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
        if bf16:
            t = t.view(torch.bfloat16)
        if isinstance(like, torch.Tensor):
            return t.to(device=like.device, dtype=like.dtype)
        if isinstance(like, np.ndarray):
            return t.to(torch.float32).numpy().astype(like.dtype) if bf16 else arr.astype(like.dtype)
        return t

    return _rebuild(tree_like, leaf), int(meta["step"]), meta.get("extra", {})
