"""Named-axis rules and the subject-axis collectives (the subject half of
``repro.dist.sharding``) on ``torch.distributed``.

Code names logical axes (``"batch"``, ``"heads"``, ``"subjects"``, ...); a
rule table maps each to zero or more mesh dimensions (``"pod"``,
``"data"``, ``"model"``), installed with :func:`axis_rules` together with a
``torch.distributed.device_mesh.DeviceMesh``. ``LM_RULES`` is the
megatron-style layout of the reference; ``SP_RULES`` also shards the
residual stream's sequence axis over ``"model"``.

The ``"subjects"`` axis is the PARAFAC2 workload: SPARTan's per-subject
partial MTTKRP results are plain sums over it ("sum partial results in
parallel"), and it maps to every mesh dimension, since the decomposition
has no tensor-parallel dimension. The port runs one process a GPU, and each
holds only its own subjects (``repro_torch.core.irregular.bucketize(...,
shard=...)``); inside a :func:`subject_collectives` block,
:func:`psum_subjects` is an explicit ``all_reduce(SUM)`` over the subject
dimensions' process group, and outside one it is the identity, as the
reference's ``lax.psum`` inside ``shard_map`` is. Nothing is sharded
automatically: no DTensor, and :func:`shard` is the identity (the
reference's ``shard`` is a no-op without a mesh and inside ``shard_map``,
the only places this package runs it).

The reference's parameter half (``logical_spec``, ``enforce_divisible``,
``param_spec``, ``param_shardings``, ``barrier``, ``unroll_loops``) belongs
to the LM testbed and waits for it (ROADMAP A8).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "LM_RULES", "SP_RULES", "Rules", "axis_rules", "current_mesh",
           "current_rules", "psum_subjects", "shard", "subject_collectives",
           "subject_group", "subject_mesh_axes", "subject_shard"]

# one rule table entry: logical axis name -> mesh dimension name(s) or None
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

_DP = ("pod", "data")   # data-parallel mesh dimensions (no "pod" on one pod)

LM_RULES: Rules = {
    "batch": _DP,
    "tokens": _DP,
    # PARAFAC2 subjects: over every mesh dimension, "model" included
    "subjects": ("pod", "data", "model"),
    "seq": None,
    "seq_res": None,
    "embed": None,
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": "model",
}

SP_RULES: Rules = {**LM_RULES, "seq_res": "model"}


class _Ctx(threading.local):
    def __init__(self):
        self.stack = []       # [(rules, mesh), ...]
        self.collective = []  # [(axis_names, mesh), ...] inside subject_collectives


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(rules: Rules, mesh=None):
    """Install a (rules, mesh) pair; ``mesh`` is a ``DeviceMesh`` or None."""
    _CTX.stack.append((rules, mesh))
    try:
        yield
    finally:
        _CTX.stack.pop()


def current_rules() -> Optional[Rules]:
    return _CTX.stack[-1][0] if _CTX.stack else None


def current_mesh():
    return _CTX.stack[-1][1] if _CTX.stack else None


def subject_mesh_axes(mesh, rules: Optional[Rules] = None) -> Tuple[str, ...]:
    """The mesh dimensions the "subjects" logical axis resolves to on
    ``mesh`` (the dimensions :func:`psum_subjects` reduces over)."""
    rules = rules if rules is not None else (current_rules() or LM_RULES)
    entry = rules.get("subjects")
    if entry is None:
        return ()
    names = entry if isinstance(entry, tuple) else (entry,)
    return tuple(n for n in names if n in (mesh.mesh_dim_names or ()))


class CollectiveCounts:
    """The subject all-reduces issued (``calls``) and their bytes, since the
    last :meth:`reset`: what a captured iteration moves across ranks."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0

    def add(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()


COLLECTIVES = CollectiveCounts()


def subject_group(mesh, axis_names: Sequence[str]):
    """The process group over ``mesh``'s ``axis_names`` dimensions: the one
    dimension's group, or the flattened group of several."""
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        return mesh.get_group(axis_names[0])
    big = tuple(a for a in axis_names if mesh[a].size() > 1)
    if len(big) <= 1:           # the others add nothing to the sum
        return mesh.get_group(big[0] if big else axis_names[0])
    return mesh[big]._flatten().get_group()


def subject_shard(mesh, axis_names: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, the count) of the contiguous subject chunks over
    ``mesh``'s ``axis_names``: the dimensions in order, row-major, as the
    reference's ``shard_map`` splits the bucket axis."""
    index, count = 0, 1
    for a in axis_names:
        n = mesh[a].size()
        index = index * n + mesh.get_local_rank(a)
        count *= n
    return index, count


@contextlib.contextmanager
def subject_collectives(axis_names: Sequence[str], mesh=None):
    """Mark the enclosed code as running on one rank's subjects:
    :func:`psum_subjects` becomes an ``all_reduce(SUM)`` over ``mesh``'s
    ``axis_names`` dimensions (``mesh``: by default the current one).
    :func:`shard` stays the identity. The mesh engine
    (:mod:`repro_torch.core.engine`) enters this around every ALS
    iteration."""
    mesh = mesh if mesh is not None else current_mesh()
    if axis_names and mesh is None:
        raise ValueError("subject_collectives needs a DeviceMesh: pass mesh= or "
                         "install one with axis_rules")
    _CTX.collective.append((tuple(axis_names), mesh))
    _CTX.stack.append((None, None))
    try:
        yield
    finally:
        _CTX.stack.pop()
        _CTX.collective.pop()


def psum_subjects(x: torch.Tensor) -> torch.Tensor:
    """The cross-subject reduction hook: the identity outside
    :func:`subject_collectives`; inside, ``x`` summed over the subject
    dimensions' ranks (a new tensor; every rank gets the same bits). The
    ALS step calls it on every sum over subjects (MTTKRP partial sums, W
    Grams of the bucketed layout, the fit's residual terms). On CUDA the
    all-reduce is issued on the current stream, so a CUDA graph captures
    it; even a world of one issues it."""
    if not _CTX.collective:
        return x
    axes, mesh = _CTX.collective[-1]
    if not axes:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=subject_group(mesh, axes))
    COLLECTIVES.add(y)
    return y


def shard(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate ``x``'s logical axes: the identity (each rank already holds
    its own subjects; nothing is resharded behind the caller's back)."""
    return x
