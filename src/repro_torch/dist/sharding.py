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
automatically, and :func:`shard` is the identity (the reference's
``shard`` is a no-op without a mesh and inside ``shard_map``, the only
places this package runs it).

The LM half serves the testbed's models (:mod:`repro_torch.models`):
:func:`logical_spec` resolves logical names under the installed rules,
:func:`enforce_divisible` replicates what a mesh dimension does not divide,
and :func:`param_spec` gives a parameter's layout from its path, each as a
plain tuple of mesh dimension names (or ``None``s) where the reference
returns a ``PartitionSpec``. :func:`param_shardings` maps a whole
parameter (or optimizer-state) tree onto a ``DeviceMesh``: each leaf's
spec and the ``torch.distributed.tensor`` placements with which
``distribute_tensor`` lays it out. The port's LM itself runs replicated
on every rank; the manual expert-parallel MoE
(:mod:`repro_torch.models.moe`) cuts its tensors with the autograd
collectives of :mod:`repro_torch.dist.collectives`. The reference's
``barrier`` (an ``optimization_barrier`` pinning XLA's order) and
``unroll_loops`` (a flag for XLA's cost analysis) have no counterpart:
eager torch runs ops in program order and the port's loops are Python
loops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "LM_RULES", "SP_RULES", "ParamSharding", "Rules", "axis_group",
           "axis_rules", "current_mesh", "current_rules", "enforce_divisible",
           "logical_spec", "param_shardings", "param_spec", "psum_subjects", "shard",
           "subject_collectives", "subject_mesh_axes", "subject_shard"]

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


def axis_group(mesh, axis_names: Sequence[str]):
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
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=axis_group(mesh, axes))
    COLLECTIVES.add(y)
    return y


def shard(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Annotate ``x``'s logical axes: the identity (each rank already holds
    its own subjects; nothing is resharded behind the caller's back)."""
    return x


# ---------------------------------------------------------------------------
# the LM half: logical -> mesh resolution and path-based parameter layouts
# ---------------------------------------------------------------------------

Spec = Tuple[Union[str, Tuple[str, ...], None], ...]


def _dim_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _mesh_axis_size(mesh, names: Sequence[str]) -> int:
    dims, n = _dim_names(mesh), 1
    for nm in names:
        if nm in dims:
            n *= mesh.shape[dims.index(nm)]
    return n


def _resolve_entry(entry, mesh):
    """Rule value -> spec entry: mesh dimensions ``mesh`` lacks dropped,
    a 1-tuple collapsed to its name, nothing left to None."""
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    if mesh is not None:
        names = tuple(n for n in names if n in _dim_names(mesh))
    if not names:
        return None
    return names if len(names) > 1 else names[0]


def logical_spec(axes: Sequence[Optional[str]], mesh=None) -> Spec:
    """Logical axis names -> a spec under the installed rules: unknown
    names and names with no dimension on ``mesh`` resolve to None; with no
    rules installed the spec is empty (replicated)."""
    rules = current_rules()
    if rules is None:
        return ()
    mesh = mesh if mesh is not None else current_mesh()
    return tuple(_resolve_entry(rules.get(ax), mesh) if ax is not None else None
                 for ax in axes)


def enforce_divisible(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """Replicate each dimension whose mesh size does not divide it evenly
    (the layouts are hints, never requirements)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        size = _mesh_axis_size(mesh, names)
        out.append(entry if size <= 1 or dim % size == 0 else None)
    return tuple(out)


# weights contracted on their LAST dim at apply time: output dim on "model"
# (column-parallel), input dim on the fsdp axis.
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "w_gate", "w_up",
    "in_proj_z", "in_proj_x", "in_proj_B", "in_proj_C", "in_proj_dt",
    "w_in", "w_gate_branch", "wa", "wx",
    "lm_head", "patch_proj",
})
# weights whose FIRST dim is the model-sharded activation dim (row-parallel)
_ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj", "w_out"})


def param_spec(path: str, ndim: int, stacked: bool = False) -> Spec:
    """A parameter's (or optimizer moment's) layout from its "/"-joined
    tree path, as the reference's ``param_spec``: ``stacked`` marks the
    groups' leading layer axis (never sharded)."""
    lead: Tuple[Optional[str], ...] = (None,) if stacked else ()
    body = ndim - len(lead)
    leaf = path.rsplit("/", 1)[-1]
    if body <= 1:
        return ()               # scalars, biases, norm scales: replicated
    if "experts/" in path:      # [E, d, f]: experts on "model" (EP)
        return (*lead, "model", *([None] * (body - 1)))
    if "conv/" in path:         # depthwise [W, C]: channels as the activation
        return (*lead, *([None] * (body - 1)), "model")
    if "embed/tokens" in path:  # [V, d]: vocab on "model", d fsdp
        return (*lead, "model", *([None] * (body - 2)), "data")
    if leaf in _ROW_PARALLEL:
        return (*lead, "model", *([None] * (body - 2)), "data")
    if leaf in _COL_PARALLEL:
        return (*lead, "data", *([None] * (body - 2)), "model")
    return ()                   # unknown (router gates, ...): replicated


@dataclasses.dataclass(frozen=True)
class ParamSharding:
    """One leaf's layout on a mesh: ``spec``, the reference's
    ``PartitionSpec`` entries (trailing ``None``s trimmed), and
    ``placements``, one ``Shard(dim)`` or ``Replicate()`` a mesh dimension,
    for ``torch.distributed.tensor.distribute_tensor``."""
    spec: Spec
    placements: Tuple[Any, ...]


def _placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in _dim_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e is not None and name in (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of nested dicts, lists, tuples and
    NamedTuples, the nesting kept; a path segment is a dict key, a field
    name or an index (the reference's ``_key_str``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        vals = [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return vals if isinstance(tree, list) else tuple(vals)
    return fn(path, tree)


def param_shardings(tree, mesh):
    """A :class:`ParamSharding` for every leaf of a parameter or
    optimizer-state tree (tensors, meta tensors, anything with a
    ``shape``), from :func:`param_spec` on the leaf's "/"-joined path
    (``"groups/"`` in it marks a stacked leaf), resolved on ``mesh`` and
    replicated where a mesh dimension does not divide, as the reference's
    ``param_shardings``."""

    def visit(path, leaf):
        pathstr = "/".join(path)
        shape = tuple(getattr(leaf, "shape", ()) or ())
        spec = param_spec(pathstr, len(shape), stacked="groups/" in pathstr)
        spec = tuple(_resolve_entry(e, mesh) for e in spec)
        entries = list(enforce_divisible(spec, shape, mesh) if shape else spec)
        while entries and entries[-1] is None:
            entries.pop()
        return ParamSharding(tuple(entries), _placements(entries, mesh))

    return _map_with_path(visit, tree)
