"""The planner and the pod dry-run (the counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --mesh both --parafac2

The reference lowers and compiles every (arch x shape x mesh) cell, and the
paper's PARAFAC2 cells, for the 256- and 512-chip production meshes built
from host placeholder devices, and reads XLA's memory and cost analyses.
Torch has no such compiler, so the port plans each cell from shapes alone,
on the CPU, allocating nothing (``launch.mesh.make_production_mesh`` is an
abstract mesh):

* ``argument_size_in_bytes``: the per-device bytes of every input the step
  reads (train: the parameters, the optimizer state, the batch and the
  step; prefill: the parameters and the batch; decode: the parameters, the
  cache, the tokens and ``pos``), made on the meta device and laid out by
  ``dist.sharding.param_shardings``, :func:`batch_shardings` and
  :func:`cache_shardings`, the reference's rules; ``output_size_in_bytes``
  the same for the outputs whose shardings the reference fixes;
* ``temp_size_in_bytes``, an ESTIMATE (XLA's buffer assignment has no torch
  counterpart): the peak of live op outputs over one step run on meta
  tensors at the cell's global shapes, divided by the chips;
* with ``roofline``: the flops of that run (``torch.utils.flop_counter``'s
  registry, ``FlopCounterMode``'s counts),
  its bytes, each op's operands read plus its results written (an upper
  bound, like XLA's pre-fusion bytes accessed), both divided by the chips,
  and the collective bytes a device puts into the fabric under the cell's
  shardings (:func:`lm_collectives`), scored by
  ``analysis.roofline.roofline_terms`` on the H100 row.

The step's Python loops run every layer, so the reference's unrolled 1- and
2-group probes are not needed.

A PARAFAC2 cell plans one mesh rank's share of the subjects, which is what
the port's mesh engine holds and runs on each device:
``argument_size_in_bytes`` over the reference's leaf set
(:func:`parafac2_specs`, bf16 values), ``port_argument_bytes`` over the
port's own ``Bucketed`` and state for that share (:func:`rank_share`: f32
values plus a half copy below f32, and the mode-2 scatter order), temp,
flops and bytes from one ``als_step`` of the share on meta tensors, and the
collective bytes of the mesh engine's ``psum_subjects``
(:func:`parafac2_collective_bytes`). :func:`rank_share` makes the same share
as real tensors on a device, for the card to hold the plan against.

Records keep the reference's keys, apart from ``fits_hbm_80g`` (the H100's
``hbm_bytes``, in place of the reference's TPU budget), ``plan_s`` (the cell's
seconds in place of ``lower_s`` and ``compile_s``; an LM cell's step's meta
run, which ``--jobs`` may run in another process, is ``meta_s``) and
``temp_estimate``; there is no ``generated_code_size_in_bytes`` and no
``probe_compile_s``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.comm import COLLECTIVE_KINDS
from repro_torch.analysis.roofline import (H100_SXM, calibrate_flops_convention,
                                           model_flops, roofline_terms)
from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro_torch.core import Parafac2Options, als_step, init_state, parse_preprocess_spec
from repro_torch.core.constraints import parse_constraint_arg
from repro_torch.core.irregular import Bucket, Bucketed, SparseBucket, scatter_order
from repro_torch.dist.sharding import (_ROW_PARALLEL, LM_RULES, SP_RULES, ParamSharding,
                                       _map_with_path, _placements, axis_rules,
                                       param_shardings)
from repro_torch.kernels.common import compute_cast
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build

__all__ = ["LmCell", "PARAFAC2_CELLS", "RESULTS_PATH", "batch_shardings", "cache_shardings",
           "device_bytes", "leaves_with_paths", "lm_cell", "lm_collectives",
           "load_results", "local_shape", "main", "meta_costs", "moe_all_to_all_bytes",
           "parafac2_collective_bytes", "parafac2_shardings", "parafac2_specs", "port_bytes",
           "rank_share", "run_cell", "run_jobs", "run_parafac2_cell", "save_results",
           "share_tensors"]

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "results", "dryrun_torch.json")

TEMP_ESTIMATE = "peak live op outputs of one step on meta tensors / n_chips"


# ---------------------------------------------------------------------------
# sharding builders (the reference's rules, as ParamShardings)
# ---------------------------------------------------------------------------

def _dims(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh, names) -> int:
    dims, n = _dims(mesh), 1
    for nm in names:
        if nm in dims:
            n *= mesh.shape[dims.index(nm)]
    return n


def _div(n: int, mesh, names) -> bool:
    s = _axis_size(mesh, names)
    return s > 1 and n % s == 0


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _dims(mesh))


def _sharding(spec, mesh) -> ParamSharding:
    return ParamSharding(tuple(spec), _placements(tuple(spec), mesh))


def batch_shardings(specs, mesh):
    """Each batch leaf's dim 0 over the data-parallel dimensions where they
    divide it (one dimension by its name, as a ``PartitionSpec`` keeps
    it), else replicated."""
    dp = _dp_axes(mesh)
    entry = dp if len(dp) > 1 else dp[0] if dp else None

    def visit(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if shape and _div(shape[0], mesh, dp):
            return _sharding((entry,) + (None,) * (len(shape) - 1), mesh)
        return _sharding((), mesh)

    return _map_with_path(visit, specs)


def cache_shardings(cache, mesh):
    """The decode cache's layout by path: kv caches [..., B, S, KV, hd]
    (``self``/``cross``: batch over dp, KV heads or else the sequence over
    "model"), SSM states [..., B, H, P, N], conv contexts [..., B, W, C] and
    RG-LRU states ``h`` [..., B, w]."""
    dp = _dp_axes(mesh)

    def visit(path, leaf):
        pathstr = "/".join(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts = [None] * nd

        def set_dim(d, axes):
            parts[d] = axes if len(axes) > 1 else axes[0]

        if "self" in pathstr or "cross" in pathstr:
            b_dim, s_dim, kv_dim = nd - 4, nd - 3, nd - 2
            if _div(shape[b_dim], mesh, dp):
                set_dim(b_dim, dp)
            if _div(shape[kv_dim], mesh, ("model",)):
                set_dim(kv_dim, ("model",))
            elif _div(shape[s_dim], mesh, ("model",)):
                set_dim(s_dim, ("model",))
        elif "ssm" in pathstr:
            b_dim, h_dim = nd - 4, nd - 3
            if _div(shape[b_dim], mesh, dp):
                set_dim(b_dim, dp)
            if _div(shape[h_dim], mesh, ("model",)):
                set_dim(h_dim, ("model",))
        elif "conv" in pathstr:
            b_dim, c_dim = nd - 3, nd - 1
            if _div(shape[b_dim], mesh, dp):
                set_dim(b_dim, dp)
            if _div(shape[c_dim], mesh, ("model",)):
                set_dim(c_dim, ("model",))
        elif pathstr.endswith("h") or "/h" in pathstr:
            b_dim, w_dim = nd - 2, nd - 1
            if _div(shape[b_dim], mesh, dp):
                set_dim(b_dim, dp)
            if _div(shape[w_dim], mesh, ("model",)):
                set_dim(w_dim, ("model",))
        while parts and parts[-1] is None:
            parts.pop()
        return _sharding(parts, mesh)

    return _map_with_path(visit, cache)


def leaves_with_paths(tree) -> Dict[str, Any]:
    """{"/"-joined path: leaf} of a tree of dicts, lists, tuples and
    NamedTuples (the paths ``param_shardings`` reads)."""
    out: Dict[str, Any] = {}

    def visit(path, leaf):
        out["/".join(path)] = leaf
        return leaf

    _map_with_path(visit, tree)
    return out


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """One device's block of ``shape`` under ``spec`` (an uneven dimension
    rounds up, as XLA pads a shard)."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is not None:
            out[d] = -(-out[d] // _axis_size(mesh, e if isinstance(e, tuple) else (e,)))
    return tuple(out)


def device_bytes(tree, shardings, mesh) -> int:
    """The bytes one device holds of ``tree``'s tensors under
    ``shardings``, a tree of :class:`ParamSharding` alike."""
    specs = leaves_with_paths(shardings)
    return sum(math.prod(local_shape(t.shape, specs[p].spec, mesh)) * t.element_size()
               for p, t in leaves_with_paths(tree).items() if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# one step on meta tensors: flops, bytes and the peak of live outputs
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list:
    """The tensors among ``xs`` and the lists and tuples in it (an op's
    arguments or results)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class _MetaTrace(TorchDispatchMode):
    """Counts, over the ops run under it: ``flops``, by the registry of
    ``torch.utils.flop_counter`` (``FlopCounterMode``'s counts: the
    products and convolutions); ``bytes``, every tensor operand read plus
    every result written (a view moves nothing); ``peak``, the most bytes
    held at once by the storages the ops made (each freed when its last
    reference dies, autograd's saved tensors included)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._kind: Dict[Any, Tuple[bool, bool, Optional[Callable]]] = {}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = self._kind.get(func)
        if kind is None:
            schema = func._schema
            kind = self._kind[func] = (any(r.alias_info is not None for r in schema.returns),
                                       schema.is_mutable,
                                       flop_registry.get(func._overloadpacket))
        aliased, mutable, flops = kind
        if aliased and not mutable:
            return out                      # a view: no bytes move, no storage
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        results = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        self.bytes += sum(map(_nbytes, _tensors(args) + _tensors(kwargs.values()) + results))
        if not aliased:                     # in place writes into a storage it did not make
            for t in results:
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._held:
                    self._held[key] = st.nbytes()
                    self.live += self._held[key]
                    weakref.finalize(st, self._free, key)
            self.peak = max(self.peak, self.live)
        return out


def meta_costs(step: Callable[[], Any], rules=None) -> Dict[str, Any]:
    """``flops``, ``bytes`` and ``peak`` (see :class:`_MetaTrace`) of
    ``step()``, a call on meta tensors, with ``rules`` installed (no mesh:
    the port's LM runs whole), and the ``seconds`` the run took."""
    t0 = time.perf_counter()
    with axis_rules(rules or LM_RULES), _MetaTrace() as tr:
        out = step()
        del out
    return {"flops": int(tr.flops), "bytes": tr.bytes, "peak": tr.peak,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# collectives of an LM cell, from its shardings
# ---------------------------------------------------------------------------

def moe_all_to_all_bytes(cfg, batch: int, seq: int, mesh, itemsize: int) -> int:
    """The bytes one rank puts into the two all-to-alls of one forward
    call of ``models.moe._moe_block_manual`` on ``mesh`` (0 where
    ``moe_block`` takes the auto path): its [tp, E/tp, capacity, d] send
    buffer and the results back, capacity from the rank's own tokens."""
    tp = _axis_size(mesh, ("model",))
    E, k = cfg.n_experts, cfg.experts_per_token
    if not E or tp <= 1 or E % tp or seq % tp:
        return 0
    dp = _axis_size(mesh, _dp_axes(mesh))
    b_loc = batch // dp if dp > 1 and batch % dp == 0 else batch
    t_loc = b_loc * (seq // tp)
    cap = max(8, -(-t_loc * k * int(round(cfg.capacity_factor * 4)) // (4 * E)))
    return 2 * E * cap * cfg.d_model * itemsize


def lm_collectives(cfg, shape, params, p_sh, mesh, *, sp: bool = False) -> Dict[str, int]:
    """The bytes one device puts into the fabric in one step of an LM cell,
    by collective kind: a train step's data-parallel gradient all-reduce of
    every parameter's local shard; the tensor-parallel all-reduce of the
    activation after each product whose weight "model" shards by rows
    (under ``sp`` a reduce-scatter of it and an all-gather of its shard),
    forward and, in a train step, backward; and the manual MoE's
    all-to-alls (:func:`moe_all_to_all_bytes`), forward and backward."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    dp_axes = _dp_axes(mesh)
    dp, tp = _axis_size(mesh, dp_axes), _axis_size(mesh, ("model",))
    passes = 2 if shape.kind == "train" else 1
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype), device="meta").element_size()
    B = shape.global_batch
    b_loc = B // dp if _div(B, mesh, dp_axes) else B
    seq = 1 if shape.kind == "decode" else shape.seq_len
    leaves, specs = leaves_with_paths(params), leaves_with_paths(p_sh)
    if shape.kind == "train" and dp > 1:
        out["all-reduce"] += sum(math.prod(local_shape(w.shape, specs[p].spec, mesh))
                                 * w.element_size() for p, w in leaves.items())
    for path, w in leaves.items():
        stacked = "groups/" in path
        n = w.shape[0] if stacked else 1
        if path.endswith("moe/experts/w_gate"):
            out["all-to-all"] += passes * n * moe_all_to_all_bytes(cfg, B, seq, mesh, itemsize)
        spec = specs[path].spec
        body = spec[1:] if stacked else spec
        if (tp > 1 and path.rsplit("/", 1)[-1] in _ROW_PARALLEL and "experts/" not in path
                and body and body[0] == "model"):
            if path.startswith("encoder/"):
                if shape.kind == "decode":
                    continue                 # decode reads the cached cross kv
                tokens = b_loc * cfg.encoder_seq
            else:
                tokens = b_loc * seq
            act = passes * n * tokens * w.shape[-1] * itemsize
            if sp:
                out["reduce-scatter"] += act
                out["all-gather"] += act // tp
            else:
                out["all-reduce"] += act
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    return out


# ---------------------------------------------------------------------------
# one LM cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LmCell:
    """One LM cell's step on meta tensors: its ``inputs`` by name (train:
    params, opt, batch, step; prefill: params, batch; decode: params,
    cache, tokens, pos), their ``shardings`` on the cell's mesh, the names
    of the ``outputs`` whose shardings the reference fixes, and ``step()``,
    the step on those inputs."""
    cfg: Any
    inputs: Dict[str, Any]
    shardings: Dict[str, Any]
    outputs: Tuple[str, ...]
    step: Callable[[], Any]

    def bytes(self, names, mesh) -> int:
        return sum(device_bytes(self.inputs[k], self.shardings[k], mesh) for k in names)


def _arch_config(arch: str, remat_policy: str = ""):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, remat_policy=remat_policy) if remat_policy else cfg


def lm_cell(arch: str, shape_name: str, mesh=None, *, remat_policy: str = "",
            microbatches: int = 1) -> LmCell:
    """The cell's inputs as meta tensors and their layouts on ``mesh``
    (none without one): ``param_shardings`` for the parameters and the
    optimizer state, :func:`batch_shardings` for the batch and the tokens,
    :func:`cache_shardings` for the cache, the scalars replicated."""
    cfg = _arch_config(arch, remat_policy)
    kind = SHAPES[shape_name].kind
    bundle = build(cfg, microbatches=microbatches)
    params = bundle.init_params(None, device="meta")
    specs = bundle.input_specs(shape_name)
    if kind == "train":
        inputs = {"params": params, "opt": bundle.init_opt(params), "batch": specs["batch"],
                  "step": specs["step"]}
        outputs = ("params", "opt")

        def step():
            return bundle.train_step(params, inputs["opt"], specs["batch"], specs["step"])
    elif kind == "prefill":
        inputs, outputs = {"params": params, "batch": specs["batch"]}, ()

        def step():
            return bundle.prefill_step(params, specs["batch"])
    else:
        inputs = {"params": params, "cache": specs["cache"], "tokens": specs["tokens"],
                  "pos": specs["pos"]}
        outputs = ("cache",)

        def step():
            return bundle.decode_step(params, specs["cache"], specs["tokens"], specs["pos"])
    shardings = {}
    if mesh is not None:
        rep = _sharding((), mesh)
        for name, tree in inputs.items():
            if name in ("params", "opt"):
                shardings[name] = param_shardings(tree, mesh)
            elif name == "batch":
                shardings[name] = batch_shardings(tree, mesh)
            elif name == "tokens":
                shardings[name] = batch_shardings({"t": tree}, mesh)["t"]
            elif name == "cache":
                shardings[name] = cache_shardings(tree, mesh)
            else:
                shardings[name] = rep
    return LmCell(cfg, inputs, shardings, outputs, step)


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, hw=H100_SXM, *,
             roofline: bool = True, sp: bool = False, remat_policy: str = "",
             microbatches: int = 1, step_costs: Optional[dict] = None) -> Dict[str, Any]:
    """One (arch x shape x mesh) cell. ``step_costs``, a dict the caller
    keeps, holds the step's meta run for the cell on the next mesh (the
    run is of the global step, the same on every mesh)."""
    cfg = _arch_config(arch, remat_policy)
    shape = SHAPES[shape_name]
    n_chips = mesh.size()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "sp": sp,
        "kind": shape.kind, "n_chips": n_chips,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    rec["microbatches"] = microbatches
    t0 = time.perf_counter()
    cell = lm_cell(arch, shape_name, mesh, remat_policy=remat_policy,
                   microbatches=microbatches)
    rec["argument_size_in_bytes"] = cell.bytes(cell.inputs, mesh)
    rec["output_size_in_bytes"] = cell.bytes(cell.outputs, mesh)
    key = (arch, shape_name, sp, cfg.remat_policy, microbatches)
    costs = step_costs.get(key) if step_costs is not None else None
    fresh = costs is None
    if fresh:
        costs = meta_costs(cell.step, SP_RULES if sp else LM_RULES)
        if step_costs is not None:
            step_costs[key] = costs
    rec["temp_size_in_bytes"] = costs["peak"] // n_chips
    rec["temp_estimate"] = TEMP_ESTIMATE
    rec["meta_s"] = costs["seconds"]        # the step's meta run, shared by the meshes
    rec["bytes_per_device"] = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    rec["fits_hbm_80g"] = rec["bytes_per_device"] <= hw.hbm_bytes
    if roofline:
        coll = lm_collectives(cfg, shape, cell.inputs["params"], cell.shardings["params"],
                              mesh, sp=sp)
        terms = roofline_terms({"flops": costs["flops"] / n_chips,
                                "bytes": costs["bytes"] / n_chips, "collectives": coll}, hw=hw)
        for k in ("hlo_flops", "hlo_bytes", "collective_bytes", "collective_breakdown",
                  "t_compute", "t_collective"):
            rec[k] = terms[k]
        # memory term, two bounds: the ops' bytes (an upper bound); the live
        # bytes (arguments and temporaries touched once) the lower
        rec["t_memory_hlo"] = terms["t_memory"]
        rec["t_memory"] = rec["bytes_per_device"] / hw.hbm_bw
        dominant = max(("t_compute", "t_memory", "t_collective"), key=lambda k: rec[k])
        rec["bottleneck"] = dominant
        tmax = rec[dominant]
        rec["roofline_fraction_compute"] = rec["t_compute"] / tmax if tmax > 0 else 0.0
        mf = model_flops(cfg, shape, per_device=True, n_chips=n_chips)
        rec["model_flops_per_device"] = mf
        rec["useful_fraction"] = mf / rec["hlo_flops"] if rec["hlo_flops"] else 0.0
    rec["plan_s"] = time.perf_counter() - t0 - (costs["seconds"] if fresh else 0.0)
    return rec


# ---------------------------------------------------------------------------
# PARAFAC2 cells (the paper's workload on the production mesh)
# ---------------------------------------------------------------------------

PARAFAC2_CELLS = {
    # name: (K, J, R, [(Kb_per_bucket, I_pad, C_pad, N_pad)...]): CHOA and
    # synth-500M. N_pad is the SCOO per-subject triplet pad (about 4-8
    # nonzeros an observation row, EHR-like 1-3% density within a slice);
    # CC ignores it.
    "parafac2-choa-r40": (464_900, 1_328, 40,
                          [(116_225, 32, 64, 128), (116_225, 64, 96, 256),
                           (116_225, 96, 128, 384), (116_225, 168, 256, 672)]),
    "parafac2-synth500m-r40": (1_000_000, 5_000, 40,
                               [(250_000, 48, 256, 384), (250_000, 64, 384, 512),
                                (250_000, 80, 512, 640), (250_000, 104, 640, 832)]),
}

_CC_FIELDS = ("vals", "cols", "col_mask", "subject_ids", "subject_mask", "row_counts")
_SCOO_FIELDS = ("vals", "rows", "lcols", "row_ends", "cperm", "col_ends", "cols",
                "col_mask", "subject_ids", "subject_mask", "row_counts", "nnz_counts")


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _cell_geometry(name: str, compress: str, fmt: str):
    """(K, J, R, geometry, format, Preprocess) of a cell: under a
    compression spec, the core geometry (row pads clamped to the sketch
    dimension, CC)."""
    K, J, R, geom = PARAFAC2_CELLS[name]
    pp = parse_preprocess_spec(compress)
    if not pp.identity:
        S = pp.sketch_dim(R)
        geom = [(kb, min(ip, S), cp, npad) for kb, ip, cp, npad in geom]
        fmt = "cc"
    return K, J, R, geom, fmt, pp


def parafac2_specs(K: int, J: int, R: int, geometry, dp: int,
                   opts: Optional[Parafac2Options] = None, format: str = "cc"):
    """The reference's lowered leaf set as meta tensors, ``(data, state)``:
    ``data = {"buckets": [{field: tensor}]}`` (bf16 values, the SCOO fields
    for ``format="scoo"``), each bucket's Kb rounded up to the ``dp``
    subject shards; ``state`` H, V, the bucketed W, fit and the ADMM duals
    ``opts`` routes (``aux``: h, v, a per-bucket list for w)."""
    from repro_torch.core.parafac2 import constraints_for

    def m(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16
    buckets = []
    for kb, ip, cp, npad in geometry:
        kb = _pad(kb, dp)
        common = dict(cols=m((kb, cp), i32), col_mask=m((kb, cp), f32),
                      subject_ids=m((kb,), i32), subject_mask=m((kb,), f32),
                      row_counts=m((kb,), i32))
        if format == "scoo":
            leaves = dict(vals=m((kb, npad), bf16), rows=m((kb, npad), i32),
                          lcols=m((kb, npad), i32), row_ends=m((kb, ip), i32),
                          cperm=m((kb, npad), i32), col_ends=m((kb, cp), i32),
                          nnz_counts=m((kb,), i32), **common)
            buckets.append({f: leaves[f] for f in _SCOO_FIELDS})
        else:
            leaves = dict(vals=m((kb, ip, cp), bf16), **common)
            buckets.append({f: leaves[f] for f in _CC_FIELDS})
    cons = constraints_for(opts) if opts is not None else None

    def aux_for(mode, shape):
        if cons is None or not cons[mode].admm:
            return ()
        return (m(shape, f32), m(shape, f32))       # the (Z, U) dual pair

    kbs = [b["vals"].shape[0] for b in buckets]
    aux = {"h": aux_for("h", (R, R)), "v": aux_for("v", (J, R)),
           "w": ([aux_for("w", (kb, R)) for kb in kbs]
                 if cons is not None and cons["w"].admm else ())}
    state = {"H": m((R, R), f32), "V": m((J, R), f32),
             "W": tuple(m((kb, R), f32) for kb in kbs), "fit": m((), f32), "aux": aux}
    return {"buckets": buckets}, state


def parafac2_shardings(data, state, mesh):
    """Every bucket leaf and W (and W's duals) split over EVERY mesh
    dimension (the reference's subject-wide split: the paper's workload has
    no tensor-parallel dimension); H, V, the fit and their duals
    replicated."""
    subj, rep = _sharding((_dims(mesh),), mesh), _sharding((), mesh)
    d_sh = _map_with_path(lambda path, _: subj, data)
    s_sh = _map_with_path(lambda path, _: subj if path[0] == "W" or path[:2] == ("aux", "w")
                          else rep, state)
    return d_sh, s_sh


def _share_bucket(kb: int, n_real: int, first_id: int, ip: int, cp: int, npad: int, J: int,
                  fmt: str, precision: str, dtype: torch.dtype, device: torch.device,
                  gen: Optional[torch.Generator]):
    """One bucket of a rank's share at the cell's geometry: every subject
    holds ``cp`` distinct kept columns of J (sorted) and, in CC, dense
    ``ip x cp`` values; in SCOO ``npad`` distinct cells of that rectangle,
    sorted row-major, with their segment ends and column order. Values are
    uniform in [0, 1) from ``gen``; on the meta device, shapes only."""
    def fill(t):
        return t if device.type == "meta" else t.uniform_(generator=gen)

    def empty(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    i32 = torch.int32
    cols = fill(empty((kb, J))).argsort(dim=1)[:, :cp].sort(dim=1).values.to(i32)
    col_mask = torch.ones((kb, cp), dtype=dtype, device=device)
    real = torch.arange(kb, device=device) < n_real
    subject_ids = torch.where(real, torch.arange(first_id, first_id + kb, device=device),
                              0).to(i32)
    subject_mask = real.to(dtype)
    row_counts = torch.where(real, ip, 0).to(i32)
    perm, ends = scatter_order(cols, J)      # every kept column is real
    if fmt == "scoo":
        flat = fill(empty((kb, ip * cp))).topk(npad, dim=1).indices.sort(dim=1).values
        rows, lcols = flat // cp, flat % cp
        ckey = lcols * ip + rows
        row_ends = torch.searchsorted(
            flat, ((torch.arange(ip, device=device) + 1) * cp).expand(kb, ip).contiguous())
        col_ends = torch.searchsorted(
            ckey.sort(dim=1).values,
            ((torch.arange(cp, device=device) + 1) * ip).expand(kb, cp).contiguous())
        b = SparseBucket(
            vals=fill(empty((kb, npad))), rows=rows.to(i32), lcols=lcols.to(i32),
            row_ends=row_ends.to(i32), cperm=ckey.argsort(dim=1, stable=True).to(i32),
            col_ends=col_ends.to(i32), cols=cols, col_mask=col_mask,
            subject_ids=subject_ids, subject_mask=subject_mask, row_counts=row_counts,
            nnz_counts=torch.full((kb,), npad, dtype=i32, device=device), n_rows_pad=ip,
            n_real=n_real, scatter_perm=perm, scatter_ends=ends)
    else:
        b = Bucket(vals=fill(empty((kb, ip, cp))), cols=cols, col_mask=col_mask,
                   subject_ids=subject_ids, subject_mask=subject_mask,
                   row_counts=row_counts, n_real=n_real, scatter_perm=perm,
                   scatter_ends=ends)
    if precision != "f32":
        b = dataclasses.replace(b, vals_half=compute_cast(b.vals, precision))
    return b


def rank_share(name: str, mesh, *, rank: int = 0, format: str = "cc",
               precision: str = "f32", compress: str = "none", constraint: str = "",
               dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0,
               backend: str = "auto", engine: str = "host", check_every: int = 8):
    """(data, state, opts): rank ``rank``'s share of cell ``name`` on
    ``mesh`` as the port's mesh engine holds it, a ``Bucketed`` shard (each
    bucket's padded subjects split over every mesh dimension, chunk
    ``rank``) and the initial state (``init_state``, the bucketed W), made
    on ``device`` from ``seed`` (``"meta"``: shapes only). ``format``,
    ``precision``, ``compress`` (the core geometry) and ``constraint`` as
    in :func:`run_parafac2_cell`."""
    K, J, R, geom, fmt, _ = _cell_geometry(name, compress, format)
    device = torch.device(device)
    n = mesh.size()
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    buckets = []
    for kb_real, ip, cp, npad in geom:
        kb = _pad(kb_real, n) // n
        n_real = max(0, min(kb, kb_real - rank * kb))
        buckets.append(_share_bucket(kb, n_real, rank * kb, ip, cp, npad, J, fmt, precision,
                                     dtype, device, gen))
    norm_sq = (1.0 if device.type == "meta"
               else float(sum((b.vals.double() ** 2).sum() for b in buckets)))
    data = Bucketed(buckets=buckets, n_subjects=K, n_cols=J, norm_sq=norm_sq,
                    shard=(rank, n))
    specs = (parse_constraint_arg(constraint) if constraint
             else {"v": "nonneg", "w": "nonneg"})
    opts = Parafac2Options(rank=R, constraints=specs, w_layout="bucketed", backend=backend,
                           precision=precision, dtype=dtype, engine=engine,
                           check_every=check_every)
    return data, init_state(data, opts, seed=seed), opts


def share_tensors(data: Bucketed, state) -> list:
    """Every tensor of the port's share and state: each bucket's fields
    (its half copy of the values too) and the state's leaves."""
    out = [getattr(b, f.name) for b in data.buckets for f in dataclasses.fields(b)]
    tree = {"H": state.H, "V": state.V, "W": state.W, "fit": state.fit, "aux": state.aux}
    out += list(leaves_with_paths(tree).values())
    return [t for t in out if isinstance(t, torch.Tensor)]


def port_bytes(data: Bucketed, state) -> int:
    """The device bytes the port's share and state hold."""
    return sum(map(_nbytes, share_tensors(data, state)))


def parafac2_collective_bytes(opts: Parafac2Options, J: int, K: int) -> Dict[str, int]:
    """The bytes one rank puts into the mesh engine's all-reduces
    (``psum_subjects``) in one ALS iteration, by kind: M1 (R x R), M2
    (J x R), the fit's residual (a scalar) and, with the bucketed W, its Gram
    twice (R x R), else M3 (K x R), in ``opts.dtype``."""
    R = opts.rank
    n = R * R + J * R + 1 + (2 * R * R if opts.w_layout == "bucketed" else K * R)
    out = {k: 0 for k in COLLECTIVE_KINDS}
    out["all-reduce"] = n * torch.empty((), dtype=opts.dtype, device="meta").element_size()
    out["total"] = out["all-reduce"]
    return out


def run_parafac2_cell(name: str, mesh, mesh_name: str, hw=H100_SXM,
                      backend: str = "torch", engine: str = "host",
                      check_every: int = 8, constraint: str = "",
                      format: str = "cc", compress: str = "none",
                      precision: str = "f32") -> Dict[str, Any]:
    """Plan one PARAFAC2 cell: what one device holds and does in one ALS
    iteration of rank 0's share (the engines run the same iteration: one
    ``als_step`` on ``host``, a chunk of ``check_every`` of them under
    ``scan`` and ``mesh``). ``format`` "cc" or "scoo"; ``constraint`` the
    driver's spec syntax ("v=nonneg_admm,w=nonneg_admm" carries the ADMM
    duals in the state); ``compress`` an rsvd spec plans the core geometry
    (row pads clamped to the sketch dimension S = r + p, CC); the meta run
    takes ``backend``'s plain version."""
    K, J, R, geom, format, pp = _cell_geometry(name, compress, format)
    n_chips = mesh.size()
    rec: Dict[str, Any] = {
        "arch": name + ("+scoo" if format == "scoo" else "") + ("+rsvd" if not pp.identity else ""),
        "shape": "als_step", "mesh": mesh_name, "kind": "parafac2", "n_chips": n_chips,
        "params": 0, "active_params": 0, "backend": backend, "engine": engine,
        "format": format, "compress": pp.spec, "precision": precision}
    specs = (parse_constraint_arg(constraint) if constraint
             else {"v": "nonneg", "w": "nonneg"})
    rec["constraints"] = dict(specs)
    if engine in ("scan", "mesh"):
        rec["check_every"] = check_every
    elif engine != "host":
        raise ValueError(engine)
    t0 = time.perf_counter()
    share, state, opts = rank_share(name, mesh, format=format, precision=precision,
                                    compress=compress, constraint=constraint, device="meta",
                                    backend=backend, engine=engine, check_every=check_every)
    data, spec_state = parafac2_specs(K, J, R, geom, n_chips, opts, format=format)
    d_sh, s_sh = parafac2_shardings(data, spec_state, mesh)
    state_b = device_bytes(spec_state, s_sh, mesh)
    rec["argument_size_in_bytes"] = device_bytes(data, d_sh, mesh) + state_b
    rec["output_size_in_bytes"] = state_b + (4 * check_every if engine != "host" else 0)
    rec["port_argument_bytes"] = port_bytes(share, state)
    costs = meta_costs(lambda: als_step(share, state, opts))
    rec["temp_size_in_bytes"] = costs["peak"]
    rec["temp_estimate"] = "peak live op outputs of one als_step of the share on meta tensors"
    rec["bytes_per_device"] = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    # the budget holds for the reference's layout and for the port's own
    rec["fits_hbm_80g"] = (max(rec["bytes_per_device"],
                               rec["port_argument_bytes"] + rec["temp_size_in_bytes"])
                           <= hw.hbm_bytes)
    terms = roofline_terms({"flops": costs["flops"], "bytes": costs["bytes"],
                            "collectives": parafac2_collective_bytes(opts, J, K)}, hw=hw)
    rec.update(terms)
    rec["t_memory_hlo"] = terms["t_memory"]
    rec["t_memory"] = rec["bytes_per_device"] / hw.hbm_bw
    rec["arithmetic_intensity"] = (terms["hlo_flops"] / terms["hlo_bytes"]
                                   if terms["hlo_bytes"] else 0.0)
    rec["bottleneck"] = max(("t_compute", "t_memory", "t_collective"), key=lambda k: rec[k])
    # useful work: the SPARTan flop count (Procrustes, the three MTTKRPs
    # and the Grams). CC pays the densified rectangle; SCOO counts only
    # the padded triplets
    if format == "scoo":
        cells = sum(kb * npad for kb, ip, cp, npad in geom)
        rec["padded_nnz"] = int(cells)
    else:
        cells = sum(kb * ip * cp for kb, ip, cp, npad in geom)
    useful = (6.0 * cells * R + 10.0 * K * R * R) / n_chips
    rec["model_flops_per_device"] = useful
    rec["useful_fraction"] = useful / terms["hlo_flops"] if terms["hlo_flops"] else 0.0
    # the model's streamed slab bytes an iteration at the reference's bf16
    # values: the staged route reads the slab twice and round-trips the
    # compact Yc three more times at the compute precision; the fused route
    # reads the slab three times and never writes Yc
    if format != "scoo":
        val_b = 2
        slab_b = 2 if precision in ("bf16", "f16") else 4
        yc_cells = sum(kb * R * cp for kb, ip, cp, npad in geom)
        if backend == "fused":
            streamed = 3.0 * cells * val_b
        else:
            streamed = 2.0 * cells * val_b + 3.0 * yc_cells * slab_b
        rec["model_streamed_bytes_per_device"] = streamed / n_chips
        rec["model_arithmetic_intensity"] = useful / (streamed / n_chips) if streamed else 0.0
    rec["plan_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# sweep driver with a JSON result cache
# ---------------------------------------------------------------------------

def _production(mesh_name: str):
    return make_production_mesh(multi_pod=mesh_name == "pods2x16x16")


def _lm_job(job) -> list:
    """[(key, record or None, traceback or None)] of one (arch x shape) on
    each of its meshes (the roofline on the single pod's, unless ``kw``
    says); the cells share the step's meta run."""
    arch, shape_name, cells, kw = job
    costs: Dict[tuple, Dict[str, Any]] = {}
    out = []
    for mesh_name, key in cells:
        try:
            out.append((key, run_cell(arch, shape_name, _production(mesh_name), mesh_name,
                                      step_costs=costs,
                                      **{"roofline": mesh_name == "pod16x16", **kw}), None))
        except Exception:  # a failing cell is a bug to fix: reported, the sweep goes on
            out.append((key, None, traceback.format_exc()))
    return out


def _parafac2_job(job) -> list:
    cell, mesh_name, key, kw = job
    try:
        return [(key, run_parafac2_cell(cell, _production(mesh_name), mesh_name, **kw), None)]
    except Exception:
        return [(key, None, traceback.format_exc())]


def _job(job) -> list:
    return (_lm_job if job[0] == "lm" else _parafac2_job)(job[1])


def run_jobs(jobs: list, n: int):
    """Each job's records, in order: in this process, or over ``n``
    spawned processes of one thread each (a cell's meta run takes seconds
    through Python meta kernels, and the cells are independent)."""
    if n <= 1:
        yield from map(_job, jobs)
        return
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(n, mp_context=ctx,
                                                initializer=torch.set_num_threads,
                                                initargs=(1,)) as pool:
        yield from pool.map(_job, jobs)


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, default=float)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.normpath(RESULTS_PATH))
    ap.add_argument("--parafac2", action="store_true", help="also plan the paper-workload cells")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "scoo", "fused", "staged", "auto"],
                    help="MTTKRP backend of the PARAFAC2 cells (the plan runs its "
                         "plain version on meta tensors)")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16", "f16"],
                    help="compute precision of the PARAFAC2 cells: bf16/f16 add the "
                         "half copy of the values and halve the streamed Yc bytes")
    ap.add_argument("--format", default="cc", choices=["cc", "scoo"],
                    help="device data format of the PARAFAC2 cells: cc (densified "
                         "rectangles) or scoo (flat COO; N_pad from PARAFAC2_CELLS)")
    ap.add_argument("--engine", default="host", choices=["host", "scan", "mesh"],
                    help="ALS engine of the PARAFAC2 cells (see repro_torch.core.engine)")
    ap.add_argument("--check-every", type=int, default=8,
                    help="scan-chunk length for --engine scan/mesh")
    ap.add_argument("--compress", default="none",
                    help="preprocessing spec of the PARAFAC2 cells (e.g. 'rsvd:80:8:1'): "
                         "plans the compressed core geometry")
    ap.add_argument("--constraint", default="",
                    help="constraint spec of the PARAFAC2 cells (e.g. "
                         "'v=nonneg_admm,w=nonneg_admm'); empty = nonneg V and W. The "
                         "sweep ALWAYS also plans one AO-ADMM-constrained cell a mesh.")
    ap.add_argument("--sp", action="store_true", help="sequence-parallel residual stream")
    ap.add_argument("--remat-policy", default="", help="override cfg.remat_policy")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation (train cells)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes that plan cells at once (one thread each)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod16x16", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("pods2x16x16", make_production_mesh(multi_pod=True)))

    results = load_results(args.out)
    from repro_torch.launch.summary import run_summary
    meta = results.setdefault("_meta", {})
    meta["flops_convention"] = calibrate_flops_convention(meshes[0][1])
    meta.update(run_summary("dryrun", None))

    lm_kw = dict(sp=args.sp, remat_policy=args.remat_policy, microbatches=args.microbatches)
    suffix = (("+sp" if args.sp else "")
              + (f"+{args.remat_policy}" if args.remat_policy else "")
              + (f"+mb{args.microbatches}" if args.microbatches > 1 else ""))
    jobs = []
    for arch in archs:
        for shape_name in (applicable_shapes(get_config(arch)) if args.shape == "all"
                           else [args.shape]):
            cells = [(mesh_name, f"{arch}|{shape_name}|{mesh_name}{suffix}")
                     for mesh_name, _ in meshes]
            cells = [(m, k) for m, k in cells if k not in results or args.force]
            if cells:
                jobs.append(("lm", (arch, shape_name, cells, lm_kw)))
    # the long meta runs first, so that no train step starts last
    order = {"train": 0, "prefill": 1}
    jobs.sort(key=lambda j: order.get(SHAPES[j[1][1]].kind, 2))
    if args.parafac2:
        # every cell with the requested constraint, plus one
        # AO-ADMM-constrained cell a mesh (the carried duals)
        admm_spec = "v=nonneg_admm,w=nonneg_admm"
        cells = [(cell, args.constraint, "") for cell in PARAFAC2_CELLS]
        if args.constraint != admm_spec:
            cells.append((next(iter(PARAFAC2_CELLS)), admm_spec, "+admm"))
        for mesh_name, _ in meshes:
            for cell, cons, tag in cells:
                key = (f"{cell}|als_step|{mesh_name}"
                       + (f"+{args.format}" if args.format != "cc" else "")
                       + (f"+{args.backend}" if args.backend != "torch" else "")
                       + (f"+{args.precision}" if args.precision != "f32" else "")
                       + (f"+{args.engine}" if args.engine != "host" else "")
                       + (f"+[{cons}]" if cons else "")
                       + (f"+[{args.compress}]" if args.compress != "none" else "")
                       + tag)
                if key not in results or args.force:
                    jobs.append(("parafac2", (cell, mesh_name, key, dict(
                        backend=args.backend, engine=args.engine,
                        check_every=args.check_every, constraint=cons, format=args.format,
                        compress=args.compress, precision=args.precision))))

    failures = []
    for done in run_jobs(jobs, args.jobs):
        for key, rec, err in done:
            if rec is None:
                failures.append((key, err.strip().splitlines()[-1]))
                print(f"[dryrun] {key}: FAIL {failures[-1][1]}", flush=True)
                if not args.quiet:
                    print(err, flush=True)
                continue
            results[key] = rec
            if rec["kind"] == "parafac2":
                detail = (f"bytes/dev={rec['bytes_per_device']/2**30:.3f}GiB "
                          f"port={rec['port_argument_bytes']/2**20:.1f}MiB "
                          f"bottleneck={rec['bottleneck']} (planned in {rec['plan_s']:.2f}s)")
            else:
                detail = (f"t_comp={rec['t_compute']*1e3:.2f}ms "
                          f"t_mem={rec['t_memory']*1e3:.2f}ms "
                          f"t_coll={rec['t_collective']*1e3:.2f}ms "
                          f"bottleneck={rec['bottleneck']} " if "t_compute" in rec else "")
                detail += (f"bytes/dev={rec['bytes_per_device']/2**30:.2f}GiB (temp "
                           f"estimated; planned in {rec['plan_s']:.2f}s, the step's meta run "
                           f"{rec['meta_s']:.2f}s)")
            print(f"[dryrun] {key}: OK {detail}", flush=True)
        save_results(args.out, results)

    n_ok = len([k for k in results if not k.startswith("_")])
    seconds: Dict[str, float] = {}
    for mesh_name, _ in meshes:
        for rec in results.values():
            if isinstance(rec, dict) and rec.get("mesh") == mesh_name and "plan_s" in rec:
                first = mesh_name == meshes[0][0]      # a meta run counts once
                seconds[rec["kind"]] = (seconds.get(rec["kind"], 0.0) + rec["plan_s"]
                                        + (rec.get("meta_s", 0.0) if first else 0.0))
    print(f"[dryrun] seconds by family (cells planned, meta runs in any process): "
          f"{ {k: round(v, 1) for k, v in sorted(seconds.items())} }")
    print(f"[dryrun] done: {n_ok} cells recorded, {len(failures)} failures")
    for k, e in failures:
        print(f"  FAIL {k}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
