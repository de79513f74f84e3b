"""PARAFAC2 decomposition entry point, the paper's workload (``repro.launch.
decompose``), on a GPU by default:

  PYTHONPATH=src python -m repro_torch.launch.decompose --dataset choa \
      --scale 0.002 --rank 5 --iters 20 [--format cc|scoo|auto] \
      [--backend auto|staged|scoo|fused|torch] [--engine host|scan|mesh] \
      [--check-every 10] [--constraint v=nonneg+l1:0.1,w=smooth:0.1] \
      [--precision f32|bf16|f16] [--compress rsvd[:r[:p[:q]]]] \
      [--device cpu] [--json out.json]

``--constraint`` sets the per-mode factor constraints in the reference's
grammar (``repro_torch.core.constraints``; a bare spec applies to V and W);
without it, the paper's (H unconstrained, V and W nonneg by HALS).
``--compress`` picks the preprocessing stage (``repro_torch.core.compress``;
``none`` by default, as the reference's): ``rsvd[:r[:p[:q]]]`` compresses
every tall bucket to randomized cores [Kb, r + p, C_pad], runs the whole ALS
on them through the chosen backend and engine, and expands exactly at the
end, printing a ``[compress]`` line. ``--engine scan`` runs chunks of
``--check-every`` iterations as CUDA graph replays on a GPU
(``--check-every 0``: the whole fit, stopping on the device), the host
engine one iteration at a time (``repro_torch.core.engine``). ``--format`` picks the
device layout: CC (the default), SCOO (sorted flat COO, planned by nnz) or
``auto`` (each bucket by its density). ``--backend auto`` sends every CC
bucket on the GPU through the four fused CUDA kernels
(``repro_torch.kernels.fused``) and SCOO buckets through the ``scoo``
route; ``--backend staged`` runs the staged kernels (``repro_torch.kernels.
ops``, the reference's ``pallas``), on SCOO buckets after the two SCOO
kernels; ``--backend scoo`` contracts SCOO buckets in plain torch. Without a
GPU it raises unless ``--device cpu`` is given. ``--precision bf16|f16``
stages the streamed operands (the slab, Vg, the projected slices)
half-width while every product accumulates in f32, as the reference's; on
a GPU the nine kernels that stream them read them at 2 bytes. The
``--json`` summary has the reference's keys (``precision`` is
``--precision``'s), plus ``dtype`` (``--dtype``), the device and each
kernel's launch count.

Fault tolerance (``repro_torch.dist.supervisor``, the scan engine only):
``--ckpt-dir`` checkpoints every ``--ckpt-every`` chunks and ``--resume``
continues from the newest one, bit for bit. ``--fail-at "1,3:5"`` injects
transient faults at chunk boundaries (a ``:times`` above ``--max-retries``
exhausts the in-place retries and forces the checkpoint-restore path);
``--nan-at`` poisons a chunk's state with NaNs, so the health sentinel
rolls back. A faulted run ends on the same factors as a faultless one, and
the retry, restore and rollback counts land in the summary's
``supervisor`` block. ``--supervise`` engages the supervisor without
faults.

``--engine mesh`` runs one process a GPU, under ``torchrun``:

  torchrun --nproc-per-node N -m repro_torch.launch.decompose --engine mesh ...

(``--device cpu``: N processes over gloo; without ``torchrun``, a world of
one). Every rank generates the data, plans the buckets nnz-balanced over
the N subject shards (``subject_align`` N; a ``[shard-balance]`` line and
the summary's ``shard_balance`` block, the reference's) and uploads only
its own shard; the supervisor's flags work as under ``scan``. Rank 0 alone
prints and writes ``--json``; ``device_bytes`` there is the sum over the
ranks, ``shard_device_bytes`` each rank's.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (Bucketed, Parafac2Options, Parafac2State,
                              bucketize, fit)
from repro_torch.core.compress import available as available_preprocess
from repro_torch.core.constraints import (available as available_constraints,
                                          constraint_summary, parse_constraint_arg)
from repro_torch.data import choa_like, movielens_like
from repro_torch.device import resolve_device
from repro_torch.dist import FaultInjector, SupervisorConfig, supervised_fit
from repro_torch.dist import sharding as dsh
from repro_torch.kernels import fused, gather_matmul, polar, scoo, staged, tridiag
from repro_torch.launch import mesh as _mesh
from repro_torch.launch.summary import resolved_options, run_summary
from repro_torch.sparse import (BucketPlan, IrregularCOO, plan_buckets, random_irregular,
                                route_formats)

__all__ = ["load_dataset", "parse_fail_spec", "plan_data", "prepare", "decompose",
           "kernel_launches", "reset_launches", "main"]

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_fail_spec(spec: str) -> dict:
    """``"1,3:5"`` -> ``{1: 1, 3: 5}``: comma-separated chunk indices, each
    with an optional ``:times`` count (how many attempts fault before the
    injected failure clears; times > --max-retries forces a restore)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            if ":" in part:
                step, times = part.split(":", 1)
                out[int(step)] = int(times)
            else:
                out[int(part)] = 1
        except ValueError:
            raise ValueError(
                f"bad fault spec {part!r} (want CHUNK or CHUNK:TIMES, "
                f"e.g. '1,3:5')") from None
    return out


def load_dataset(name: str, scale: float, seed: int) -> IrregularCOO:
    if name == "choa":
        return choa_like(scale=scale, seed=seed)
    if name == "movielens":
        return movielens_like(scale=scale, seed=seed)
    if name == "synthetic":
        return random_irregular(
            n_subjects=max(16, int(10_000 * scale)), n_cols=5_000,
            max_rows=100, avg_nnz_per_subject=500, seed=seed)
    raise ValueError(name)


def plan_data(data: IrregularCOO, *, buckets: int, format: str = "cc",
              n_shards: int = 1) -> Tuple[BucketPlan, Optional[dict]]:
    """The bucket plan (subjects sorted by nnz for "scoo" only, as the
    reference's) and, over ``n_shards > 1`` subject shards, the plan
    nnz-balanced with the summary's ``shard_balance`` block (the
    reference's: per bucket the shards' nnz, and the max/mean imbalance
    after and before); None for one shard."""
    rc, ccnt, nnzc = data.row_counts(), data.col_counts(), data.nnz_counts()
    plan = plan_buckets(rc, ccnt, max_buckets=buckets, nnz_counts=nnzc,
                        sort_by="nnz" if format == "scoo" else "area")
    if n_shards <= 1:
        return plan, None
    naive = plan.shard_imbalance(nnzc, n_shards)
    plan = plan.balance_for_shards(nnzc, n_shards)
    return plan, {"n_shards": n_shards, "shard_nnz": plan.shard_nnz(nnzc, n_shards),
                  "imbalance_max_over_mean": plan.shard_imbalance(nnzc, n_shards),
                  "imbalance_unbalanced": naive}


def prepare(data: IrregularCOO, *, buckets: int, device: torch.device,
            dtype: torch.dtype, format: str = "cc", plan: Optional[BucketPlan] = None,
            shard: Tuple[int, int] = (0, 1)) -> Tuple[Bucketed, List[dict]]:
    """Plan (``plan`` by default :func:`plan_data`'s) and upload the
    buckets in ``format`` ("cc" | "scoo" | "auto"), or with ``shard=(index,
    count)`` only that subject shard of them (``subject_align`` count);
    returns them with the per-bucket records of the summary (shape,
    members, nnz, density, format, device bytes of what was uploaded)."""
    rc, ccnt, nnzc = data.row_counts(), data.col_counts(), data.nnz_counts()
    if plan is None:
        plan = plan_data(data, buckets=buckets, format=format, n_shards=shard[1])[0]
    fmts = route_formats(plan, nnzc, format=format)
    bt = bucketize(data, dtype=dtype, device=device, plan=plan, formats=fmts,
                   subject_align=shard[1], shard=shard)
    stats = plan.stats(rc, ccnt, nnzc, formats=fmts)
    for rec, b in zip(stats, bt.buckets):
        rec["device_bytes"] = b.nbytes()
    return bt, stats


LIBRARIES = (fused, staged, scoo, gather_matmul, polar, tridiag)   # every kernel library
PAPER_CONSTRAINTS = {"v": "nonneg", "w": "nonneg"}   # the default of --constraint


def kernel_launches() -> dict:
    """Every kernel's launch count since the last reset, over the fused,
    staged, SCOO, gather-matmul, polar and tridiagonal libraries."""
    return {k: n for lib in LIBRARIES for k, n in lib.LAUNCHES.items()}


def reset_launches() -> None:
    for lib in LIBRARIES:
        lib.reset_launches()


def decompose(bt: Bucketed, *, rank: int, iters: int, tol: float, seed: int,
              backend: str, dtype: torch.dtype, verbose: bool = True,
              state: Optional[Parafac2State] = None, mode1_reuse: bool = True,
              engine: str = "host", check_every: int = 10,
              constraints: Optional[dict] = None, precision: str = "f32",
              compress: str = "none"
              ) -> Tuple[Parafac2State, List[float], float]:
    """Fit, with the kernel launch counts zeroed first; returns the state,
    the fit history and the seconds the fit took (ending in a device sync:
    every engine reads the fits back). Under ``engine="scan"`` the seconds
    include the graphs' warm-up and capture; below f32 ``precision`` they
    include the half copy of the values; with a ``compress`` spec they
    include the compression pass and the expansion. ``constraints`` is a
    per-mode spec dict, by default the paper's."""
    opts = Parafac2Options(rank=rank, constraints=constraints or PAPER_CONSTRAINTS,
                           backend=backend, dtype=dtype, mode1_reuse=mode1_reuse,
                           engine=engine, check_every=check_every, precision=precision,
                           compress=compress)
    reset_launches()
    t0 = time.perf_counter()
    state, hist = fit(bt, opts, max_iters=iters, tol=tol, seed=seed,
                      verbose=verbose, state=state)
    return state, hist, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="choa", choices=["choa", "movielens", "synthetic"])
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tol", type=float, default=1e-7,
                    help="fit-change convergence tolerance")
    ap.add_argument("--buckets", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=["torch", "scoo", "fused", "staged", "auto"],
                    help="MTTKRP backend: 'fused' runs the four fused stages "
                         "(CUDA kernels on a GPU), 'staged' the staged kernels "
                         "on the projected slices (formed by the SCOO kernels "
                         "on SCOO buckets), 'scoo' the O(nnz) plain route on "
                         "SCOO buckets, 'auto' picks 'fused' on a GPU")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16", "f16"],
                    help="compute precision for the streamed operands: bf16/f16 "
                         "stage the slab values half-width while every product "
                         "accumulates f32 (repro_torch.kernels.common)")
    ap.add_argument("--format", default="cc", choices=["cc", "scoo", "auto"],
                    help="device format: cc (dense over kept columns), scoo "
                         "(sorted flat COO, O(nnz)), or auto (per-bucket by "
                         "density)")
    ap.add_argument("--engine", default="host", choices=["host", "scan", "mesh"],
                    help="ALS execution engine: host (one iteration at a time, "
                         "the fit read every iteration), scan (chunks of "
                         "--check-every iterations, CUDA graphs on a GPU; see "
                         "repro_torch.core.engine), mesh (scan's chunks on "
                         "each rank's subject shard, a process a GPU under "
                         "torchrun, the sums all-reduced)")
    ap.add_argument("--check-every", type=int, default=10,
                    help="iterations per chunk for the scan engine (0 = the whole "
                         "fit, the stopping rule evaluated on the device)")
    ap.add_argument("--constraint", default="", metavar="SPECS",
                    help="per-mode factor constraints, e.g. "
                         "'v=nonneg+l1:0.1,w=smooth:0.1' (modes h/v/w; a bare "
                         "spec applies to v and w; registered: "
                         f"{', '.join(available_constraints())}; see "
                         "repro_torch.core.constraints). Default: the paper's "
                         "nonneg V/W.")
    ap.add_argument("--compress", default="none", metavar="SPEC",
                    help="preprocessing stage (repro_torch.core.compress): "
                         f"registered: {', '.join(available_preprocess())}. "
                         "'rsvd[:r[:p[:q]]]' compresses every tall bucket to "
                         "randomized cores (rank r, default 2*rank; "
                         "oversampling p; q power iterations), runs the core "
                         "ALS, and expands exactly at the end")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                    help="factor and accumulation dtype (float64 needs "
                         "--precision f32)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the machine-readable run summary to PATH")
    # --- fault-tolerant supervisor (repro_torch.dist.supervisor) ----------
    ap.add_argument("--supervise", action="store_true",
                    help="run the fit under the fault-tolerant supervisor "
                         "even without faults or checkpoints (scan only; a "
                         "faultless supervised run is bit for bit the bare fit)")
    ap.add_argument("--ckpt-dir", default="", metavar="DIR",
                    help="checkpoint directory: write checkpoints every "
                         "--ckpt-every chunks (repro_torch.checkpoint)")
    ap.add_argument("--ckpt-every", type=int, default=1, metavar="N",
                    help="chunks between checkpoint writes (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in --ckpt-dir "
                         "(restore-then-continue is bit for bit)")
    ap.add_argument("--fail-at", default="", metavar="SPEC",
                    help="inject transient faults at these chunk boundaries: "
                         "'1,3:5' = a blip at chunk 1, a 5-times fault at "
                         "chunk 3 (times > --max-retries forces the "
                         "checkpoint-restore path)")
    ap.add_argument("--nan-at", default="", metavar="SPEC",
                    help="poison the state with NaNs at these chunk "
                         "boundaries (same SPEC syntax as --fail-at); the "
                         "health sentinel rolls back to the last good boundary")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="in-place retries per chunk before escalating to "
                         "checkpoint-restore")
    ap.add_argument("--backoff", type=float, default=0.0,
                    help="base retry backoff seconds (exponential, "
                         "deterministic seeded jitter; repro_torch.dist.fault)")
    args = ap.parse_args(argv)

    fail_spec = parse_fail_spec(args.fail_at)
    nan_spec = parse_fail_spec(args.nan_at)
    supervise = (args.supervise or bool(args.ckpt_dir) or args.resume
                 or bool(fail_spec) or bool(nan_spec))
    if supervise and args.engine not in ("scan", "mesh"):
        raise SystemExit(
            "--supervise/--ckpt-dir/--resume/--fail-at/--nan-at need the "
            "chunked device engines: pass --engine scan or --engine mesh")
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")

    # a bad spec raises ValueError listing the registered constraints here,
    # before any data is built
    specs = parse_constraint_arg(args.constraint) if args.constraint else PAPER_CONSTRAINTS
    dtype = DTYPES[args.dtype]
    # the options' errors (an f64 dtype below f32 precision; a bad compress
    # spec, with the registered preprocessors) before any data
    opts = Parafac2Options(rank=args.rank, constraints=specs, backend=args.backend,
                           dtype=dtype, engine=args.engine, check_every=args.check_every,
                           precision=args.precision, compress=args.compress)
    owned = args.engine == "mesh" and not dist.is_initialized()
    device = resolve_device(args.device)
    shard = (0, 1)
    if args.engine == "mesh":
        # one process a GPU: this rank's device, its shard of the subjects
        device = _mesh.init_distributed(device)
        mesh = _mesh.local_mesh(device)
        shard = dsh.subject_shard(mesh, dsh.subject_mesh_axes(mesh))
    try:
        return _run(args, opts, specs, device, dtype, shard, supervise, fail_spec, nan_spec)
    finally:
        if owned:
            _mesh.shutdown()


def _run(args, opts: Parafac2Options, specs: dict, device: torch.device,
         dtype: torch.dtype, shard: Tuple[int, int], supervise: bool, fail_spec: dict,
         nan_spec: dict) -> dict:
    """``main`` after the arguments: the data, this rank's buckets, the fit
    and the summary (printed and written by rank 0 alone)."""
    lead = shard[0] == 0 and (not dist.is_initialized() or dist.get_rank() == 0)
    say = print if lead else (lambda *a, **k: None)
    say(f"[constraints] {constraint_summary(specs)}")
    t0 = time.perf_counter()
    data = load_dataset(args.dataset, args.scale, args.seed)
    say(f"[data] K={data.n_subjects} J={data.n_cols} nnz={data.nnz} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    plan, shard_balance = plan_data(data, buckets=args.buckets, format=args.format,
                                    n_shards=shard[1])
    if shard_balance is not None:
        say(f"[shard-balance] {shard[1]} shards: imbalance "
            f"{shard_balance['imbalance_unbalanced']:.3f} -> "
            f"{shard_balance['imbalance_max_over_mean']:.3f} (max/mean nnz)")
    bt, bucket_stats = prepare(data, buckets=args.buckets, device=device, dtype=dtype,
                               format=args.format, plan=plan, shard=shard)
    device_bytes = sum(rec["device_bytes"] for rec in bucket_stats)
    shard_bytes = None
    if shard[1] > 1:
        # the summary's bytes are the whole data's, as the reference's (its
        # arrays are global): the sum over the ranks, and each rank's
        shard_bytes = [None] * dist.get_world_size()
        dist.all_gather_object(shard_bytes, [rec["device_bytes"] for rec in bucket_stats])
        for i, rec in enumerate(bucket_stats):
            rec["device_bytes"] = sum(b[i] for b in shard_bytes)
        shard_bytes = [sum(b) for b in shard_bytes]
        device_bytes = sum(shard_bytes)
    say(f"[bucketize] {len(bt.buckets)} buckets ({args.format}): "
        + ", ".join(f"{r['format']}@{r['density'] * 100:.1f}% "
                    f"{r['i_pad']}x{r['c_pad']}x{r['n_subjects']}" for r in bucket_stats)
        + f"; device bytes {device_bytes / 2**20:.1f} MiB on {device}"
        + (f" ({shard[1]} shards)" if shard[1] > 1 else "")
        + f" ({time.perf_counter() - t0:.1f}s)")

    supervisor_report = None
    if supervise:
        injector = (FaultInjector(fail_spec, nan_steps=nan_spec)
                    if (fail_spec or nan_spec) else None)
        cfg = SupervisorConfig(
            max_retries=args.max_retries, backoff=args.backoff,
            jitter=0.1 if args.backoff else 0.0,
            ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
            resume=args.resume, injector=injector)
        reset_launches()
        t0 = time.perf_counter()
        state, hist, report = supervised_fit(bt, opts, max_iters=args.iters, tol=args.tol,
                                             seed=args.seed, verbose=lead, config=cfg)
        dt = time.perf_counter() - t0
        supervisor_report = report.as_dict()
        say(f"[supervisor] retries={report.retries} "
            f"restores={report.restores} rollbacks={report.rollbacks} "
            f"stragglers={len(report.stragglers)} "
            f"checkpoints={report.checkpoints_written}")
    else:
        state, hist, dt = decompose(bt, rank=args.rank, iters=args.iters, tol=args.tol,
                                    seed=args.seed, backend=args.backend, dtype=dtype,
                                    engine=args.engine, check_every=args.check_every,
                                    constraints=specs, precision=args.precision,
                                    compress=args.compress, verbose=lead)
    say(f"[fit] {len(hist)} iters in {dt:.2f}s "
        f"({dt / max(len(hist), 1):.3f}s/iter), fit={hist[-1]:.4f}")
    launches = kernel_launches()
    say(f"[kernels] launches {launches}")
    V_np = state.V.cpu().numpy()
    summary = run_summary(
        "decompose",
        resolved_options(opts, format=args.format, tol=args.tol, seed=args.seed),
        dataset=args.dataset, scale=args.scale, rank=args.rank,
        engine=args.engine, backend=args.backend, precision=args.precision,
        dtype=args.dtype, tol=args.tol, check_every=args.check_every, seed=args.seed, format=args.format,
        buckets=bucket_stats, device_bytes=device_bytes,
        constraints=constraint_summary(specs), compress=args.compress,
        v_zero_fraction=float((V_np == 0.0).mean()),
        n_subjects=data.n_subjects, n_cols=data.n_cols, nnz=data.nnz,
        fit=float(hist[-1]), fit_history=[float(f) for f in hist],
        iters=len(hist), seconds_total=dt,
        seconds_per_iter=dt / max(len(hist), 1),
        platform="gpu" if device.type == "cuda" else "cpu",
        supervisor=supervisor_report, shard_balance=shard_balance,
        shard_device_bytes=shard_bytes,
        device=str(device),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        kernel_launches=launches,
    )
    if args.json and lead:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[json] wrote {args.json}")
    return summary


if __name__ == "__main__":
    main()
