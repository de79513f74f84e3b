"""Quickest proof that the PyTorch/CUDA port builds and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); exits non-zero without them.
Imports only the port (``src/repro_torch``), never JAX or the JAX package.
Phases, any failure exits non-zero:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   kernel build from ``src/repro_torch/csrc``;
2. each of the four kernels against its plain torch version on the card, in
   f32 and f64, over five small geometries (the reference's four and one at
   rank 40, the reference's widest cell), an empty (K=0) bucket and padded
   subjects: f64 to 1e-12 absolute, f32 to 1e-6 relative plus 1e-6 of the
   output's largest magnitude (sums in another order differ by a rounding);
3. the main path: ``choa_like(scale=0.25)``, rank 5, 20 iterations, f32,
   ``backend="auto"``, through ``repro_torch.launch.decompose``'s functions
   (after two warm-up iterations of each route);
   each kernel must launch buckets x iterations times, and the fit history
   must be finite and within 1e-4 of the same fit through ``backend="torch"``
   on the card; then scale 0.002 in f64 through the entry point's ``main``, both
   backends, histories within 1e-8;
4. each kernel's time at the main path's largest bucket beside its bound,
   its plain version's time and one PyTorch call's time (CUDA events,
   median of 20);
5. a ``torch.profiler`` trace of one main-path ALS iteration: device time
   by kernel, host time by op, and the device's busy share of the
   unprofiled iteration time of phase 3 and of the trace's first-to-last
   kernel span (the profiler's own per-launch cost inflates the profiled
   wall time, so that is not a denominator; trace in
   ``$SMOKE_OUT/als_step_trace.json``).

Files go to ``$SMOKE_OUT`` (default ``smoke_out/``).

The last two lines are a JSON object with the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
OUT = Path(os.environ.get("SMOKE_OUT", "smoke_out"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12              # H100 SXM float64 outside the tensor cores
ITERS = 20
MAIN_SCALE = 0.25
GEOMETRIES = [
    dict(seed=0, K=13, J=37, R=5, col_align=4),
    dict(seed=1, K=9, J=200, R=8, col_align=128),
    dict(seed=2, K=7, J=21, R=1, col_align=8),
    dict(seed=3, K=11, J=50, R=6, col_align=4, subject_align=8),
    dict(seed=4, K=10, J=90, R=40, col_align=8),     # the widest template (R <= 64)
]
REPLACES = {
    "fused_procrustes_b": "src/repro/kernels/fused.py:132",
    "fused_mode1_xkv": "src/repro/kernels/fused.py:196",
    "fused_mode2_compact": "src/repro/kernels/fused.py:261",
    "fused_ykv": "src/repro/kernels/fused.py:338",
}


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def within(got, want, dtype_is_f64: bool) -> tuple:
    """(max |got - want|, ok) under the stated tolerance."""
    import torch

    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if dtype_is_f64:
        ok = bool(torch.all((got - want).abs() <= 1e-12 + 1e-12 * want.abs()))
    else:
        scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
        ok = bool(torch.all((got - want).abs() <= 1e-6 * scale + 1e-6 * want.abs()))
    return err, ok


def phase1_build():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    from repro_torch.kernels import _build, fused

    t0 = time.perf_counter()
    lib = _build.build("fused")
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s", flush=True)
    log = Path(f"{lib}.log").read_text().splitlines()
    for line in log:
        if "Used" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    fused._lib()


def kernel_args(b, H, V, W, Q):
    """The four kernels' operands for one bucket, as the fused backend
    passes them."""
    from repro_torch.kernels.common import fold_subject_mask

    Vg = b.gather_v(V)
    Wb = fold_subject_mask(W[b.subject_ids.long()], b.subject_mask)
    return {
        "fused_procrustes_b": (b.vals, Vg, Wb, H),
        "fused_mode1_xkv": (Q, b.xk_times_v(V, Vg), Wb),
        "fused_mode2_compact": (b.vals, Q, H, Wb, b.col_mask),
        "fused_ykv": (b.vals, Q, Vg),
    }


PLAIN = {
    "fused_procrustes_b": "procrustes_b_plain",
    "fused_mode1_xkv": "mode1_xkv_plain",
    "fused_mode2_compact": "mode2_compact_plain",
    "fused_ykv": "ykv_plain",
}


def check_kernels(args_by_kernel, errs: dict) -> None:
    """Each kernel on the card against its plain version on the same inputs."""
    import torch
    from repro_torch.kernels import fused

    for name, args in args_by_kernel.items():
        f64 = args[0].dtype == torch.float64
        got = getattr(fused, name)(*args)
        want = getattr(fused, PLAIN[name])(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{name}: shape {tuple(g.shape)} != plain {tuple(w.shape)}")
            err, ok = within(g, w, f64)
            if not ok:
                fail(f"{name} ({'f64' if f64 else 'f32'}, shape "
                     f"{tuple(args[0].shape)}): max |kernel - plain| = {err:.3e}")
            e, s = errs.get(name, (0.0, 0.0))
            errs[name] = (max(e, err), max(s, float(w.abs().max()) if w.numel() else 0.0))


def phase2_kernels(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import bucketize
    from repro_torch.kernels import fused
    from repro_torch.sparse import random_irregular

    errs: dict = {}
    for dtype in (torch.float32, torch.float64):
        for g in GEOMETRIES:
            data = random_irregular(n_subjects=g["K"], n_cols=g["J"], max_rows=9,
                                    avg_nnz_per_subject=18, seed=g["seed"])
            bt = bucketize(data, max_buckets=2, dtype=dtype, device=dev,
                           col_align=g["col_align"],
                           subject_align=g.get("subject_align", 1))
            rng = np.random.default_rng(g["seed"])
            R = g["R"]
            H, V, W = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                       for s in ((R, R), (g["J"], R), (g["K"], R)))
            for b in bt.buckets:
                Q = torch.tensor(rng.standard_normal((b.kb, b.i_pad, R)),
                                 dtype=dtype, device=dev)
                check_kernels(kernel_args(b, H, V, W, Q), errs)
        # an empty bucket: zeros of the right shapes and no launch
        before = dict(fused.LAUNCHES)
        z = dict(dtype=dtype, device=dev)
        outs = [*fused.fused_procrustes_b(torch.zeros((0, 8, 16), **z),
                                          torch.zeros((0, 16, 5), **z),
                                          torch.zeros((0, 5), **z), torch.eye(5, **z)),
                fused.fused_mode1_xkv(torch.zeros((0, 8, 5), **z),
                                      torch.zeros((0, 8, 5), **z), torch.zeros((0, 5), **z)),
                fused.fused_mode2_compact(torch.zeros((0, 8, 16), **z),
                                          torch.zeros((0, 8, 5), **z), torch.eye(5, **z),
                                          torch.zeros((0, 5), **z), torch.zeros((0, 16), **z)),
                fused.fused_ykv(torch.zeros((0, 8, 16), **z), torch.zeros((0, 8, 5), **z),
                                torch.zeros((0, 16, 5), **z))]
        shapes = [(0, 8, 5), (0, 8, 5), (5, 5), (0, 16, 5), (0, 5, 5)]
        if [tuple(o.shape) for o in outs] != shapes or any(o.abs().sum() for o in outs):
            fail("K=0 bucket: wrong shapes or non-zero output")
        if fused.LAUNCHES != before:
            fail("K=0 bucket launched a kernel")
    print(f"[kernels] all four match their plain versions (f32, f64; "
          f"{len(GEOMETRIES)} geometries, R in {sorted({g['R'] for g in GEOMETRIES})}, "
          f"padded subjects, K=0): "
          + json.dumps({k: v[0] for k, v in errs.items()}), flush=True)
    return errs


def phase3_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.kernels import fused
    from repro_torch.launch import decompose as dec

    t0 = time.perf_counter()
    data = dec.load_dataset("choa", MAIN_SCALE, 0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    bt, stats = dec.prepare(data, buckets=4, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    dev_bytes = sum(r["device_bytes"] for r in stats)
    print(f"[main] choa scale {MAIN_SCALE}: K={data.n_subjects} nnz={data.nnz} "
          f"buckets={[(r['i_pad'], r['c_pad'], r['n_subjects']) for r in stats]} "
          f"device bytes {dev_bytes} ({dev_bytes / 2**30:.2f} GiB); generation "
          f"{t_data:.1f}s, bucketize+upload {t_up:.1f}s", flush=True)
    del data
    kw = dict(rank=5, iters=ITERS, tol=0.0, seed=0, dtype=torch.float32, verbose=False)
    # two iterations of each route first, so that neither timed run pays for
    # the first launches (module loads, cuBLAS/cuSOLVER handles)
    for backend in ("auto", "torch"):
        dec.decompose(bt, backend=backend, **{**kw, "iters": 2})

    fused.reset_launches()                        # counts from 0 for this run
    torch.cuda.reset_peak_memory_stats()
    state, hist, secs = dec.decompose(bt, backend="auto", **kw)
    launches = dict(fused.LAUNCHES)               # read right after the run
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] auto: {len(hist)} iters, {secs / len(hist) * 1e3:.2f} ms/iter, "
          f"peak device memory {peak / 2**30:.2f} GiB, launches {launches}", flush=True)
    print(f"[main] auto fit history {json.dumps(hist)}", flush=True)
    want = len(bt.buckets) * ITERS
    for name, n in launches.items():
        if n != want:
            fail(f"{name} launched {n} times on the main path, want "
                 f"buckets x iterations = {want}")
    if len(hist) != ITERS or not np.all(np.isfinite(hist)):
        fail("main path fit history is not finite or short")

    _, hist_t, secs_t = dec.decompose(bt, backend="torch", **kw)
    diff = float(np.max(np.abs(np.asarray(hist) - np.asarray(hist_t))))
    print(f"[main] torch route: {secs_t / len(hist_t) * 1e3:.2f} ms/iter; "
          f"max |fit auto - fit torch| over {ITERS} iterations = {diff:.3e}", flush=True)
    if diff > 1e-4:
        fail(f"main path fit history differs from the torch route by {diff:.3e} > 1e-4")

    common = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters",
              str(ITERS), "--tol", "0", "--dtype", "float64", "--device", "cuda"]
    s_auto = dec.main(common + ["--backend", "auto", "--json",
                                str(OUT / "decompose_f64_auto.json")])
    s_torch = dec.main(common + ["--backend", "torch"])
    diff64 = float(np.max(np.abs(np.asarray(s_auto["fit_history"])
                                 - np.asarray(s_torch["fit_history"]))))
    print(f"[main] scale 0.002 f64: max |fit auto - fit torch| = {diff64:.3e}; "
          f"launches {s_auto['kernel_launches']}", flush=True)
    if diff64 > 1e-8:
        fail(f"f64 fit histories differ by {diff64:.3e} > 1e-8")
    if any(v != len(s_auto["buckets"]) * ITERS for v in s_auto["kernel_launches"].values()):
        fail("f64 run did not launch every kernel buckets x iterations times")
    return bt, state, launches, secs / len(hist) * 1e3


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def work(name: str, K: int, I: int, C: int, R: int, itemsize: int) -> tuple:
    """(bytes, operations) the function needs: each input read once, each
    output written once; the slab is dense over the padded kept columns."""
    slab, ir, cr, kr, rr = K * I * C, K * I * R, K * C * R, K * R, R * R
    if name == "fused_procrustes_b":
        return (slab + cr + kr + rr + 2 * ir) * itemsize, 2 * slab * R + ir * (2 * R + 1)
    if name == "fused_mode1_xkv":
        return (2 * ir + kr + rr) * itemsize, 2 * ir * R + 2 * K * rr
    if name == "fused_mode2_compact":
        return (slab + ir + rr + kr + K * C + cr) * itemsize, 2 * slab * R + cr * (2 * R + 2)
    return (slab + ir + cr + K * rr) * itemsize, 2 * slab * R + 2 * ir * R


def phase4_times(bt, state, launches, errs):
    import torch
    from repro_torch.core.procrustes import solve_q
    from repro_torch.kernels import fused

    b = max(bt.buckets, key=lambda x: x.vals.numel())
    H, V, W = state.H.contiguous(), state.V, state.W
    Vg = b.gather_v(V)
    Wb = W[b.subject_ids.long()] * b.subject_mask[:, None]
    XkV, B = fused.fused_procrustes_b(b.vals, Vg, Wb, H)
    Q = solve_q(B) * b.subject_mask[:, None, None]
    args = kernel_args(b, H, V, W, Q)
    check_kernels(args, errs)                     # at the main path's shapes too
    library = {
        # one PyTorch call for each function; the port never calls them
        "fused_procrustes_b": lambda: torch.bmm(b.vals, Vg),     # X_k Vg_k only
        "fused_mode1_xkv": lambda: torch.einsum("kir,kil,kl->rl", Q, XkV, Wb),
        "fused_mode2_compact": lambda: torch.einsum(
            "kic,kir,rl,kl,kc->kcl", b.vals, Q, H, Wb, b.col_mask),
        "fused_ykv": lambda: torch.einsum("kir,kic,kcl->krl", Q, b.vals, Vg),
    }
    K, I, C = b.vals.shape
    R = H.shape[0]
    rows = []
    for name, a in args.items():
        nbytes, ops = work(name, K, I, C, R, b.vals.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (F64_FLOPS if b.vals.dtype == torch.float64 else F32_FLOPS) * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fused.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0],
            "max_abs_plain": errs[name][1],      # the scale max_abs_err reads against
            "ms": time_ms(lambda: getattr(fused, name)(*a)),
            "plain_ms": time_ms(lambda: getattr(fused, PLAIN[name])(*a)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(library[name]),
        })
        r = rows[-1]
        print(f"[time] {name} at K={K} I={I} C={C} R={R} f32: kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes} B), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms", flush=True)
    return rows


def phase5_profile(bt, iter_ms: float) -> None:
    """Where one main-path iteration's time goes; ``iter_ms`` is the
    unprofiled auto-route time per iteration from phase 3."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Parafac2Options, als_step, init_state

    opts = Parafac2Options(rank=5, backend="auto")
    state = als_step(bt, init_state(bt, opts, seed=0), opts)       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = als_step(bt, state, opts)
        float(state.fit)                       # the host loop's one sync
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(OUT / "als_step_trace.json"))
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device kernels only: an aten op also reports the time of the kernels
    # it launched, which would count them twice
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    runs = [e.time_range for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not runs or busy_ms <= 0:
        fail("the profiled main-path iteration ran nothing on the device")
    span_ms = (max(r.end for r in runs) - min(r.start for r in runs)) / 1e3
    print(f"[profile] one auto iteration: device busy {busy_ms:.3f} ms; against the "
          f"unprofiled {iter_ms:.3f} ms/iter of phase 3: busy {busy_ms / iter_ms:.1%}, "
          f"idle {1 - busy_ms / iter_ms:.1%}; against the trace's first-to-last "
          f"kernel span {span_ms:.3f} ms: busy {busy_ms / span_ms:.1%}; profiled wall "
          f"{wall_ms:.3f} ms (inflated by the profiler, not a denominator)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"[profile] device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]:
        print(f"[profile] host   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on a GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's sources are not at {SRC}: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase1_build()
    errs = phase2_kernels(dev)
    bt, state, launches, iter_ms = phase3_main_path(dev)
    rows = phase4_times(bt, state, launches, errs)
    phase5_profile(bt, iter_ms)
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
