"""Does one ``torch.profiler`` session change what later sessions see of the
port's own kernels?

  PYTHONPATH=src python -m repro_torch.launch.profiler_order      # on the GPU

Each order runs in a fresh child process, so no order inherits another's
profiler or CUPTI state:

- ``control``: P1 (``gram_inv_sqrt``, ``csrc/polar.cu``) profiled
  ``--sessions`` times, nothing profiled before it;
- ``lm-before-load``: one full-width qwen3-0.6b decode step profiled before
  ``polar.cu``'s library is loaded, then P1 profiled ``--sessions`` times;
- ``lm-after-load``: P1 launched once unprofiled (library loaded), then the
  decode step profiled, then P1 profiled;
- ``matmul-before-load``: one ``torch.mm`` profiled before the load, then P1
  profiled, to tell a session before the load from the LM's session.

For every P1 session the child prints the wrapper's launch count and the
device kernels of ``jacobi_*`` that the profiler recorded; a session that
counts launches the profiler did not see is a profiler miss, not a kernel
that did not run (the output is checked against the plain version each
time). Prints one JSON line an order, then a summary JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

ORDERS = ("control", "lm-before-load", "lm-after-load", "matmul-before-load")


def _profiled(fn):
    """(the device kernels a profiled call of ``fn`` recorded, its result)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")], out


def _lm_step():
    """One eager full-width qwen3-0.6b decode step (bf16, batch 4), profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build

    dev = torch.device("cuda")
    bundle = build(get_config("qwen3-0.6b"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init_params(gen, device=dev)
    cache = bundle.init_cache(4, 8, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        bundle.decode_step(params, cache, tok, 0)              # warm-up
        names, _ = _profiled(lambda: bundle.decode_step(params, cache, tok, 1))
    return len(names)


def _p1_session(G):
    import torch
    from repro_torch.kernels import polar

    polar.LIB.reset_launches()
    names, out = _profiled(lambda: polar.gram_inv_sqrt(G))
    err = float((out - polar.gram_inv_sqrt_plain(G)).abs().max() / out.abs().max())
    return {"launches": polar.LIB.launches["gram_inv_sqrt"],
            "seen": sum("jacobi_" in n for n in names), "kernels": len(names),
            "rel_err": err, "finite": bool(torch.isfinite(out).all())}


def child(order: str, sessions: int) -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((8192, 10, 10), generator=g, device=dev)
    G = A @ A.transpose(1, 2) + 0.1 * torch.eye(10, device=dev)
    rec = {"order": order}
    if order == "lm-before-load":
        rec["lm_kernels"] = _lm_step()
    elif order == "matmul-before-load":
        rec["mm_kernels"] = len(_profiled(lambda: A[0] @ A[1])[0])
    from repro_torch.kernels import polar

    polar.LIB.lib()
    if order == "lm-after-load":
        polar.gram_inv_sqrt(G)
        torch.cuda.synchronize()
        rec["lm_kernels"] = _lm_step()
    rec["p1"] = [_p1_session(G) for _ in range(sessions)]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", choices=ORDERS, help="run one order in this process")
    ap.add_argument("--sessions", type=int, default=3)
    args = ap.parse_args(argv)
    if args.order:
        print(json.dumps(child(args.order, args.sessions)), flush=True)
        return 0
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build("polar")
    print(f"[build] polar in {time.perf_counter() - t0:.1f}s", flush=True)
    summary = {}
    for order in ORDERS:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.profiler_order",
                               "--order", order, "--sessions", str(args.sessions)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            summary[order] = "failed"
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        summary[order] = [f"{s['seen']}/{s['launches']}" for s in rec["p1"]]
    print(json.dumps({"p1_seen_of_launched": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
