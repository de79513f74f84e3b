"""Time the mesh engine on the ranks of a ``torchrun`` world:

  PYTHONPATH=src torchrun --standalone --nproc-per-node N -m repro_torch.launch.mesh_time \
      [--scale 0.25] [--rank 5] [--iters 20] [--format cc|scoo] [--backend auto|staged] \
      [--check-every 10] [--device cuda|cpu] [--json out.json]

(without ``torchrun``: a world of one; ``--device cpu``: the ranks over
gloo, a rehearsal whose times are the CPU's). Every rank generates
``choa_like(scale)``, plans it nnz-balanced over the world and uploads its
own shard (``bucketize(shard=...)``), then fits ``--iters`` iterations
twice through the mesh engine: the first fit pays the warm-up, the NCCL
communicators and the capture, the second replays the kept chunk. In a
world of one it also fits the whole data twice through the scan engine,
the same way, for comparison. Times are host clocks around each fit,
which ends in a device sync; a world's time is its slowest rank's. Rank 0
prints one JSON line: the world size, the card's name, each fit's ms/iter
and history, the bytes each rank's buckets hold and the bytes all-reduced
an iteration.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
import torch.distributed as dist

from repro_torch.analysis.comm import record_collectives
from repro_torch.core import Parafac2Options, engine, fit
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as dsh
from repro_torch.launch import decompose as dec
from repro_torch.launch import mesh as lm

__all__ = ["main"]


def _timed(bt, opts, iters: int, group) -> tuple:
    """(ms per iteration of one fit, the slowest rank's; its history)."""
    cuda = bt.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = fit(bt, opts, max_iters=iters, tol=0.0, seed=0)
    if cuda:
        torch.cuda.synchronize()
    ms = torch.tensor([(time.perf_counter() - t0) / iters * 1e3], device=bt.device)
    dist.all_reduce(ms, op=dist.ReduceOp.MAX, group=group)
    return float(ms), hist


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--format", default="cc", choices=["cc", "scoo"])
    ap.add_argument("--backend", default="auto", choices=["auto", "staged"])
    ap.add_argument("--check-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="", metavar="PATH")
    args = ap.parse_args(argv)
    device = lm.init_distributed(resolve_device(args.device))
    try:
        mesh = lm.local_mesh(device)
        axes = dsh.subject_mesh_axes(mesh)
        index, count = dsh.subject_shard(mesh, axes)
        group = dsh.axis_group(mesh, axes)
        data = dec.load_dataset("choa", args.scale, 0)
        plan, balance = dec.plan_data(data, buckets=4, format=args.format, n_shards=count)
        bt, _ = dec.prepare(data, buckets=4, device=device, dtype=torch.float32,
                            format=args.format, plan=plan, shard=(index, count))
        held = torch.tensor([sum(b.nbytes() for b in bt.buckets)], device=device)
        every = [torch.zeros_like(held) for _ in range(count)]
        dist.all_gather(every, held, group=group)
        opts = Parafac2Options(rank=args.rank, backend=args.backend, engine="mesh",
                               check_every=args.check_every)
        out = {"world": count, "device": (torch.cuda.get_device_name(device)
                                          if device.type == "cuda" else "cpu"),
               "scale": args.scale, "format": args.format, "backend": args.backend,
               "check_every": args.check_every, "iters": args.iters,
               "shard_bytes": [int(t) for t in every],
               "imbalance": None if balance is None else balance["imbalance_max_over_mean"]}
        with record_collectives() as rec:
            out["mesh_first_ms"], _ = _timed(bt, opts, args.iters, group)
        # Python issues the all-reduces of the warm-up and the capture on CUDA
        # (the replays hold them), of every iteration on the CPU
        issued = engine.WARMUP_ITERS + 1 if device.type == "cuda" else args.iters
        out["allreduce_bytes_per_iter"] = rec["all-reduce"] // issued
        out["mesh_ms"], out["mesh_history"] = _timed(bt, opts, args.iters, group)
        if count == 1:
            scan = dataclasses.replace(opts, engine="scan")
            out["scan_first_ms"], _ = _timed(bt, scan, args.iters, group)
            out["scan_ms"], out["scan_history"] = _timed(bt, scan, args.iters, group)
        if dist.get_rank() == 0:
            print(json.dumps(out), flush=True)
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(out, f, indent=1)
        return out
    finally:
        lm.shutdown()


if __name__ == "__main__":
    main()
