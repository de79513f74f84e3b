"""Paired end-to-end comparison of two checkouts of the port on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.paired PARENT_DIR CHANGE_DIR \
        [--pairs 3] [--scale 0.25] [--precision bf16]

Each run is a fresh process that imports ``repro_torch`` from one checkout
(``<dir>/src``, whatever package this module was imported from), builds
its kernels, makes ``choa_like(scale)`` with seed 0, uploads it as CC and
as SCOO buckets, warms each route up for two iterations and then times
20-iteration fits of the ``auto``, ``staged`` and ``torch`` routes on CC
and the ``staged`` route on SCOO three times each (host clock around
``fit``, which ends each iteration in a device sync). A checkout whose
``decompose`` takes an ``engine`` also times the CC ``auto`` and SCOO
``staged`` routes under ``engine="scan"`` (chunks of 10 replays of one
captured CUDA graph; the time includes its warm-up and capture), so that one
call shows parent-host against change-host and change-scan in turns. Runs
alternate parent, change, change, parent, ... so that slow drifts of a
shared host fall on both sides. Prints the card's name and power limit, one
line per run and the medians per side, and whether every fit history of a
route, over both checkouts and all their runs, is the same bit for bit
(what a change that must not move the default path shows); imports no
JAX. ``--precision bf16|f16`` runs every fit at that compute precision;
both checkouts' ``decompose`` must then take a ``precision``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

# (label, format, backend, engine); the scan runs only where decompose takes
# an engine (checkouts from before the scan engine run the host ones alone)
RUNS = (("auto", "cc", "auto", "host"), ("staged", "cc", "staged", "host"),
        ("torch", "cc", "torch", "host"), ("staged-scoo", "scoo", "staged", "host"),
        ("auto-scan", "cc", "auto", "scan"), ("staged-scoo-scan", "scoo", "staged", "scan"))
ROUTES = tuple(label for label, _, _, _ in RUNS)

_CHILD = r"""
import inspect, json, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.launch import decompose as dec
data = dec.load_dataset("choa", float(sys.argv[2]), 0)
bts = {fmt: dec.prepare(data, buckets=4, device=torch.device("cuda"), dtype=torch.float32,
                        format=fmt)[0] for fmt in ("cc", "scoo")}
kw = dict(rank=5, tol=0.0, seed=0, dtype=torch.float32, verbose=False)
params = inspect.signature(dec.decompose).parameters
has_engine = "engine" in params
if sys.argv[3] != "f32":
    if "precision" not in params:
        raise SystemExit(f"{sys.argv[1]}: decompose takes no precision")
    kw["precision"] = sys.argv[3]
runs = [r for r in %r if r[3] == "host" or has_engine]
def fit(fmt, be, engine, iters):
    extra = {"engine": engine} if has_engine else {}
    return dec.decompose(bts[fmt], backend=be, iters=iters, **kw, **extra)
for _, fmt, be, engine in runs:
    fit(fmt, be, engine, 2)
out = {label: [] for label, _, _, _ in runs}
hists = {}
for _ in range(3):
    for label, fmt, be, engine in runs:
        _, hist, secs = fit(fmt, be, engine, 20)
        out[label].append(secs / len(hist) * 1e3)
        hists.setdefault(label, []).append(hist)
print(json.dumps({"ms": out, "hist": hists}))
""" % (RUNS,)


def run(tree: str, scale: float, precision: str = "f32") -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, tree, str(scale), precision],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"run in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16", "f16"])
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[paired] card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    order = []
    for i in range(args.pairs):
        order += [("parent", args.parent), ("change", args.change)][:: 1 if i % 2 == 0 else -1]
    runs = {"parent": {be: [] for be in ROUTES}, "change": {be: [] for be in ROUTES}}
    hists = {"parent": {be: [] for be in ROUTES}, "change": {be: [] for be in ROUTES}}
    for side, tree in order:
        res = run(tree, args.scale, args.precision)
        for be in res["ms"]:
            runs[side][be] += res["ms"][be]
            hists[side][be] += res["hist"][be]
        print(f"[paired] {side}: " + ", ".join(
            f"{be} {[round(x, 2) for x in res['ms'][be]]} ms/iter" for be in res["ms"]),
              flush=True)
    for be in ROUTES:
        med = {side: (f"{statistics.median(runs[side][be]):.2f} ({len(runs[side][be])} fits)"
                      if runs[side][be] else "not run") for side in runs}
        every = hists["parent"][be] + hists["change"][be]
        same = bool(every) and all(h == every[0] for h in every)
        print(f"[paired] {be}: median ms/iter parent {med['parent']}, change "
              f"{med['change']}; every fit history of both checkouts bit for bit the same: "
              f"{same}", flush=True)


if __name__ == "__main__":
    main()
