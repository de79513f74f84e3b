"""Paired kernel times of two checkouts of the port on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.kernel_ab PARENT_DIR CHANGE_DIR \
        [--rounds 4]

Builds ``csrc/fused.cu`` and ``csrc/gather_matmul.cu`` of each checkout
(``<dir>/src/repro_torch/csrc``) with nvcc and this package's flags, loads
both builds into one process and times the same kernels of both on the same
random operands in turns (parent, change, change, parent, ...; CUDA events,
median of 20 launches a turn): F1-F4 at the main path's largest CC bucket
shape (K = 58,112, I = 56, C = 128, R = 5, f32) and the BCC gather-matmul
at the BCC cut's shape (K = 6,808, I = 56, NB = 9, L = 128, R = 5, f32).
The kernels' times do not depend on the values (every slab value is read).
Prints the card's name and power limit, each turn, and per kernel the
median of each side's turns with their range; the last line is one JSON
object. Imports no JAX. The two machines a comparison could otherwise land
on differ by more than the effects, so compare versions only this way.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build

P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "spartan_fused_procrustes_b": [I, P, P, P, P, P, P, I, I, I, I, P],
    "spartan_fused_mode1_xkv": [I, P, P, P, P, P, I, I, I, I, P],
    "spartan_fused_mode2_compact": [I, P, P, P, P, P, P, I, I, I, I, P],
    "spartan_fused_ykv": [I, P, P, P, P, I, I, I, I, P],
    "spartan_mode1_partials": [I],
    "spartan_gather_matmul": [I, P, P, P, P, I, I, I, I, I, P],
}
CC = dict(K=58112, I=56, C=128, R=5)
BCC = dict(K=6808, I=56, NB=9, L=128, J_pad=1408)


def load(tree: str) -> dict:
    """The two libraries of one checkout, with their C signatures."""
    libs = {}
    for name in ("fused", "gather_matmul"):
        lib = ctypes.CDLL(str(_build.build(name, Path(tree) / "src/repro_torch/csrc")))
        for fn, argtypes in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def calls(libs: dict, ops: dict) -> dict:
    """name -> a function that launches that kernel of ``libs`` once."""
    f, g = libs["fused"], libs["gather_matmul"]
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]
    n_part = f.spartan_mode1_partials(K)
    part = torch.empty((n_part, R, R), device="cuda")
    o = {k: v.data_ptr() for k, v in ops.items()}
    part_p = part.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def check(err: int) -> None:
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    return {
        "fused_procrustes_b": lambda: check(f.spartan_fused_procrustes_b(
            0, o["vals"], o["Vg"], o["Wb"], o["H"], o["xkv"], o["b"], K, Ii, C, R, stream)),
        "fused_mode1_xkv": lambda: check(f.spartan_fused_mode1_xkv(
            0, o["Q"], o["xkv"], o["Wb"], part_p, o["m1"], K, Ii, R, n_part, stream)),
        "fused_mode2_compact": lambda: check(f.spartan_fused_mode2_compact(
            0, o["vals"], o["Q"], o["H"], o["Wb"], o["cm"], o["a"], K, Ii, C, R, stream)),
        "fused_ykv": lambda: check(f.spartan_fused_ykv(
            0, o["vals"], o["Q"], o["Vg"], o["g"], K, Ii, C, R, stream)),
        "gather_matmul": lambda: check(g.spartan_gather_matmul(
            0, o["bvals"], o["ids"], o["V"], o["gout"], BCC["K"], BCC["I"], BCC["NB"],
            BCC["L"], R, stream)),
    }


def time_ms(fn, reps: int = 20) -> float:
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
    return statistics.median(out)


def operands(seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]

    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    Kb, NB, L = BCC["K"], BCC["NB"], BCC["L"]
    return dict(
        vals=rand(K, Ii, C), Vg=rand(K, C, R), Wb=rand(K, R), H=rand(R, R), Q=rand(K, Ii, R),
        cm=rand(K, C), xkv=rand(K, Ii, R), b=rand(K, Ii, R), m1=rand(R, R), a=rand(K, C, R),
        g=rand(K, R, R), bvals=rand(Kb, Ii, NB, L), V=rand(BCC["J_pad"], R),
        ids=torch.randint(0, BCC["J_pad"] // L, (Kb, NB), device="cuda", dtype=torch.int32,
                          generator=gen),
        gout=rand(Kb, Ii, R))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab times kernels on a CUDA device; none is present")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[kernel_ab] card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    ops = operands()
    sides = {"parent": calls(load(args.parent), ops), "change": calls(load(args.change), ops)}
    times = {side: {name: [] for name in sides[side]} for side in sides}
    for rnd in range(args.rounds):
        for side in ("parent", "change")[:: 1 if rnd % 2 == 0 else -1]:
            for name, fn in sides[side].items():
                times[side][name].append(time_ms(fn))
            print(f"[kernel_ab] round {rnd} {side}: " + ", ".join(
                f"{n} {t[-1]:.4f}" for n, t in times[side].items()) + " ms", flush=True)
    summary = {}
    for name in sides["parent"]:
        p, c = times["parent"][name], times["change"][name]
        summary[name] = {"parent_ms": statistics.median(p), "change_ms": statistics.median(c),
                         "parent_range": [min(p), max(p)], "change_range": [min(c), max(c)]}
        print(f"[kernel_ab] {name}: parent {summary[name]['parent_ms']:.4f} ms "
              f"({min(p):.4f}-{max(p):.4f}), change {summary[name]['change_ms']:.4f} ms "
              f"({min(c):.4f}-{max(c):.4f})", flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "kernels": summary}))


if __name__ == "__main__":
    main()
