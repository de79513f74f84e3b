"""Paired kernel times of two checkouts of the port on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.kernel_ab PARENT_DIR CHANGE_DIR \
        [--rounds 4]

Builds ``csrc/fused.cu``, ``csrc/gather_matmul.cu``, ``csrc/staged.cu`` and
``csrc/scoo.cu`` of each checkout (``<dir>/src/repro_torch/csrc``) with nvcc
and this package's flags, loads both builds into one process and times the
same kernels of both on the same operands in turns (parent, change, change,
parent, ...; CUDA events, median of 20 launches a turn): F1-F4, row 5
(``spartan_ykv``) and row 8 (``spartan_mode2_compact``) at the main path's
largest CC bucket shape (K = 58,112, I = 56, C = 128, R = 5, f32, random
operands), the BCC gather-matmul at the BCC cut's shape (K = 6,808, I = 56,
NB = 9, L = 128, R = 5, f32), and rows 11 (``spartan_scoo_xk_times_v``) and
12 (``spartan_scoo_project``) on the main path's largest SCOO bucket itself:
``choa_like(scale=0.25, seed=0)`` bucketized as SCOO on the card as the main
path plans it (Kb = 58,112, I = 48, C = 128, N = 136), with that bucket's
Vg gathered from a random V (row 11) and a random Q (row 12), since their
times depend on the segment lengths and the kept columns. The dense
kernels' times do not depend on the values (every value is read). Prints
the card's name and power limit, each turn, per kernel the median of each
side's turns with their range, and for rows 5, 8, 11 and 12 the largest
absolute difference between the two builds' outputs on the same operands;
the last line is one JSON object. Imports no JAX. The
two machines a comparison could otherwise land on differ by more than the
effects, so compare versions only this way.
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
    "spartan_ykv": [I, P, P, P, I, I, I, P],
    "spartan_mode2_compact": [I, P, P, P, P, P, I, I, I, P],
    "spartan_scoo_xk_times_v": [I, P, P, P, P, P, I, I, I, I, I, P],
    "spartan_scoo_project": [I, P, P, P, P, P, P, I, I, I, I, I, P],
}
SOURCES = ("fused", "gather_matmul", "staged", "scoo")
CC = dict(K=58112, I=56, C=128, R=5)
BCC = dict(K=6808, I=56, NB=9, L=128, J_pad=1408)
SCOO_SCALE = 0.25       # the choa_like scale of the main path
COMPARED = {"ykv": "ykv5", "mode2_compact": "a8", "scoo_xk_times_v": "xkv11",
            "scoo_project": "yc12"}   # kernel -> its output


def load(tree: str) -> dict:
    """The four libraries of one checkout, with their C signatures."""
    libs = {}
    for name in SOURCES:
        lib = ctypes.CDLL(str(_build.build(name, Path(tree) / "src/repro_torch/csrc")))
        for fn, argtypes in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def calls(libs: dict, ops: dict, outs: dict) -> dict:
    """name -> a function that launches that kernel of ``libs`` once; rows 5,
    8, 11 and 12 write into this side's own ``outs``."""
    f, g = libs["fused"], libs["gather_matmul"]
    st, sc = libs["staged"], libs["scoo"]
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]
    n_part = f.spartan_mode1_partials(K)
    part = torch.empty((n_part, R, R), device="cuda")
    o = {k: v.data_ptr() for k, v in {**ops, **outs}.items()}
    part_p = part.data_ptr()
    Kb, N = ops["svals"].shape
    _, Is, _ = ops["sQ"].shape
    Cs = ops["sends"].shape[1]
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
        "ykv": lambda: check(st.spartan_ykv(0, o["yc"], o["Vg"], o["ykv5"], K, R, C, stream)),
        "mode2_compact": lambda: check(st.spartan_mode2_compact(
            0, o["yc"], o["H"], o["Wb"], o["cm"], o["a8"], K, R, C, stream)),
        "scoo_xk_times_v": lambda: check(sc.spartan_scoo_xk_times_v(
            0, o["svals"], o["slcols"], o["sVg"], o["srow_ends"], o["xkv11"], Kb, N, Is, Cs, R,
            stream)),
        "scoo_project": lambda: check(sc.spartan_scoo_project(
            0, o["svals"], o["srows"], o["scperm"], o["sQ"], o["sends"], o["yc12"], Kb, N, Is,
            Cs, R, stream)),
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


def scoo_bucket():
    """The largest SCOO bucket of ``choa_like(SCOO_SCALE, seed=0)``, planned
    and uploaded as the main path's ``--format scoo`` does."""
    from repro_torch.launch import decompose

    data = decompose.load_dataset("choa", SCOO_SCALE, 0)
    bt, _ = decompose.prepare(data, buckets=4, device=torch.device("cuda"),
                              dtype=torch.float32, format="scoo")
    return max(bt.buckets, key=lambda b: b.kb)


def operands(seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]

    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    Kb, NB, L = BCC["K"], BCC["NB"], BCC["L"]
    sb = scoo_bucket()
    return dict(
        vals=rand(K, Ii, C), Vg=rand(K, C, R), Wb=rand(K, R), H=rand(R, R), Q=rand(K, Ii, R),
        cm=rand(K, C), xkv=rand(K, Ii, R), b=rand(K, Ii, R), m1=rand(R, R), a=rand(K, C, R),
        g=rand(K, R, R), bvals=rand(Kb, Ii, NB, L), V=rand(BCC["J_pad"], R),
        ids=torch.randint(0, BCC["J_pad"] // L, (Kb, NB), device="cuda", dtype=torch.int32,
                          generator=gen),
        gout=rand(Kb, Ii, R), yc=rand(K, R, C),
        svals=sb.vals, srows=sb.rows, scperm=sb.cperm, sends=sb.col_ends,
        sQ=rand(sb.kb, sb.i_pad, R), slcols=sb.lcols, srow_ends=sb.row_ends,
        sVg=sb.gather_v(rand(int(sb.cols.max()) + 1, R)))


def outputs(ops: dict) -> dict:
    """One side's outputs of rows 5, 8, 11 and 12."""
    K, C, R = CC["K"], CC["C"], CC["R"]
    Kb, Cs = ops["sends"].shape
    return {"ykv5": torch.empty((K, R, R), device="cuda"),
            "a8": torch.empty((K, C, R), device="cuda"),
            "xkv11": torch.empty((Kb, ops["sQ"].shape[1], R), device="cuda"),
            "yc12": torch.empty((Kb, R, Cs), device="cuda")}


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
    print(f"[kernel_ab] rows 11 and 12 on the largest SCOO bucket of choa scale {SCOO_SCALE}: "
          f"Kb={ops['svals'].shape[0]} I={ops['sQ'].shape[1]} C={ops['sends'].shape[1]} "
          f"N={ops['svals'].shape[1]} nnz={int(ops['sends'][:, -1].sum())}", flush=True)
    outs = {side: outputs(ops) for side in ("parent", "change")}
    sides = {side: calls(load(getattr(args, side)), ops, outs[side])
             for side in ("parent", "change")}
    times = {side: {name: [] for name in sides[side]} for side in sides}
    for rnd in range(args.rounds):
        for side in ("parent", "change")[:: 1 if rnd % 2 == 0 else -1]:
            for name, fn in sides[side].items():
                times[side][name].append(time_ms(fn))
            print(f"[kernel_ab] round {rnd} {side}: " + ", ".join(
                f"{n} {t[-1]:.4f}" for n, t in times[side].items()) + " ms", flush=True)
    torch.cuda.synchronize()
    summary = {}
    for name in sides["parent"]:
        p, c = times["parent"][name], times["change"][name]
        summary[name] = {"parent_ms": statistics.median(p), "change_ms": statistics.median(c),
                         "parent_range": [min(p), max(p)], "change_range": [min(c), max(c)]}
        diff = ""
        if name in COMPARED:      # each side's output of its last launch
            out = COMPARED[name]
            summary[name]["max_abs_diff"] = float(
                (outs["parent"][out] - outs["change"][out]).abs().max())
            diff = f", max |parent - change| = {summary[name]['max_abs_diff']:.3e}"
        print(f"[kernel_ab] {name}: parent {summary[name]['parent_ms']:.4f} ms "
              f"({min(p):.4f}-{max(p):.4f}), change {summary[name]['change_ms']:.4f} ms "
              f"({min(c):.4f}-{max(c):.4f}){diff}", flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "kernels": summary}))


if __name__ == "__main__":
    main()
