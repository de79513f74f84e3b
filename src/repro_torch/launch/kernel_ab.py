"""Paired kernel times of two checkouts of the port on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.kernel_ab PARENT_DIR CHANGE_DIR \
        [--rounds 4] [--kernels fused_mode1_xkv,mode1_reuse] [--precision bf16] [--core]

Builds ``csrc/fused.cu``, ``csrc/gather_matmul.cu``, ``csrc/staged.cu``,
``csrc/scoo.cu``, ``csrc/polar.cu`` and ``csrc/tridiag.cu`` of each checkout
(``<dir>/src/repro_torch/csrc``; a source a checkout lacks is skipped, with
its kernels) with nvcc and this package's flags, loads
both builds into one process and times the same kernels of both on the same
operands in turns (parent, change, change, parent, ...): each turn takes
CUDA events around one launch (median of 20, the host's work for the
launch included, as a caller sees it) and around
the replay of a CUDA graph of 20 launches (median of 5 replays, divided by
20: the device's time a launch, no host work; what separates a short
kernel from its launch floor). F1-F4, row 5 (``spartan_ykv``), rows 6
and 7 (``mode1``, ``mode1_reuse``), row 8 (``spartan_mode2_compact``) and
rows 9 and 10 (``spartan_mode3``, ``spartan_mode3_reuse``) at the main
path's largest CC bucket shape (K = 58,112, I = 56, C = 128, R = 5, f32,
random operands, a subject mask with 2% zeros), row 10 once more at K = 1
(``mode3_reuse_k1``: the same kernel's launch floor on the same stream),
the BCC gather-matmul at the BCC cut's shape (K = 6,808, I = 56, NB = 9, L
= 128, R = 5, f32), and rows 11 (``spartan_scoo_xk_times_v``) and
12 (``spartan_scoo_project``) on the main path's largest SCOO bucket itself:
``choa_like(scale=0.25, seed=0)`` bucketized as SCOO on the card as the main
path plans it (Kb = 58,112, I = 48, C = 128, N = 136), with that bucket's
Vg gathered from a random V (row 11) and a random Q (row 12), since their
times depend on the segment lengths and the kept columns. The dense
kernels' times do not depend on the values (every value is read). P1
(``spartan_gram_inv_sqrt``, the polar's batched Jacobi) at R = 5, 10, 20
and 40 (``gram_inv_sqrt_r5`` ... ``gram_inv_sqrt_r40``; ``--kernels
gram_inv_sqrt`` names all four) on the main path's own Grams, since its
time depends on the values (each subject's sweeps): ``choa_like(scale=0.25,
seed=0)`` bucketized as CC on the card as the main path plans it, its
largest bucket (K = 58,112, I = 56), B from one ``fused_procrustes_b`` (the
auto route's) on the state ``init_state(rank=R, seed=0)``, G = B^T B in f32;
subjects with fewer rows than R give singular Grams, as on the main path.
Its two builds' outputs are held to each other Gram by Gram within
max(1e-6, R kappa 2^-53) of the Gram's max |P_inv| (the bound
``chip_smoke.py`` holds P1 to on the main path's Grams; kappa over the
eigenvalues the clamp keeps), and its library call is the chunked
``torch.linalg.eigh`` with the same inverse-root algebra (in runs of
16,384 Grams; past R = 32, where cuSOLVER solves one Gram at a time, one
call in the first round only). Past R = 8, where P1 takes milliseconds, a
turn takes the median of 5 event times and a graph of 2 launches replayed 3
times. P2 (``spartan_tridiag_solve``, the smooth prox's tridiagonal solve)
at W's rows of choa 0.25 (N = 116,225, R = 5, f32, random Y, rho = 1 on
the device, lam = 0.1), and again at the full CHOA's (N = 464,900,
``tridiag_solve_n464900``), on a workspace of each side's own; its time
does not depend on the values. F2 and
rows 6 and 7, the reductions across subjects, are called through their
one-launch entry points (``..._one_launch``, with the mask and a workspace
of each side's own). In each round, one PyTorch call of each of F2 and
rows 6, 7, 9 and 10 is timed too (``torch.einsum("krc,kcl,kl->rl", Yc, Vg,
Wb)`` for row 6, ``torch.einsum("krl,kl->rl", YkV, Wb)`` for row 7,
``(torch.bmm(Q^T, XkV) * Wb[:, None]).sum(0)`` for F2, on the folded Wb;
``torch.einsum("krc,kcl,rl,k->kl", Yc, Vg, H, m)`` for row 9 and
``torch.einsum("krl,rl,k->kl", YkV, H, m)`` for row 10). Prints the card's
name and power limit, each turn, per kernel the median of each side's turns
with their range, the library calls' medians, for F1-F4 and rows 5-13 the
largest absolute difference between the two builds' outputs on the same
operands (F1's over XkV and B) beside its tolerance (0, the same order of
sums, but for F1 at half width and P2, whose redesigns changed the order:
``tolerance``), and for F1, F3 and F4 the byte bound at
3.35 TB/s (each streamed operand read once at its width, each output
written once) and the change's share of it in a graph; the last line is one
JSON object. ``--core`` takes the dense kernels at the compressed fit's
core shape instead (I = 18, the rsvd cores' S at rank 5; K, C, R as
above). Imports no JAX. The
two machines a comparison could otherwise land on differ by more than the
effects, so compare versions only this way. ``--kernels`` times only the
kernels named (and skips the SCOO generation unless row 11 or 12 is among
them). ``--precision bf16|f16`` times the nine kernels that take half
operands (``HALF_KERNELS``: F1, F3, F4 and rows 5, 6, 8, 9, 11, 12) on
half copies of the operands they stream (the slab, Yc, Vg, the SCOO
values), the others float32, as the main path hands them at that
precision; it times no library call, and both checkouts must take half
operands (an older build refuses the dtype code, which raises).
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
    "spartan_fused_mode1_xkv_one_launch": [I, P, P, P, P, P, P, I, I, I, P],
    "spartan_fused_mode1_workspace": [I, I, I],
    "spartan_fused_mode2_compact": [I, P, P, P, P, P, P, I, I, I, I, P],
    "spartan_fused_ykv": [I, P, P, P, P, I, I, I, I, P],
    "spartan_mode1_one_launch": [I, P, P, P, P, P, P, I, I, I, P],
    "spartan_mode1_reuse_one_launch": [I, P, P, P, P, P, I, I, P],
    "spartan_mode1_workspace": [I, I, I],
    "spartan_gather_matmul": [I, P, P, P, P, I, I, I, I, I, P],
    "spartan_ykv": [I, P, P, P, I, I, I, P],
    "spartan_mode2_compact": [I, P, P, P, P, P, I, I, I, P],
    "spartan_mode3": [I, P, P, P, P, P, I, I, I, P],
    "spartan_mode3_reuse": [I, P, P, P, P, I, I, P],
    "spartan_scoo_xk_times_v": [I, P, P, P, P, P, I, I, I, I, I, P],
    "spartan_scoo_project": [I, P, P, P, P, P, P, I, I, I, I, I, P],
    "spartan_gram_inv_sqrt": [I, P, P, I, I, ctypes.c_double, P, P],
    "spartan_gram_inv_sqrt_workspace": [I, I],
    "spartan_tridiag_solve": [I, P, P, P, I, I, ctypes.c_double, P, P],
    "spartan_tridiag_workspace": [I, I, I],
}
SOURCES = ("fused", "gather_matmul", "staged", "scoo", "polar", "tridiag")
P2 = dict(N=116225, R=5, lam=0.1)       # W's rows at the main path's choa 0.25
P2_FULL = 464900        # W's rows at the full CHOA (tridiag_solve_n464900)
CC = dict(K=58112, I=56, C=128, R=5)
CORE_I = 18             # the rsvd cores' S = 2R + 8 at rank 5 (--core)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BCC = dict(K=6808, I=56, NB=9, L=128, J_pad=1408)
SCOO_SCALE = 0.25       # the choa_like scale of the main path
P1_RANKS = (5, 10, 20, 40)      # the paper's Figure 5 ranks (benchmarks/fig5_rank.py)
HALF_KERNELS = ("fused_procrustes_b", "fused_mode2_compact", "fused_ykv", "ykv", "mode1",
                "mode2_compact", "mode3", "scoo_xk_times_v", "scoo_project")
HALF_CODES = {"f32": 0, "bf16": 2, "f16": 3}      # common.cuh's dtype codes
HALF_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
STREAMED = ("vals", "Vg", "yc", "svals", "sVg")   # the operands the nine kernels stream
EIGH_BATCH = 16384      # the most 5x5 Grams one cuSOLVER eigh was seen to take on an H100
COMPARED = {"fused_procrustes_b": ("xkv", "b"), "fused_mode2_compact": "a", "fused_ykv": "g",
            "gather_matmul": "gout", "fused_mode1_xkv": "m2", "ykv": "ykv5", "mode1": "m6",
            "mode1_reuse": "m7", "mode2_compact": "a8", "mode3": "m9", "mode3_reuse": "m10",
            "mode3_reuse_k1": "m10k1", "scoo_xk_times_v": "xkv11",
            "scoo_project": "yc12", "tridiag_solve": "p2",
            "tridiag_solve_n464900": "p2full",
            **{f"gram_inv_sqrt_r{R}": f"p1_r{R}" for R in P1_RANKS}}   # kernel -> its output


def source_of(kernel: str) -> str:
    """The source that holds ``kernel``'s launch in ``calls``."""
    if kernel.startswith("fused_"):
        return "fused"
    if kernel.startswith(("gram_inv_sqrt", "tridiag", "scoo", "gather")):
        return {"gram": "polar", "trid": "tridiag", "scoo": "scoo",
                "gath": "gather_matmul"}[kernel[:4]]
    return "staged"


def needed_sources(wanted: set) -> tuple:
    """The sources to build for the kernels ``wanted`` (all of them when
    none is named); the reductions' entries need fused.cu and staged.cu
    both."""
    if not wanted:
        return SOURCES
    need = {source_of(k) for k in wanted}
    if wanted & {"fused_mode1_xkv", "mode1", "mode1_reuse"}:
        need |= {"fused", "staged"}
    return tuple(s for s in SOURCES if s in need)


def load(tree: str, sources=SOURCES) -> dict:
    """The libraries of one checkout (those of ``sources`` it has), with
    their C signatures."""
    libs = {}
    csrc = Path(tree) / "src/repro_torch/csrc"
    for name in sources:
        if not (csrc / f"{name}.cu").exists():
            continue
        lib = ctypes.CDLL(str(_build.build(name, csrc)))
        for fn, argtypes in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def reductions(f, st, o: dict, K: int, Ii: int, C: int, R: int, stream: int,
               code: int = 0) -> dict:
    """F2 and rows 6 and 7 of one side through their one-launch entries, each
    on a workspace of this side's own; they write this side's outputs. Row
    6 takes its streamed operands' dtype ``code``."""
    def workspace(lib, query):
        return torch.zeros(getattr(lib, query)(0, K, R), device="cuda")

    keep = [workspace(f, "spartan_fused_mode1_workspace"),   # live as long as the calls
            *(workspace(st, "spartan_mode1_workspace") for _ in range(2))]
    ws2, ws6, ws7 = (w.data_ptr() for w in keep)
    return {
        "fused_mode1_xkv": lambda: f.spartan_fused_mode1_xkv_one_launch(
            0, o["q2"], o["x2"], o["Wb"], o["sm"], ws2, o["m2"], K, Ii, R, stream),
        "mode1": lambda: st.spartan_mode1_one_launch(
            code, o["yc"], o["Vg"], o["Wb"], o["sm"], ws6, o["m6"], K, R, C, stream),
        "mode1_reuse": lambda: st.spartan_mode1_reuse_one_launch(
            0, o["ykv7"], o["Wb"], o["sm"], ws7, o["m7"], K, R, stream),
        "keep": keep}


def calls(libs: dict, ops: dict, outs: dict, stream: int, code: int = 0) -> dict:
    """name -> a function that launches that kernel of ``libs`` once on
    ``stream``; F1-F4 and rows 5-13 write into this side's own ``outs``. The
    nine kernels of ``HALF_KERNELS`` take their streamed operands' dtype
    ``code`` (0 float32, 2 bfloat16, 3 float16)."""
    f, g = libs.get("fused"), libs.get("gather_matmul")
    st, sc = libs.get("staged"), libs.get("scoo")
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]
    o = {k: v.data_ptr() for k, v in {**ops, **outs}.items()}
    Kb, N = ops["svals"].shape if "svals" in ops else (0, 0)
    Is = ops["sQ"].shape[1] if "sQ" in ops else 0
    Cs = ops["sends"].shape[1] if "sends" in ops else 0

    def check(err: int) -> None:
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")

    # the reductions' closures keep the workspaces
    red = reductions(f, st, o, K, Ii, C, R, stream, code) if f and st else {}
    p2 = {}
    if "tridiag" in libs:
        td, R2 = libs["tridiag"], P2["R"]
        for name, N2, y, z in (("tridiag_solve", P2["N"], "p2y", "p2"),
                               ("tridiag_solve_n464900", P2_FULL, "p2yfull", "p2full")):
            ws2 = torch.zeros(td.spartan_tridiag_workspace(0, N2, R2), device="cuda")
            # the closure holds its workspace: nothing else may keep it alive
            p2[name] = (lambda N2=N2, y=y, z=z, w=ws2: check(td.spartan_tridiag_solve(
                0, o[y], o["p2rho"], o[z], N2, R2, 2.0 * P2["lam"], w.data_ptr(), stream)))
    pl = libs.get("polar")
    p1 = {}
    for r in P1_RANKS:
        if f"G{r}" not in ops or pl is None:
            continue
        Kp = ops[f"G{r}"].shape[0]
        need = pl.spartan_gram_inv_sqrt_workspace(Kp, r)
        ws = torch.empty(max(need, 0), dtype=torch.float64, device="cuda")
        p1[f"gram_inv_sqrt_r{r}"] = (lambda r=r, Kp=Kp, w=ws if need > 0 else None:
                                     check(pl.spartan_gram_inv_sqrt(
                                         0, o[f"G{r}"], o[f"p1_r{r}"], Kp, r, 1e-12,
                                         None if w is None else w.data_ptr(), stream)))
    table = {
        "fused_procrustes_b": lambda: check(f.spartan_fused_procrustes_b(
            code, o["vals"], o["Vg"], o["Wb"], o["H"], o["xkv"], o["b"], K, Ii, C, R, stream)),
        "fused_mode1_xkv": lambda: check(red["fused_mode1_xkv"]()),
        "fused_mode2_compact": lambda: check(f.spartan_fused_mode2_compact(
            code, o["vals"], o["Q"], o["H"], o["Wb"], o["cm"], o["a"], K, Ii, C, R, stream)),
        "fused_ykv": lambda: check(f.spartan_fused_ykv(
            code, o["vals"], o["Q"], o["Vg"], o["g"], K, Ii, C, R, stream)),
        "gather_matmul": lambda: check(g.spartan_gather_matmul(
            0, o["bvals"], o["ids"], o["V"], o["gout"], BCC["K"], BCC["I"], BCC["NB"],
            BCC["L"], R, stream)),
        "ykv": lambda: check(st.spartan_ykv(code, o["yc"], o["Vg"], o["ykv5"], K, R, C, stream)),
        "mode1": lambda: check(red["mode1"]()),
        "mode1_reuse": lambda: check(red["mode1_reuse"]()),
        "mode2_compact": lambda: check(st.spartan_mode2_compact(
            code, o["yc"], o["H"], o["Wb"], o["cm"], o["a8"], K, R, C, stream)),
        "mode3": lambda: check(st.spartan_mode3(
            code, o["yc"], o["Vg"], o["H"], o["sm"], o["m9"], K, R, C, stream)),
        "mode3_reuse": lambda: check(st.spartan_mode3_reuse(
            0, o["ykv7"], o["H"], o["sm"], o["m10"], K, R, stream)),
        "mode3_reuse_k1": lambda: check(st.spartan_mode3_reuse(
            0, o["ykv7"], o["H"], o["sm"], o["m10k1"], 1, R, stream)),
        "scoo_xk_times_v": lambda: check(sc.spartan_scoo_xk_times_v(
            code, o["svals"], o["slcols"], o["sVg"], o["srow_ends"], o["xkv11"], Kb, N, Is, Cs, R,
            stream)),
        "scoo_project": lambda: check(sc.spartan_scoo_project(
            code, o["svals"], o["srows"], o["scperm"], o["sQ"], o["sends"], o["yc12"], Kb, N, Is,
            Cs, R, stream)),
    }
    return {**p1, **p2, **{n: fn for n, fn in table.items() if source_of(n) in libs}}


def slab_bound_ms(name: str, itemsize: int) -> float:
    """The byte bound of F1, F3 or F4 at ``CC``: the slab (and Vg for F1 and
    F4) read once at ``itemsize`` bytes, the float32 operands read and the
    outputs written once, over 3.35 TB/s."""
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]
    streamed = Ii * C + (C * R if name != "fused_mode2_compact" else 0)
    floats = {"fused_procrustes_b": R + 2 * Ii * R,            # Wb; XkV, B
              "fused_mode2_compact": Ii * R + R + C + C * R,   # Q, Wb, col_mask; A
              "fused_ykv": Ii * R + R * R}[name]               # Q; G
    return K * (streamed * itemsize + floats * 4) / HBM_BYTES_PER_S * 1e3


def tolerance(name: str, half: bool, pairs) -> float:
    """How far the change's output may lie from the parent's: 0 (the same
    order of sums, so the same bits) except for the kernels whose order a
    redesign changed. F1 at half width (its X_k Vg_k on the tensor cores):
    the f32 bound, 1e-6 of max(1, max |parent|). P2 (the levels in one
    launch, reduced in units): 1e-6 (1 + 8 lam / rho) of max |parent|, rho =
    1, the f32 bound chip_smoke.py holds it to (``p2_tolerance``)."""
    top = max(float(p.abs().max()) for p, _ in pairs)
    if name == "fused_procrustes_b" and half:
        return 1e-6 * max(1.0, top)
    if name.startswith("tridiag_solve"):
        return 1e-6 * (1.0 + 8.0 * P2["lam"]) * top
    return 0.0


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def graph_ms(fn, stream: torch.cuda.Stream, n: int = 20, reps: int = 5) -> float:
    """The device's time for one launch of ``fn`` (which launches on
    ``stream``): ``n`` launches captured in a CUDA graph, the graph replayed
    between two events; median of ``reps`` replays, divided by ``n``."""
    with torch.cuda.stream(stream):
        fn()                                # grids and shared-memory limits settled
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / n)
    return statistics.median(out)


def scoo_bucket():
    """The largest SCOO bucket of ``choa_like(SCOO_SCALE, seed=0)``, planned
    and uploaded as the main path's ``--format scoo`` does."""
    from repro_torch.launch import decompose

    data = decompose.load_dataset("choa", SCOO_SCALE, 0)
    bt, _ = decompose.prepare(data, buckets=4, device=torch.device("cuda"),
                              dtype=torch.float32, format="scoo")
    return max(bt.buckets, key=lambda b: b.kb)


def p1_grams(ranks) -> dict:
    """``G{R}``: the Grams G = B^T B of the largest CC bucket of
    ``choa_like(SCOO_SCALE, seed=0)`` at each rank of ``ranks``, B from
    the auto route's ``fused_procrustes_b`` on ``init_state(rank=R,
    seed=0)``; ``kappa{R}``: each Gram's condition over the eigenvalues
    that the clamp keeps (chunked ``eigvalsh`` in f64)."""
    from repro_torch.core import Parafac2Options, init_state
    from repro_torch.kernels import fused
    from repro_torch.launch import decompose

    data = decompose.load_dataset("choa", SCOO_SCALE, 0)
    bt, _ = decompose.prepare(data, buckets=4, device=torch.device("cuda"),
                              dtype=torch.float32, format="cc")
    b = max(bt.buckets, key=lambda x: x.vals.numel())
    out = {}
    for R in ranks:
        st = init_state(bt, Parafac2Options(rank=R, backend="auto"), seed=0)
        Wb = st.W[b.subject_ids.long()] * b.subject_mask[:, None]
        _, B = fused.fused_procrustes_b(b.vals, b.gather_v(st.V), Wb, st.H.contiguous())
        G = torch.bmm(B.transpose(1, 2), B)
        # many Grams past R = 8 on the CPU, where cuSOLVER would solve them one at a time
        Gd = G.double().cpu() if R > 8 else G.double()
        lam = torch.cat([torch.linalg.eigvalsh(g) for g in Gd.split(EIGH_BATCH)]).to(G.device)
        top = lam[:, -1:].clamp(min=0.0)
        kept = torch.where(lam > top * 1e-12, lam, torch.full_like(lam, float("inf")))
        out[f"G{R}"] = G
        out[f"kappa{R}"] = (top[:, 0] / kept.min(1).values).nan_to_num(nan=1.0, posinf=1.0)
        del B
    return out


def p1_library(G: torch.Tensor) -> torch.Tensor:
    """P1's function in PyTorch: ``torch.linalg.eigh`` in runs of
    ``EIGH_BATCH`` in G's dtype, then the clamp and E diag E^T (timed only)."""
    parts = [torch.linalg.eigh(g) for g in G.split(EIGH_BATCH)]
    lam, E = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    scale = torch.clamp(lam, min=0.0)
    tol = scale.amax(dim=-1, keepdim=True) * 1e-12
    inv_root = torch.where(scale > tol, torch.rsqrt(torch.maximum(scale, tol)),
                           torch.zeros_like(scale))
    return (E * inv_root[:, None, :]) @ E.transpose(1, 2)


def p1_agreement(parent: torch.Tensor, change: torch.Tensor, kappa: torch.Tensor,
                 R: int) -> tuple:
    """(largest |parent - change| / max |parent| over the Grams, whether every
    Gram is within max(1e-6, R kappa 2^-53) of its max |P_inv|)."""
    err = (parent.double() - change.double()).abs().amax((1, 2))
    scale = parent.double().abs().amax((1, 2))
    bound = torch.clamp(R * kappa * 2.0 ** -53, min=1e-6) * scale
    rel = float((err / scale.clamp(min=1e-300)).max())
    return rel, bool((err <= bound).all())


def operands(seed: int = 0, scoo: bool = True) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]

    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    Kb, NB, L = BCC["K"], BCC["NB"], BCC["L"]
    Wb = rand(K, R)
    sm = (rand(K) >= 0.02).float()           # 2% of the subjects masked
    dense = dict(
        vals=rand(K, Ii, C), Vg=rand(K, C, R), Wb=Wb, H=rand(R, R), Q=rand(K, Ii, R),
        sm=sm, Wbm=Wb * sm[:, None], q2=rand(K, Ii, R), x2=rand(K, Ii, R), ykv7=rand(K, R, R),
        cm=rand(K, C), bvals=rand(Kb, BCC["I"], NB, L), V=rand(BCC["J_pad"], R),
        ids=torch.randint(0, BCC["J_pad"] // L, (Kb, NB), device="cuda", dtype=torch.int32,
                          generator=gen),
        yc=rand(K, R, C), p2y=rand(P2["N"], P2["R"]), p2yfull=rand(P2_FULL, P2["R"]),
        p2rho=torch.ones((), device="cuda"))
    if not scoo:
        return dense
    sb = scoo_bucket()
    return dict(dense, svals=sb.vals, srows=sb.rows, scperm=sb.cperm, sends=sb.col_ends,
                sQ=rand(sb.kb, sb.i_pad, R), slcols=sb.lcols, srow_ends=sb.row_ends,
                sVg=sb.gather_v(rand(int(sb.cols.max()) + 1, R)))


def outputs(ops: dict) -> dict:
    """One side's outputs of F1-F4 and rows 5-13."""
    K, Ii, C, R = CC["K"], CC["I"], CC["C"], CC["R"]
    outs = {"xkv": torch.empty((K, Ii, R), device="cuda"),
            "gout": torch.empty((BCC["K"], BCC["I"], R), device="cuda"),
            "b": torch.empty((K, Ii, R), device="cuda"),
            "a": torch.empty((K, C, R), device="cuda"), "g": torch.empty((K, R, R), device="cuda"),
            "m2": torch.empty((R, R), device="cuda"), "m6": torch.empty((R, R), device="cuda"),
            "m7": torch.empty((R, R), device="cuda"),
            "ykv5": torch.empty((K, R, R), device="cuda"),
            "a8": torch.empty((K, C, R), device="cuda"),
            "m9": torch.empty((K, R), device="cuda"), "m10": torch.empty((K, R), device="cuda"),
            "m10k1": torch.empty((1, R), device="cuda"),
            "p2": torch.empty((P2["N"], P2["R"]), device="cuda"),
            "p2full": torch.empty((P2_FULL, P2["R"]), device="cuda")}
    for r in P1_RANKS:       # not R: rows 11 and 12's outputs below are at rank R
        if f"G{r}" in ops:
            outs[f"p1_r{r}"] = torch.empty_like(ops[f"G{r}"])
    if "sends" in ops:
        Kb, Cs = ops["sends"].shape
        outs.update(xkv11=torch.empty((Kb, ops["sQ"].shape[1], R), device="cuda"),
                    yc12=torch.empty((Kb, R, Cs), device="cuda"))
    return outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kernels", default="", help="comma-separated kernel names (default: all)")
    ap.add_argument("--core", action="store_true",
                    help=f"the dense kernels at the rsvd core shape (I = {CORE_I})")
    ap.add_argument("--precision", default="f32", choices=sorted(HALF_CODES),
                    help="bf16/f16: the nine kernels of HALF_KERNELS on half copies "
                         "of their streamed operands")
    args = ap.parse_args(argv)
    wanted = set(filter(None, args.kernels.split(",")))
    half = args.precision != "f32"
    if half:
        if wanted - set(HALF_KERNELS):
            raise SystemExit(f"--precision {args.precision} times only {HALF_KERNELS}")
        wanted = wanted or set(HALF_KERNELS)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab times kernels on a CUDA device; none is present")
    if args.core:
        CC["I"] = CORE_I
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[kernel_ab] card: {smi.stdout.strip() or smi.stderr.strip()}; dense kernels at "
          f"K={CC['K']} I={CC['I']} C={CC['C']} R={CC['R']}", flush=True)
    p1_wanted = [R for R in P1_RANKS
                 if not wanted or {"gram_inv_sqrt", f"gram_inv_sqrt_r{R}"} & wanted]
    ops = operands(scoo=not wanted or bool(wanted & {"scoo_xk_times_v", "scoo_project"}))
    if half:        # the streamed operands at half width, as the main path hands them
        ops.update({k: ops[k].to(HALF_DTYPES[args.precision]) for k in STREAMED if k in ops})
        print(f"[kernel_ab] precision {args.precision}: {', '.join(STREAMED)} half-width",
              flush=True)
    if p1_wanted:
        ops.update(p1_grams(p1_wanted))
        print(f"[kernel_ab] P1 on the largest CC bucket's Grams of choa scale {SCOO_SCALE}: "
              f"K={ops[f'G{p1_wanted[0]}'].shape[0]}, R in {p1_wanted}, condition up to "
              + ", ".join(f"{float(ops[f'kappa{R}'].max()):.3e} (R={R})" for R in p1_wanted),
              flush=True)
    if "svals" in ops:
        print(f"[kernel_ab] rows 11 and 12 on the largest SCOO bucket of choa scale "
              f"{SCOO_SCALE}: Kb={ops['svals'].shape[0]} I={ops['sQ'].shape[1]} "
              f"C={ops['sends'].shape[1]} N={ops['svals'].shape[1]} "
              f"nnz={int(ops['sends'][:, -1].sum())}", flush=True)
    outs = {side: outputs(ops) for side in ("parent", "change")}
    libs = {side: load(getattr(args, side), needed_sources(wanted))
            for side in ("parent", "change")}
    gstream = torch.cuda.Stream()           # where the graphs are captured

    def side_calls(side: str, stream: int) -> dict:
        code = HALF_CODES[args.precision]
        return {name: fn for name, fn in calls(libs[side], ops, outs[side], stream, code).items()
                if not wanted or name in wanted
                or (name.startswith("gram_inv_sqrt_r") and "gram_inv_sqrt" in wanted)}

    sides = {side: side_calls(side, torch.cuda.current_stream().cuda_stream) for side in libs}
    graphed = {side: side_calls(side, gstream.cuda_stream) for side in libs}
    for side in libs:       # a kernel one checkout lacks is timed on neither side
        other = sides["change" if side == "parent" else "parent"]
        sides[side] = {n: fn for n, fn in sides[side].items() if n in other}
        graphed[side] = {n: fn for n, fn in graphed[side].items() if n in other}
    Qt = ops["q2"].transpose(1, 2)
    library = {   # one PyTorch call of each, timed only
        "fused_mode1_xkv": lambda: (torch.bmm(Qt, ops["x2"]) * ops["Wbm"][:, None]).sum(0),
        "mode1": lambda: torch.einsum("krc,kcl,kl->rl", ops["yc"], ops["Vg"], ops["Wbm"]),
        "mode1_reuse": lambda: torch.einsum("krl,kl->rl", ops["ykv7"], ops["Wbm"]),
        "mode3": lambda: torch.einsum("krc,kcl,rl,k->kl", ops["yc"], ops["Vg"], ops["H"],
                                      ops["sm"]),
        "mode3_reuse": lambda: torch.einsum("krl,rl,k->kl", ops["ykv7"], ops["H"], ops["sm"]),
    }
    library = {name: (fn, 20, 3) for name, fn in library.items()
               if not half and (not wanted or name in wanted)}
    for R in p1_wanted:     # past R = 32 cuSOLVER solves one Gram at a time: seconds a call
        library[f"gram_inv_sqrt_r{R}"] = (lambda G=ops[f"G{R}"]: p1_library(G),
                                          *((5, 1) if R <= 32 else (1, 0)))
    times = {side: {name: [] for name in sides[side]} for side in sides}
    gtimes = {side: {name: [] for name in sides[side]} for side in sides}
    lib_times = {name: [] for name in library}
    for rnd in range(args.rounds):
        for side in ("parent", "change")[:: 1 if rnd % 2 == 0 else -1]:
            for name, fn in sides[side].items():
                # P1 past R = 8 takes milliseconds a call: fewer repetitions
                slow = name.startswith("gram_inv_sqrt_r") and int(name[15:]) > 8
                times[side][name].append(time_ms(fn, *((5, 1) if slow else (20, 3))))
                gtimes[side][name].append(graph_ms(graphed[side][name], gstream,
                                                   *((2, 3) if slow else (20, 5))))
            print(f"[kernel_ab] round {rnd} {side}: " + ", ".join(
                f"{n} {t[-1]:.4f} (graph {gtimes[side][n][-1]:.4f})"
                for n, t in times[side].items()) + " ms", flush=True)
        for name, (fn, reps, warmup) in library.items():
            if rnd == 0 or reps > 1:       # a call of seconds: the first round only
                lib_times[name].append(time_ms(fn, reps, warmup))
    torch.cuda.synchronize()
    summary = {}
    for name in sides["parent"]:
        p, c = times["parent"][name], times["change"][name]
        gp, gc = gtimes["parent"][name], gtimes["change"][name]
        summary[name] = {"parent_ms": statistics.median(p), "change_ms": statistics.median(c),
                         "parent_range": [min(p), max(p)], "change_range": [min(c), max(c)],
                         "parent_graph_ms": statistics.median(gp),
                         "change_graph_ms": statistics.median(gc),
                         "parent_graph_range": [min(gp), max(gp)],
                         "change_graph_range": [min(gc), max(gc)]}
        diff = ""
        if name in COMPARED:      # each side's output(s) of its last launch
            out = COMPARED[name]
            pairs = [(outs["parent"][o], outs["change"][o])
                     for o in ((out,) if isinstance(out, str) else out)]
            tol = tolerance(name, half, pairs)
            summary[name]["max_abs_diff"] = max(float((p - c).abs().max()) for p, c in pairs)
            summary[name].update(tolerance=tol,
                                 within_tolerance=summary[name]["max_abs_diff"] <= tol)
            diff = (f", max |parent - change| = {summary[name]['max_abs_diff']:.3e} "
                    f"(tolerance {tol:.3e}: {'within' if summary[name]['within_tolerance'] else 'PAST IT'})")
            out = out if isinstance(out, str) else out[-1]
            if name.startswith("gram_inv_sqrt_r"):
                R = int(name.rsplit("_r", 1)[1])
                rel, ok = p1_agreement(outs["parent"][out], outs["change"][out],
                                       ops[f"kappa{R}"], R)
                summary[name].update(max_rel_diff=rel, within_p1_bound=ok)
                diff += (f" ({rel:.3e} of max |P_inv|, every Gram within max(1e-6, R kappa "
                         f"2^-53): {ok})")
        if name in ("fused_procrustes_b", "fused_mode2_compact", "fused_ykv"):
            bound = slab_bound_ms(name, 2 if half else 4)
            summary[name].update(bound_ms=bound,
                                 change_share=bound / summary[name]["change_graph_ms"],
                                 parent_share=bound / summary[name]["parent_graph_ms"])
            diff += (f", bound {bound:.4f} ms (share in a graph: parent "
                     f"{summary[name]['parent_share']:.1%}, change "
                     f"{summary[name]['change_share']:.1%})")
        if name in library:
            lt = lib_times[name]
            summary[name]["library_ms"] = statistics.median(lt)
            summary[name]["library_range"] = [min(lt), max(lt)]
            diff += f", library {summary[name]['library_ms']:.4f} ms ({min(lt):.4f}-{max(lt):.4f})"
        print(f"[kernel_ab] {name}: parent {summary[name]['parent_ms']:.4f} ms "
              f"({min(p):.4f}-{max(p):.4f}), change {summary[name]['change_ms']:.4f} ms "
              f"({min(c):.4f}-{max(c):.4f}); in a graph parent "
              f"{summary[name]['parent_graph_ms']:.4f} ms ({min(gp):.4f}-{max(gp):.4f}), change "
              f"{summary[name]['change_graph_ms']:.4f} ms ({min(gc):.4f}-{max(gc):.4f}){diff}",
              flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "precision": args.precision,
                      "shape": dict(CC), "kernels": summary}))


if __name__ == "__main__":
    main()
