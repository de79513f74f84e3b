"""Where P2's one launch spends its time, phase by phase, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.tridiag_trace [--n 116225,464900] [--r 5]

Copies ``csrc/tridiag.cu`` with a ``%globaltimer`` stamp (thread 0 of each
block, into a device array) at the boundaries of its phases, builds the
copy into ``repro_torch/_build/tridiag_trace/`` and calls it five times at
each N on random Y (f32, rho 1, lam 0.1); the stamps are the fifth call's.
Prints, in microseconds from the first block's start: the median block's
level-0 reduction of its first unit (``A1``), the unit's level-1 reduction
(``A2``), the end of phase A (median and last block), when the last block
took its ticket and published level 3's solution, when the last waiting
block was released, the median block's first unit's level-1 and level-0
back-substitutions (``C1``, ``C2``) and the end of phase C (median and
last). The end of phase C against a call's time in ``kernel_ab`` shows
what the stamps cost. Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SLOTS = 16          # stamps a block
MAX_BLOCKS = 4096
STAMP = f'''
__device__ unsigned long long p2_trace[{SLOTS} * {MAX_BLOCKS}];
__device__ inline unsigned long long p2_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define STAMP(i) do {{ if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) \\
    p2_trace[blockIdx.x * {SLOTS} + (i)] = p2_now(); }} while (0)
'''
# (text of csrc/tridiag.cu, the same text with a stamp): 0 start, 1 phase A
# done, 2 ticket taken, 3 level 3 published or the wait released, 4 phase C
# done, 7 the last block's mark, 8-11 the first unit's A1, A2, C1, C2
EDITS = [
    ("namespace {\n\nconstexpr int kChunk", "namespace {\n" + STAMP + "\nconstexpr int kChunk"),
    ("  top.load();\n  const int N = top.n, R = top.R, TC = col_threads(R);",
     "  STAMP(0);\n  top.load();\n  const int N = top.n, R = top.R, TC = col_threads(R);"),
    ("  // B: the last block solves level 3 and publishes it\n  if (last_block_to_finish(words)) {\n",
     "  STAMP(1);\n  // B: the last block solves level 3 and publishes it\n"
     "  if (last_block_to_finish(words)) {\n    STAMP(2);\n    STAMP(7);\n"),
    ("    if (threadIdx.x == 0) atomicAdd(words + 1, 1u);\n  } else {",
     "    if (threadIdx.x == 0) atomicAdd(words + 1, 1u);\n    STAMP(3);\n  } else {\n    STAMP(2);"),
    ("    __syncthreads();\n  }\n  // C:", "    __syncthreads();\n    STAMP(3);\n  }\n  // C:"),
    ("      __syncthreads();                         // the unit's level-1 rows\n",
     "      if (u == u0 && c0 == 0) STAMP(8);\n"
     "      __syncthreads();                         // the unit's level-1 rows\n"),
    ("      __syncthreads();                         // before the next columns' rows\n",
     "      if (u == u0 && c0 == 0) STAMP(9);\n"
     "      __syncthreads();                         // before the next columns' rows\n"),
    ("    __syncthreads();                           // the unit's level-1 solution\n",
     "    if (u == u0) STAMP(10);\n"
     "    __syncthreads();                           // the unit's level-1 solution\n"),
    ("        expand_chunk0(top, table0, s, e, col, j, l0, l1.x);\n    }\n  }\n}",
     "        expand_chunk0(top, table0, s, e, col, j, l0, l1.x);\n    }\n"
     "    if (u == u0) STAMP(11);\n  }\n  STAMP(4);\n}"),
    ('extern "C" {',
     'extern "C" {\nint p2_trace_copy(void* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, p2_trace, sizeof(p2_trace));\n}\n'),
]


def stamped_source(csrc: Path, out: Path) -> Path:
    """``csrc/tridiag.cu`` with the stamps, and ``common.cuh``, in ``out``."""
    src = (csrc / "tridiag.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"tridiag.cu no longer holds the phase boundary {old[:60]!r}")
        src = src.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    (out / "tridiag.cu").write_text(src)
    (out / "common.cuh").write_text((csrc / "common.cuh").read_text())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", default="116225,464900", help="comma-separated row counts")
    ap.add_argument("--r", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tridiag_trace times a kernel on a CUDA device; none is present")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[tridiag_trace] card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    csrc = Path(_build.__file__).resolve().parent.parent / "csrc"
    lib = ctypes.CDLL(str(_build.build(
        "tridiag", stamped_source(csrc, _build.BUILD_DIR / "tridiag_trace"))))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.spartan_tridiag_solve.argtypes = [I, P, P, P, I, I, ctypes.c_double, P, P]
    lib.spartan_tridiag_workspace.argtypes = [I, I, I]
    stream = torch.cuda.current_stream().cuda_stream
    for N in (int(x) for x in args.n.split(",")):
        R = args.r
        y = torch.rand((N, R), device="cuda")
        rho = torch.ones((), device="cuda")
        out = torch.empty_like(y)
        ws = torch.zeros(lib.spartan_tridiag_workspace(0, N, R), device="cuda")
        trace = np.zeros(SLOTS * MAX_BLOCKS, np.uint64)
        for _call in range(5):
            err = lib.spartan_tridiag_solve(0, y.data_ptr(), rho.data_ptr(), out.data_ptr(),
                                            N, R, 0.2, ws.data_ptr(), stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")
            torch.cuda.synchronize()
        if lib.p2_trace_copy(trace.ctypes.data):
            raise RuntimeError("could not read the stamps")
        t = trace.reshape(MAX_BLOCKS, SLOTS).astype(np.int64)
        t = t[t[:, 0] > t[:, 0].max() - 1_000_000]     # the fifth call's blocks
        t0 = t[:, 0].min()
        # every block stamps every call but for the last block's mark, whose
        # newest value is the fifth call's
        last = t[t[:, 7] == t[:, 7].max()][0]

        def us(v) -> str:
            return f"{(v - t0) / 1e3:.2f}"

        def med(k: int) -> str:
            return us(np.median(t[:, k]))

        print(f"[tridiag_trace] N={N} R={R}: {len(t)} blocks; A1 {med(8)}, A2 {med(9)}, "
              f"A done {med(1)} (last {us(t[:, 1].max())}); last block: ticket "
              f"{us(last[2])}, level 3 published {us(last[3])}; released by "
              f"{us(t[:, 3].max())}; C1 {med(10)}, C2 {med(11)}, C done {med(4)} (last "
              f"{us(t[:, 4].max())}) us", flush=True)


if __name__ == "__main__":
    main()
