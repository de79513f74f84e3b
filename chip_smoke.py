"""Quickest proof that the PyTorch/CUDA port builds and runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); exits non-zero without them.
Imports only the port (``src/repro_torch``), never JAX or the JAX package.
Phases, any failure exits non-zero:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   kernel build from ``src/repro_torch/csrc`` (``fused.cu``, ``staged.cu``,
   ``scoo.cu``, ``gather_matmul.cu``, ``polar.cu`` and ``tridiag.cu``, one
   nvcc each, started together);
2. each of the fifteen kernels against its plain torch version on the
   card, in f32 and f64: the four fused and the six staged over eleven small
   CC geometries (the reference's four; R = 40, its widest cell; R = 72,
   past the widest register tile; C_pad = 1024 at R = 40; R = 72 with
   C_pad = 1024 and up to 700 rows a subject, where every fused kernel's
   shared-memory tile is chunked; one subject; C_pad = 17, whose slab rows
   are not whole 16-byte runs; R = 64); the two SCOO kernels over the
   reference's three SCOO datasets (an empty, a single-nnz and a 200-row
   ultra-sparse subject among them) at R = 1, 5 and 72 with padded subjects,
   and over explicit zero-valued triplets; the BCC gather-matmul over the
   reference's BCC geometries and R = 72; rows 5, 8, 11 and 12 at the edges
   of their variants (unaligned and odd C, C past the tile, R = 72 at C_pad
   = 1024, empty subjects, rows and columns, a segment of length N, N and I
   past the shared-memory stages, unaligned starts, more subjects than the
   persistent grid), F4 and F3 at theirs (``SLAB_EDGES``: the main path's
   shape, subjects past the persistent grid, rows not whole 16-byte runs,
   an unaligned slab, one subject of one row, the rsvd cores' 18 rows
   (below the rings' 32), R = 9 past F4's register owners, R = 64, C_pad =
   1024 with I not a multiple of 16, subjects too large for the rings, R =
   72, chunked tiles) with a float32, float64,
   bfloat16 and float16 slab, where each shape must take the variant stated,
   every variant of each must be reached at each dtype (the tensor-core
   ring of F4 at half width), each call must give the same bits twice and
   F3 zeros at masked subjects and columns, and F2 and row 7, the
   one-launch reductions across subjects, at theirs (K from 1 to the main
   path's 58,112, runs past the last subject, R = 1, 11 and 72, I past
   F2's ring, unaligned starts and
   tiles, no, some and every subject masked), and rows 9 and 10, mode3 and
   mode3_reuse, at row 9's (unaligned starts, odd C, R = 72 at C_pad =
   1024, groups past the persistent grid and outputs past row 10's one
   wave, one subject, no, some and every subject masked), where each must
   take the variant stated and every variant must be reached; F2, row 7
   and rows 9 and 10 must give the same bits twice more on the same
   input, F2 and row 7 also on their largest bucket after
   the smaller ones, and ``mode3(Yc, Vg, H, m)`` must equal
   ``mode3_reuse(ykv(Yc, Vg), H, m)`` bit for bit; P1, the polar's inverse
   root (the port's own kernel), at R = 1, 2, 5, 8, 9, 10, 16, 20, 32, 33,
   40, 64, 65, 72 and 130 (every design and its edges: a thread a subject
   up to 8, a warp a subject up to 64, a block with shared memory, a block
   with a global workspace) and K = 1 and 37 on zero, identity,
   rank-deficient and conditioned Grams, and at K = 16,385 and 58,112 (R =
   1, 2, 5, 8 and 40), 58,112 (R = 10 and 20), 16,385 (R = 72) and 1,000 (R
   = 130), past every design's grid, every
   seventh Gram zero, relative to max |P_inv| (``p1_tolerance``), zero
   Grams to exact zeros, and Q^T Q = I on full-rank B, with what an f32
   eigh departs by (the reason P1 solves in f64); P2, the smooth prox's
   tridiagonal solve (the port's own kernel), at N = 2, 3, 33, 64, 65,
   1,025, 4,097, 116,225 and 464,900, R = 1, 5 and 40, lam = 0, 0.1, 5
   and 70 (rho / lam = 0.01, where the matrix is least dominant; f32 to
   1e-6 times the condition bound 1 + 8 lam / rho), the same bits twice, a
   captured call replayed after rho changed on the device, and its device
   kernels a call at N = 116,225 and 464,900 counted in a captured graph
   against the count its C library reports (one launch); F1's tensor-core
   ring at bf16 and f16 at its edges (``F1_HALF_EDGES``: R 1-8, I 1 to 64,
   C 1 to 130, an unaligned slab, K 1 to 58,112, masked subjects) against
   its plain version, the same bits twice; the
   compression path's core shapes (``CORE_SPECS``): F1-F4 and rows 5, 7, 8
   and 10 on the rsvd cores [Kb, 18, 128] at R = 5 and [Kb, 16, 128] at R =
   4 of a small dataset, with the variant each takes, and P1 at R = S on the
   same buckets' range-finder Grams (thin subjects' rank-deficient and
   padded subjects' zero Grams among them) Gram by Gram; an empty (K=0) bucket
   through every wrapper. f64 to 1e-12 absolute, f32 to 1e-6 relative plus 1e-6 of
   the output's largest magnitude (sums in another order differ by a
   rounding); for the two SCOO kernels the scale is the largest running
   sum of |contribution| instead, since their plain versions difference
   running sums, which round in proportion to the prefix; every call must
   launch its kernel;
3. the main path: ``choa_like(scale=0.25)``, rank 5, 20 iterations, f32,
   through ``repro_torch.launch.decompose``'s functions, from one
   generation bucketized twice: CC on ``backend="auto"`` (the fused
   kernels), ``"staged"`` (the staged kernels) and ``"torch"``, then SCOO
   (``format="scoo"``, planned by nnz) on ``"staged"`` (the two SCOO
   kernels, then the staged ones), ``"scoo"`` (plain torch) and
   ``"auto"`` (F2), each after two warm-up iterations; each route's
   kernels (P1 on every route, the torch and scoo ones too) must launch
   buckets x iterations times and no other kernel, and every fit history
   must be finite and within 1e-4 of the CC torch route's; then scale 0.002 in
   f64 through the entry point's ``main``: CC on the three CC routes and
   ``--engine scan --check-every 0`` on auto, and ``--format scoo`` and
   ``--format auto`` on the three SCOO routes, histories within 1e-8 of
   the CC torch route's;
   then the paths that reach the other two staged kernels: a short
   ``mode1_reuse=False`` fit (``mode1``, buckets x iterations) and the
   backend's array-level ``mode3`` over the main path's buckets (once per
   bucket, with row 9's variant per bucket); the BCC cut: the largest CC bucket's first subjects (at
   most 2 GiB of BCC values), ``xk_times_v_bcc`` against ``xk_times_v``;
   last, the scan engine (CUDA graphs) on CC auto, CC staged and SCOO
   staged at check_every 10 and 0: the same launch counts under replay, the
   history against the same route's host engine (bit for bit, else within
   1e-6) and the torch route's, peak memory, the replayed ms/iter beside
   the set-up; no host sync (``set_sync_debug_mode("error")``) in one eager
   ``als_step`` and one chunk replay; the while variant's stop and masked
   iterations and a chunked run's overshoot at a tol the fit crosses;
   then half precision (``phase3_half``): the nine kernels that take half
   operands (F1, F3, F4, rows 5, 6, 8, 9, 11 and 12) against their plain
   versions on bf16 and f16 inputs at the largest CC and SCOO buckets (row 5
   also with one operand f32; f32 tolerance: products of half values are
   exact in f32), one refused dtype combination a kernel family, and the
   CC auto, CC staged and SCOO staged fits at bf16 and f16 on the host and
   scan (check_every 10) engines: within 1e-3 of the route's f32 fit, scan
   bit for bit the host, the route's launches, ms/iter and the memory each
   fit adds (its half copy of the values included), no host sync in a bf16
   eager step or replay, and the paths of rows 6 and 9 at bf16;
   then the constraint layer (``CONSTRAINED``: ADMM nonneg on V and W, and
   nonneg+l1 on V with smooth on W, the latter through P2) on CC auto and
   SCOO staged beside the CC torch route, host engine and scan engine at
   check_every 10 and 0: scan bit for bit the host (the history and every
   state tensor, W and the duals included), within 1e-4 of the
   torch route, P2 launched once a prox (201 times a fit), no host sync in
   an eager step or a replay; and scale 0.002 in f64 through
   ``decompose.main --constraint`` on the card within 1e-8 of the port's
   own CPU run; then compression (``phase3_compress``, ``compress="rsvd"``,
   S = 18): on CC auto, CC staged and SCOO staged the pass alone (seconds,
   captured energy, the GiB its cores and bases hold, P1 once a bucket),
   the core ALS alone (host ms/iter, each core kernel buckets x iterations
   times, scan replays), and the entry point end to end on the host and
   scan engines: the GiB the fit adds, the core kernels launched, the
   final fit within 1e-3 relative of the route's uncompressed fit, scan bit
   for bit the host; and scale 0.002 in f64 through ``decompose.main
   --compress rsvd`` on the card within 1e-8 of the port's CPU run, with
   the reference's compress block; then serving (``phase3_stream``): choa
   0.25's synthetic stream (warm fraction 0.6), a ``StreamService`` warm
   started by 20 iterations on CC auto (8 and 64 slots) and SCOO staged (8
   slots), the first 4,096 payloads: dispatch latency p50/p99 with the
   host staging and the device part apart, subjects per second, the
   launches a dispatch (F1, F4 and P1 on auto; rows 11, 12, 5, 10 and P1 on
   staged; nothing else), the ``_adopt`` pass's seconds; on the 8-slot
   services save, restore and one more batch bit for bit the uninterrupted
   service, a cold refit bit for bit the batch fit over the union, and the
   GiB a service with one refit adds; the ``_adopt`` pass over the whole
   116,225-subject union; f64 choa 0.002 on the card against the CPU: the
   warm fits within 1e-8, and from the same warm factors the replay's
   stream_fit, drift and baseline within 1e-8, and the W rows and
   residuals (relative) of the subjects whose kept Gram condition is at
   most 1e4 (a W row of an ill-conditioned subject is determined only to
   about its condition times 2^-53 of its inputs); then the supervised scan fit (``phase3_supervisor``,
   CC auto, scan 10, 20 iterations): faultless, a blip, a restore from
   disk, a NaN rollback and a resume, each bit for bit the bare scan fit,
   ms/iter beside the bare fit's (with and without a shared chunk cache),
   a checkpoint write's seconds and a ridge escalation's fit; before the
   stream, the mesh engine (``phase3_mesh``): a world of one over NCCL on
   CC auto and SCOO staged at check_every 10 and 0, bit for bit the scan
   engine with the same launches, its 4 all-reduces an iteration issued
   inside the capture, the captured graph's nodes by kind beside the scan
   chunk's (NCCL kernels counted), the bytes all-reduced an iteration and
   the second fit's ms/iter beside the scan engine's; then choa 0.25's CC
   plan nnz-balanced and cut into 4 rank shards (``bucketize(shard=...)``),
   every subject's F1 XkV and B, P1 Q, F4 G and F3 A rows bit for bit the
   unsharded buckets', the shards' M1, M2, M3 and delta partials summed
   within the f32 tolerance, each shard's bytes within a quarter of the
   whole plus its padding;
4. each kernel's time beside its bound, its plain version's time, one
   PyTorch call's time (CUDA events, median of 20) and the wrapper call's
   host time (what an event time of a short kernel includes before the
   launch), and for F2, row 7, P1 and P2 the device kernels one call
   launches (the kernel nodes of a graph captured from the call, read back
   from the driver) and the allocations a repeated call makes
   (torch.cuda.memory_stats; the [R, R] result only): the CC kernels at the
   main path's largest CC bucket (with the variant F1-F4 and rows 5, 8, 9
   and 10 take there; row 10 has one), the SCOO kernels at its largest SCOO bucket (with the variants of
   rows 11 and 12), the gather-matmul on the BCC
   cut (beside the CSR product over the cut's nonzeros, also one PyTorch
   call on the kernel's own operands, ``library_same_input_ms``), and P1 on
   the largest CC bucket's own Grams (bound by its function, not by the
   sweeps the kernel took; library: the chunked ``torch.linalg.eigh`` and
   the same inverse-root algebra), at the main path's R = 5 and, in its
   row's ``by_rank``, at the paper's R = 10, 20 and 40 (B from F1 on a
   seeded state of that rank), each Gram held to its plain version on the
   CPU (LAPACK; cuSOLVER's f64 eigh is the less accurate of the two there),
   and P2 on the l1-smooth fit's W (N = 116,225, R = 5) by events and in a
   replayed CUDA graph, its device kernels and allocations a call measured,
   no library call (none solves a tridiagonal system); then the nine half
   kernels at bf16 on the same buckets (``phase4_half``): events, a
   replayed graph, the plain version, the byte bound at half width and one
   PyTorch call a function on the same half inputs (F3, F4 and rows 6, 8
   and 9 by an einsum with every operand at bf16);
   then (``phase4_cores``) F1-F4 and rows 5, 7, 8 and 10 at CC auto's
   largest core bucket [58,112, 18, 128] on the compressed fit's state and
   P1 at R = 18 on that bucket's range Grams, by events and in a replayed
   graph, beside their bounds (rows ``<kernel>[core]`` and
   ``gram_inv_sqrt[range]``);
5. a ``torch.profiler`` trace of one main-path ALS iteration on the auto and
   the staged route over the CC buckets and on the staged and the scoo
   route over the SCOO buckets: device time by kernel (and of each of the
   port's own kernels), host time by op, and
   the device's busy share of the unprofiled iteration time of phase 3 and
   of the trace's first-to-last kernel span (the profiler's own per-launch
   cost inflates the profiled wall time, so that is not a denominator;
   traces in ``$SMOKE_OUT/als_step_trace_<route>.json``); one profiled
   iteration of CC auto with each ``CONSTRAINED`` spec (P2's device time);
   one profiled iteration of CC auto's rsvd cores (``auto-cores``);
   one profiled iteration of CC auto at R = 10, 20 and 40 after two unprofiled ones:
   P1's device time and share beside the largest items; then one replayed
   10-iteration chunk of the scan engine on CC auto, CC staged and SCOO
   staged: device time an iteration and its busy share of an unprofiled
   replay of the same chunk just before it (trace of CC auto's in
   ``$SMOKE_OUT/scan_chunk_trace_auto.json``); last, one 8-slot dispatch
   of the CC auto stream service (``stream_dispatch_trace_auto.json``).

6. last, the LM testbed's serving path (``phase3_lm``, no hand kernel on
   it: every kernel count reset before it must read 0 after):
   ``repro_torch.launch.serve`` at the full width of qwen3-0.6b and
   mamba2-780m (bf16, batch 4, prompt 16, gen 16, the port's random init)
   with prefill ms, decode ms a step, tok/s and the peak GiB while serving;
   then, in a child process (``chip_smoke.py --lm-full-width``, so that its
   profiler session cannot touch this process's), each full-width model's
   prompt through ``prefill_step`` against the same prompt teacher-forced
   through ``decode_step`` (finite, within 0.1 of the largest logit at
   bf16, greedy tokens equal on the positions a top-two margin decides, at
   least one), a decode whose cache is zeroed before every step beyond that
   bound, and one profiled eager decode step (device kernels, busy share,
   the step against its byte bound); the ten archs at ``reduced`` width
   (f32) on the card against the port's CPU run from the same parameters
   (``serve.against_cpu``): logits and 8 decode steps within 1e-5 of the
   largest magnitude, greedy tokens equal (traces in
   ``$SMOKE_OUT/lm_decode_step_trace_<arch>.json``).
7. then the LM testbed's training path (``phase3_lm_train``), in a child
   process (``chip_smoke.py --lm-train``): (a) the ten archs at ``reduced``
   width (f32), train steps 0-2 on the card against the port's CPU run
   from the same parameters (``train.against_cpu``: losses within 1e-5,
   step 0's moments within 1e-5, parameters and moments within
   ``train.step_gaps``'s bounds, step 0 moving nothing); (b)
   ``repro_torch.launch.train`` at the full width of qwen3-0.6b (bf16,
   remat, 8 steps of 8 x 256 tokens) with step ms, tokens/s and peak GiB,
   the same model on one fixed batch (step 0's loss inside 0.5-3 ln V, the
   loss falling) and one profiled step (device kernels, busy share, the
   step against its floor); (c) a persistent fault at reduced width under
   deterministic algorithms, bit for bit an uninterrupted run; (d) the
   activation-signatures example, whose fit launches F1-F4 and P1, and the
   same fit in f64 within 1e-8 of the CPU's torch route.
8. then the LM on a mesh and the two remaining examples
   (``phase3_lm_mesh``), in a child process (``chip_smoke.py --lm-mesh``,
   a world of one whose CUDA tensors go through NCCL and CPU tensors
   through gloo): (a) one phi3.5-moe MoE block at full width (bf16, 4 x 512
   tokens) through ``_moe_block_manual`` on a (1, 1) mesh, against
   ``_moe_block_auto`` at a no-drop capacity in bf16 (1e-3) and f32 (1e-5),
   and at the config's capacity (drops) in f32 against the port's CPU run
   on 512 tokens (1e-5),
   with the block's forward and backward ms and peak GiB; (b)
   ``compressed_psum`` on qwen3-0.6b's parameter shapes (f32) bit for bit
   the CPU function, its errors local, its ms; (c) ``param_shardings`` of
   qwen3-0.6b's and phi3.5-moe's full trees laid out leaf by leaf by
   ``distribute_tensor``; (d) the quickstart and phenotyping examples, whose
   f32 fits launch F1-F4 and P1 (beside the CC torch route's, unbounded:
   ill-conditioned), their f64 fits within 1e-8 of the CPU's, quickstart's
   asserts.

Files go to ``$SMOKE_OUT`` (default ``smoke_out/``).

The last two lines are a JSON object with the kernels' numbers (the bf16
rows of the nine half kernels named ``<kernel>[bf16]``, the core-shape rows
``<kernel>[core]`` and ``gram_inv_sqrt[range]``) and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
OUT = Path(os.environ.get("SMOKE_OUT", "smoke_out"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12              # H100 SXM float64 outside the tensor cores
HALF_FLOPS = 989e12            # H100 SXM bfloat16/float16 (tensor cores, dense)
HALF = ("bf16", "f16")         # the compute precisions below f32
# the nine kernels that take half operands, and the route of the path that
# reaches each at half precision (rows 6 and 9: their own short paths)
HALF_KERNELS = ("fused_procrustes_b", "fused_mode2_compact", "fused_ykv", "ykv", "mode1",
                "mode2_compact", "mode3", "scoo_xk_times_v", "scoo_project")
ITERS = 20
MAIN_SCALE = 0.25
GEOMETRIES = [
    dict(seed=0, K=13, J=37, R=5, col_align=4),
    dict(seed=1, K=9, J=200, R=8, col_align=128),
    dict(seed=2, K=7, J=21, R=1, col_align=8),
    dict(seed=3, K=11, J=50, R=6, col_align=4, subject_align=8),
    dict(seed=4, K=10, J=90, R=40, col_align=8),      # the reference's widest cell
    dict(seed=5, K=8, J=150, R=72, col_align=8),      # past the 64-wide tile
    dict(seed=6, K=6, J=120, R=40, col_align=1024),   # C_pad = 1024
    dict(seed=7, K=4, J=60, R=72, col_align=1024, max_rows=700),   # every tile chunked
    dict(seed=8, K=1, J=30, R=5, col_align=4),        # one subject
    dict(seed=9, K=9, J=40, R=5, col_align=1),        # C_pad 17: rows not whole 16-byte runs
    dict(seed=10, K=6, J=80, R=64, col_align=8),      # the widest register tile
]
# the reference's SCOO datasets (tests/test_scoo.py) and BCC geometries
# (tests/test_bcc_integration.py), plus R = 72
SCOO_DATA = ("edge", "random-odd", "random-padded")
BCC_GEOMETRIES = [(0, 300, 8), (1, 500, 16), (2, 130, 4), (3, 260, 72)]
BCC_CUT_BYTES = 2 * 2**30       # the BCC cut's values at most
# rows 5, 8, 11 and 12 at the edges of their variants, and the variant each
# takes in f32: rows 5 and 8 (K, R, C, offset of Yc's start in elements),
# rows 11 and 12 (I, C, N, nnz per subject, R, one row (11) or one column
# (12), offset of vals' start in elements)
YKV_EDGES = {
    (7, 5, 128, 0): "ring",                      # the main path's shape
    (5, 5, 17, 0): "ring-element-copies",        # rows not whole 16-byte runs
    (3, 72, 1024, 0): "thread-per-entry",        # R = 72 at C_pad = 1024: past the stages
    (5, 5, 128, 1): "ring-element-copies",       # Yc's start not 16-byte aligned
    (3000, 5, 128, 0): "ring",                   # groups past the persistent grid
    (1, 5, 128, 0): "ring",                      # one subject
    (4, 40, 128, 0): "ring",                     # R = 40, one subject a group
}
MODE2_EDGES = {
    (7, 5, 128, 0): "ring",                      # the main path's C
    (5, 5, 17, 0): "ring-element-copies",        # rows not whole 16-byte runs
    (4, 5, 1000, 0): "ring",                     # C not a multiple of the tile
    (3, 72, 1024, 0): "ring",                    # R = 72 at C_pad = 1024
    (6, 8, 130, 0): "ring-element-copies",       # odd width, the register tile's R
    (5, 9, 64, 0): "ring",                       # R past the register tile
    (5, 5, 128, 1): "ring-element-copies",       # Yc's start not 16-byte aligned
    (3, 200, 40, 0): "thread-per-entry",         # R too wide for the ring's tile
    (1500, 5, 128, 0): "ring",                   # items past the persistent grid
}
PROJECT_EDGES = {
    (8, 16, 64, (64, 0, 10), 5, True, 0): "ring",         # a segment of length N, an empty subject
    (5, 9, 13, (13, 2, 0, 7, 5), 5, False, 0): "ring-element-copies",   # runs not whole packs
    (8, 16, 24, (24, 3, 0, 9), 5, False, 1): "ring-element-copies",    # vals' start unaligned
    (40, 128, 3000, (3000, 17, 0), 5, False, 0): "thread-per-entry",  # N past the stages
    (1000, 32, 40, (40, 0, 33), 8, False, 0): "thread-per-entry",     # I past the stages
    (24, 32, 96, (96, 50, 0, 1), 72, False, 0): "ring",  # R = 72, in chunks of 32
    (8, 16, 24, tuple(range(24)) * 60, 5, False, 0): "ring",   # subjects past the persistent grid
}
# F1 at half width at the edges of its tensor-core ring: (K, I, C, R,
# offset of the slab's start in elements) -> its variant with a bfloat16 or
# float16 slab and Vg; R 1-8, I below, at and past an m-tile, C below and
# past a k-step, I * R whole 16-byte packs of the outputs or not
F1_HALF_EDGES = {
    (7, 56, 128, 5, 0): "ring-mma",                   # the main path's
    (58112, 56, 128, 5, 0): "ring-mma",               # its largest bucket, past the grid
    (1, 1, 1, 1, 0): "ring-mma-element-copies",       # one subject of one row and column
    (3, 15, 15, 2, 0): "ring-mma-element-copies",     # below an m-tile and a k-step
    (4, 17, 128, 3, 0): "ring-mma",                   # one row past an m-tile
    (6, 18, 128, 4, 0): "ring-mma",                   # the rsvd cores' rows
    (5, 64, 130, 6, 0): "ring-mma-element-copies",    # whole m-tiles; C past a k-step
    (5, 56, 128, 7, 3): "ring-mma-element-copies",    # the slab's start not 16-byte aligned
    (2, 64, 128, 8, 0): "ring-mma",                   # R = 8, the whole n-tile
}
# F4 and F3 at the edges of their variants: (K, I, C, R, offset of the
# slab's start in elements) -> the (F4, F3) variants taken with a float32,
# a float64 and a half (bfloat16, float16) slab; every variant of each is
# reached at each of the four dtypes
_RING2 = ("ring", "ring")
_COPIES2 = ("ring-element-copies",) * 2
_SMALL2 = ("row-warp", "thread-per-column")   # the one-block-a-subject designs
SLAB_EDGES = {
    (7, 56, 128, 5, 0): dict(f32=_RING2, f64=_RING2, half=("ring-mma", "ring")),  # the main path's
    (1000, 40, 16, 5, 0): dict(f32=_RING2, f64=_RING2,
                               half=("ring-mma", "ring")),        # subjects past the grid
    # rows not whole 16-byte runs (f32, half); I past a row tile and an m-tile
    (7, 57, 130, 5, 0): dict(f32=_COPIES2, f64=_RING2,
                             half=("ring-mma-element-copies", "ring-element-copies")),
    (5, 33, 36, 8, 1): dict(f32=_COPIES2, f64=_COPIES2,           # the slab's start not
                            half=("ring-mma-element-copies", "ring-element-copies")),  # aligned
    (1, 1, 5, 1, 0): dict(f32=_SMALL2, f64=_SMALL2,               # one subject of one row
                          half=("ring-mma-element-copies", "thread-per-column")),
    (6, 18, 128, 5, 0): dict(f32=_SMALL2, f64=_SMALL2,            # the rsvd cores' rows:
                             half=("ring-mma", "thread-per-column")),   # below the rings'
    (6, 37, 40, 9, 0): dict(f32=_RING2, f64=_RING2, half=_RING2),  # R past G's register owners
    (5, 33, 40, 9, 1): dict(f32=_COPIES2, f64=_COPIES2, half=_COPIES2),
    (4, 70, 64, 64, 0): dict(f32=_RING2, f64=("row-warp", "ring"), half=_RING2),  # widest tile
    (6, 19, 1024, 8, 0): dict(f32=_SMALL2, f64=_SMALL2,           # C_pad 1024, I not 16k
                              half=("ring-mma", "thread-per-column")),
    (2, 9, 1024, 40, 0): dict(f32=_SMALL2, f64=("row-warp-chunked", "thread-per-column"),
                              half=_SMALL2),
    (3, 120, 1024, 5, 0): dict(f32=_SMALL2, f64=_SMALL2, half=_SMALL2),   # too large a subject
    (2, 900, 16, 64, 0): dict(f32=("row-warp-chunked", "thread-per-column-chunked"),
                              f64=("row-warp-chunked", "thread-per-column-chunked"),
                              half=("row-warp-chunked", "thread-per-column-chunked")),
    (3, 9, 20, 72, 0): dict(f32=("row-warp-wide", "thread-per-column-wide"),   # R past 64
                            f64=("row-warp-wide", "thread-per-column-wide"),
                            half=("row-warp-wide", "thread-per-column-wide")),
    (2, 900, 16, 72, 0): dict(f32=("row-warp-wide-chunked", "thread-per-column-wide-chunked"),
                              f64=("row-warp-wide-chunked", "thread-per-column-wide-chunked"),
                              half=("row-warp-wide-chunked", "thread-per-column-wide-chunked")),
}
# F2 and row 7, the one-launch reductions across subjects, at their edges:
# F2 (K, I, R, offset of Q's start in elements, subject mask) and the
# variant it takes in f32; row 7 (K, R, subject mask). Masks: None, "some"
# (every third subject and the first masked) or "all".
F2_EDGES = {
    (58112, 56, 5, 0, "some"): "ring",          # the main path's largest CC bucket
    (7, 56, 5, 0, "some"): "ring",              # fewer subjects than runs
    (1, 56, 5, 0, None): "ring",                # one subject
    (2049, 56, 5, 0, "some"): "ring",           # runs past the last subject
    (9, 56, 1, 0, "some"): "ring",              # R = 1: 128 groups a block
    (9, 20, 11, 0, None): "ring",               # R = 11: one group a block
    (11, 56, 5, 1, None): "ring-element-copies",   # Q's start not 16-byte aligned
    (13, 3, 5, 0, "some"): "ring-element-copies",  # [I, R] tiles not whole packs
    (9, 1, 11, 0, "some"): "ring-element-copies",  # partials read directly
    (9, 30, 72, 0, "some"): "chunked",          # R = 72: R*R past the block
    (5, 4000, 8, 0, None): "chunked",           # I past the ring's stages, rows in tiles
    (3, 1452, 5, 0, "some"): "ring",            # one group's stages take all 227 KB
    (3, 29055, 1, 0, None): "chunked",          # one tile takes all 227 KB (f64: in tiles)
    (3, 29056, 1, 0, "some"): "chunked",        # row tiles that take all 227 KB
    (9, 56, 5, 0, "all"): "ring",               # every subject masked
}
# The three F2 launches that take all 232,448 bytes of shared memory. At
# R = 1 that needs I near 29,000: a sum whose f32 rounding in the kernel's
# order (the parent's) and in cuBLAS's differ by more than the tolerance.
# Their operands are small integers, exact in f32 and f64 in any order, and
# the kernel must equal its plain version exactly.
F2_FULL_SMEM = {(3, 1452, 5, 0, "some"), (3, 29055, 1, 0, None), (3, 29056, 1, 0, "some")}
# rows 9 and 10 (K, R, C, offset of Yc's and YkV's starts in elements,
# subject mask) and the variant row 9 takes in f32 (row 10 has one)
MODE3_EDGES = {
    (7, 5, 128, 0, "some"): "ring",                 # the main path's shape
    (5, 5, 17, 0, None): "ring-element-copies",     # rows not whole 16-byte runs
    (3, 72, 1024, 0, "some"): "thread-per-entry",   # R = 72 at C_pad = 1024
    (5, 5, 128, 1, "some"): "ring-element-copies",  # starts not 16-byte aligned
    (3000, 5, 128, 0, "some"): "ring",              # groups past the persistent grid
    (300000, 5, 4, 0, "some"): "ring",              # row 10's outputs past one wave
    (1, 5, 128, 0, None): "ring",                   # one subject
    (4, 40, 128, 0, "all"): "ring",                 # R = 40, one subject a group
}
MODE1_REUSE_EDGES = [(58112, 5, "some"), (7, 5, "some"), (1, 5, None), (2049, 5, "some"),
                     (9, 1, None), (9, 72, "some"), (9, 5, "all")]
XKV_EDGES = {
    (48, 128, 136, (115,) * 30 + (0,), 5, False, 0): "ring",   # the main path's geometry
    (8, 16, 64, (64, 0, 10), 5, True, 0): "ring",   # a row segment of length N, empty rows, an
                                                     # empty subject
    (5, 9, 13, (13, 2, 0, 7, 5), 5, False, 0): "ring-element-copies",   # runs not whole packs
    (8, 16, 24, (24, 3, 0, 9), 5, False, 1): "ring-element-copies",    # vals' start unaligned
    (40, 128, 3000, (3000, 17, 0), 5, False, 0): "thread-per-entry",  # N past the stages
    (1000, 32, 40, (40, 0, 33), 8, False, 0): "thread-per-entry",     # I past the stages
    (8, 8, 24, (24, 3, 0, 9), 72, False, 0): "ring",  # R = 72, in chunks of 32
    (8, 16, 24, tuple(range(24)) * 420, 5, False, 0): "ring",   # subjects past the walkers
}
# P1 (gram_inv_sqrt) over Grams of each kind at each rank, and at the main
# path's bucket sizes: (R, K) for every kind, then (R, K, kind) at K past
# cuSOLVER's batch limit and past the block variants' grids, so that a block
# takes many subjects (every seventh Gram zero there, as padded subjects).
# The ranks reach each design's edges: a thread a subject up to 8, a warp a
# subject from 9 (one pair short of a whole round at 9, 33 and 65, two
# columns a lane past 32) to 64, a block past it. R = 72 and 130 stop at K
# 16,385 and 1,000: their plain version on the CPU would take minutes at
# 58,112.
P1_RANKS = (1, 2, 5, 8, 9, 10, 16, 20, 32, 33, 40, 64, 65, 72, 130)
P1_SMALL_K = (1, 37)
P1_LARGE = tuple((R, K, 10.0) for R in (1, 2, 5, 8, 40) for K in (16385, 58112)) + (
    (10, 58112, 10.0), (20, 58112, 10.0),
    (72, 16385, 10.0), (130, 1000, 10.0), (5, 58112, 100.0))
P1_PAPER_RANKS = (10, 20, 40)   # the paper's Figure 5 ranks past the main path's 5
EIGH_BATCH = 16384      # the most 5x5 Grams one cuSOLVER eigh was seen to take on an H100
# P2 (tridiag_solve) at its edges: N = 2 and 3; 33, one past a chunk of 32
# rows and a warp; 64, the most the direct solve takes, and 65, one past it;
# 1,025 and 4,097 (3 and 9 units of 16 chunks); 116,225 and 464,900,
# W's rows at choa 0.25 and at the full CHOA (level 2 past the direct solve;
# more units than a grid's blocks); R = 1, 5 and 40 (past a chunk's 16
# column threads); lam = 0, 0.1, 5 and 70 (rho / lam = 0.01); rho a device
# scalar
P2_N = (2, 3, 33, 64, 65, 1025, 4097, 116225, 464900)
P2_R = (1, 5, 40)
P2_LAM = (0.0, 0.1, 5.0, 70.0)
P2_RHO = 0.7
# the constrained fits of phase 3: ADMM nonnegativity on V and W, and sparse
# phenotypes (nonneg + l1 on V) with temporally smooth subject weights (W),
# the latter through P2
CONSTRAINED = {"admm": {"v": "nonneg_admm", "w": "nonneg_admm"},
               "l1-smooth": {"v": "nonneg+l1:0.1", "w": "smooth:0.1"}}
CONSTRAINED_ROUTES = {"auto": "cc", "staged-scoo": "scoo"}   # route -> format
# the compression path (``compress="rsvd"``): its core shapes in phase 2, the
# rsvd cores of a small dataset with thin subjects (fewer rows than S) and
# padded ones, at the default spec (S = 2R + 8 = 18 at R = 5) and at
# rsvd:10:6 (S = 16 at R = 4), C_pad 128 as choa's
CORE_SPECS = (("rsvd", 5), ("rsvd:10:6", 4))
CORE_DATA = dict(n_subjects=301, n_cols=700, max_rows=64, avg_nnz_per_subject=60, seed=11)
COMPRESS = "rsvd"       # phase 3's spec at rank 5: S = 18
# the routes phase 3 compresses on: route -> (format, backend)
COMPRESS_ROUTES = {"auto": ("cc", "auto"), "staged": ("cc", "staged"),
                   "staged-scoo": ("scoo", "staged")}
# the serving layer (``repro_torch.launch.stream``): the first STREAM_LIMIT
# payloads of choa 0.25's synthetic stream (warm fraction 0.6) through a
# service per (backend, format, batch slots); the kernels each dispatch must
# launch there (CC batches on auto take F1 and F4; SCOO batches on staged
# rows 11 and 12, then rows 5 and 10); every polar takes P1
STREAM_LIMIT = 4096
STREAM_RUNS = (("auto", "cc", 8), ("staged", "scoo", 8), ("auto", "cc", 64))
ON_STREAM = {"auto": ("fused_procrustes_b", "fused_ykv") + ("gram_inv_sqrt",),
             "staged": ("scoo_xk_times_v", "scoo_project", "ykv", "mode3_reuse",
                        "gram_inv_sqrt")}
STREAM_F64 = 256        # payloads of the f64 choa 0.002 replay, card against CPU
SOURCES = ("fused", "staged", "scoo", "gather_matmul", "polar", "tridiag")
FUSED = ("fused_procrustes_b", "fused_mode1_xkv", "fused_mode2_compact", "fused_ykv")
STAGED = ("ykv", "mode1", "mode1_reuse", "mode2_compact", "mode3", "mode3_reuse")
SCOO = ("scoo_xk_times_v", "scoo_project")
P1 = ("gram_inv_sqrt",)      # the port's own kernel: the polar's inverse root
P2 = ("tridiag_solve",)      # the port's own kernel: the smooth prox's solve
ALL = FUSED + STAGED + SCOO + ("gather_matmul",) + P1 + P2
STAGED_PATH = ("ykv", "mode1_reuse", "mode2_compact", "mode3_reuse")
CORE_KERNELS = FUSED + STAGED_PATH      # F1-F4 and rows 5, 7, 8 and 10: the core ALS's
# the kernels a core iteration launches on each compressed route: the cores
# are CC buckets whatever the format they were compressed from
ON_CORES = {"auto": FUSED + P1, "staged": STAGED_PATH + P1, "staged-scoo": STAGED_PATH + P1}
# every CUDA route takes P1 in its polar step, the torch route too
ON_MAIN_PATH = {"auto": FUSED + P1, "staged": STAGED_PATH + P1,
                "staged-scoo": SCOO + STAGED_PATH + P1, "auto-scoo": ("fused_mode1_xkv",) + P1,
                "scoo-scoo": P1, "torch": P1}
SCAN_ROUTES = ("auto", "staged", "staged-scoo")   # the routes phase 3 runs under scan
REPLACES = {
    "fused_procrustes_b": "src/repro/kernels/fused.py:132",
    "fused_mode1_xkv": "src/repro/kernels/fused.py:196",
    "fused_mode2_compact": "src/repro/kernels/fused.py:261",
    "fused_ykv": "src/repro/kernels/fused.py:338",
    "ykv": "src/repro/kernels/ykv.py:34",
    "mode1": "src/repro/kernels/mttkrp_mode1.py:49",
    "mode1_reuse": "src/repro/kernels/mttkrp_mode1.py:98",
    "mode2_compact": "src/repro/kernels/mttkrp_mode2.py:35",
    "mode3": "src/repro/kernels/mttkrp_mode3.py:49",
    "mode3_reuse": "src/repro/kernels/mttkrp_mode3.py:93",
    "scoo_xk_times_v": "src/repro/kernels/scoo.py:249",
    "scoo_project": "src/repro/kernels/scoo.py:313",
    "gather_matmul": "src/repro/kernels/gather_matmul.py:42",
    # no TPU kernel: the reference's jnp.linalg.eigh in its compiled program
    "gram_inv_sqrt": "src/repro/core/procrustes.py:40",
    # no TPU kernel: the reference's lax.linalg.tridiagonal_solve in prox_smooth
    "tridiag_solve": "src/repro/core/constraints.py:149",
}


def free_cached(label: str) -> None:
    """Drop the scan engine's kept chunks (``engine.CHUNKS``), collect
    garbage and release the caching allocator's free blocks
    (``torch.cuda.empty_cache``), then print what stays allocated: each
    CUDA graph captures into a private pool, which cannot take the free
    blocks of the others, and no memory can be freed while a capture
    runs."""
    import gc
    import torch

    from repro_torch.core import engine

    engine.clear_chunk_cache()       # the graphs kept for the next fit on each data
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[memory] after {label}: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved", flush=True)


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def within(got, want, dtype_is_f64: bool, scale=None) -> tuple:
    """(max |got - want|, ok) under the stated tolerance. ``scale`` (the
    SCOO kernels: the largest running sum of |contribution|) replaces the
    output's largest magnitude and applies in f64 too."""
    import torch

    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if scale is None:
        scale = 1.0 if dtype_is_f64 else (
            max(1.0, float(want.abs().max())) if want.numel() else 1.0)
    tol = 1e-12 if dtype_is_f64 else 1e-6
    ok = bool(torch.all((got - want).abs() <= tol * scale + tol * want.abs()))
    return err, ok


def prefix_scale(vals, idx, M) -> float:
    """The largest running sum of |vals[k,n] * M[k, idx[k,n], :]| along a
    subject's triplets: what a prefix-sum difference rounds against."""
    import torch

    g = torch.gather(M.double(), 1, idx.long()[..., None].expand(-1, -1, M.shape[-1]))
    run = torch.cumsum((g * vals.double()[..., None]).abs(), 1)
    return max(1.0, float(run.max())) if run.numel() else 1.0


def scoo_xkv(vals, rows, lcols, Vg, i_pad, row_ends):
    from repro_torch.kernels import scoo

    return scoo.scoo_xk_times_v(vals, rows, lcols, Vg, i_pad, row_ends=row_ends)


def scoo_xkv_plain(vals, rows, lcols, Vg, i_pad, row_ends):
    from repro_torch.kernels import scoo

    return scoo.xk_times_v_plain(vals, rows, lcols, Vg, i_pad, row_ends=row_ends)


def scoo_proj(vals, rows, lcols, Q, c_pad, cperm, col_ends):
    from repro_torch.kernels import scoo

    return scoo.scoo_project(vals, rows, lcols, Q, c_pad, cperm=cperm, col_ends=col_ends)


def scoo_proj_plain(vals, rows, lcols, Q, c_pad, cperm, col_ends):
    from repro_torch.kernels import scoo

    return scoo.project_plain(vals, rows, lcols, Q, c_pad, cperm=cperm, col_ends=col_ends)


def p1_plain(G):
    """P1's plain version over runs of at most ``EIGH_BATCH`` Grams (the
    function is per Gram; cuSOLVER refuses larger batches). Many Grams
    past R = 8 go to the CPU's LAPACK: cuSOLVER solves those one at a time."""
    import torch
    from repro_torch.kernels import polar

    if G.shape[-1] > 8 and G.shape[0] > 1000:
        return polar.gram_inv_sqrt_plain(G.cpu()).to(G.device)
    if G.shape[0] <= EIGH_BATCH:
        return polar.gram_inv_sqrt_plain(G)
    return torch.cat([polar.gram_inv_sqrt_plain(g) for g in G.split(EIGH_BATCH)])


def p1_library(G):
    """One call's worth of PyTorch for P1's function as the port computed
    it before P1: ``torch.linalg.eigh`` in runs of ``EIGH_BATCH`` in G's
    dtype, then the same inverse-root algebra (timed only)."""
    import torch

    parts = [torch.linalg.eigh(g) for g in G.split(EIGH_BATCH)]
    lam, E = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    scale = torch.clamp(lam, min=0.0)
    tol = scale.amax(dim=-1, keepdim=True) * 1e-12
    inv_root = torch.where(scale > tol, torch.rsqrt(torch.maximum(scale, tol)),
                           torch.zeros_like(scale))
    return (E * inv_root[:, None, :]) @ E.transpose(1, 2)


def kernels() -> dict:
    """name -> (wrapper, plain version, source) for the fifteen kernels."""
    from repro_torch.kernels import (fused, gather_matmul, mttkrp_mode1, mttkrp_mode2,
                                     mttkrp_mode3, polar, tridiag, ykv)

    f, s = "src/repro_torch/csrc/fused.cu", "src/repro_torch/csrc/staged.cu"
    sc, g = "src/repro_torch/csrc/scoo.cu", "src/repro_torch/csrc/gather_matmul.cu"
    return {
        "fused_procrustes_b": (fused.fused_procrustes_b, fused.procrustes_b_plain, f),
        "fused_mode1_xkv": (fused.fused_mode1_xkv, fused.mode1_xkv_plain, f),
        "fused_mode2_compact": (fused.fused_mode2_compact, fused.mode2_compact_plain, f),
        "fused_ykv": (fused.fused_ykv, fused.ykv_plain, f),
        "ykv": (ykv.ykv, ykv.ykv_plain, s),
        "mode1": (mttkrp_mode1.mode1, mttkrp_mode1.mode1_plain, s),
        "mode1_reuse": (mttkrp_mode1.mode1_reuse, mttkrp_mode1.mode1_reuse_plain, s),
        "mode2_compact": (mttkrp_mode2.mode2_compact, mttkrp_mode2.mode2_compact_plain, s),
        "mode3": (mttkrp_mode3.mode3, mttkrp_mode3.mode3_plain, s),
        "mode3_reuse": (mttkrp_mode3.mode3_reuse, mttkrp_mode3.mode3_reuse_plain, s),
        "scoo_xk_times_v": (scoo_xkv, scoo_xkv_plain, sc),
        "scoo_project": (scoo_proj, scoo_proj_plain, sc),
        "gather_matmul": (gather_matmul.gather_matmul, gather_matmul.gather_matmul_plain, g),
        "gram_inv_sqrt": (polar.gram_inv_sqrt, p1_plain, "src/repro_torch/csrc/polar.cu"),
        "tridiag_solve": (tridiag.tridiag_solve, tridiag.tridiag_solve_plain,
                          "src/repro_torch/csrc/tridiag.cu"),
    }


def launches() -> dict:
    from repro_torch.launch.decompose import kernel_launches

    return dict(kernel_launches())


def reset_launches() -> None:
    from repro_torch.launch.decompose import reset_launches as reset

    reset()


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
    from repro_torch.kernels import _build
    from repro_torch.launch.decompose import LIBRARIES

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:     # one nvcc per source
        libs = list(pool.map(_build.build, SOURCES))
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for src, lib in zip(SOURCES, libs):
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {src}: {line.strip()}")
    for module in LIBRARIES:
        module.LIB.lib()


def kernel_args(b, H, V, W, Q) -> dict:
    """The ten kernels' operands for one bucket, as the backends pass them."""
    import torch
    from repro_torch.kernels.common import fold_subject_mask

    Vg = b.gather_v(V)
    Wr = W[b.subject_ids.long()]
    Wb = fold_subject_mask(Wr, b.subject_mask)
    Yc = b.project(Q)
    YkV = torch.bmm(Yc, Vg)
    return {   # the reductions take the mask, as the backends pass it
        "fused_procrustes_b": (b.vals, Vg, Wb, H),
        "fused_mode1_xkv": (Q, b.xk_times_v(V, Vg), Wr, b.subject_mask),
        "fused_mode2_compact": (b.vals, Q, H, Wb, b.col_mask),
        "fused_ykv": (b.vals, Q, Vg),
        "ykv": (Yc, Vg),
        "mode1": (Yc, Vg, Wr, b.subject_mask),
        "mode1_reuse": (YkV, Wr, b.subject_mask),
        "mode2_compact": (Yc, H, Wb, b.col_mask),
        "mode3": (Yc, Vg, H, b.subject_mask),
        "mode3_reuse": (YkV, H, b.subject_mask),
    }


def scoo_args(b, V, Q) -> tuple:
    """Rows 11 and 12's operands for one SCOO bucket, as the staged route
    passes them, and the running-sum scale of each."""
    Vg = b.gather_v(V)
    args = {"scoo_xk_times_v": (b.vals, b.rows, b.lcols, Vg, b.i_pad, b.row_ends),
            "scoo_project": (b.vals, b.rows, b.lcols, Q, b.c_pad, b.cperm, b.col_ends)}
    scales = {"scoo_xk_times_v": prefix_scale(b.vals, b.lcols, Vg),
              "scoo_project": prefix_scale(b.vals, b.rows, Q)}
    return args, scales


def bcc_args(bcc, V) -> dict:
    """Row 13's operands: the BCC bucket and V zero-padded to whole blocks."""
    import torch

    J, R = V.shape
    J_pad = -(-J // 128) * 128
    return {"gather_matmul": (bcc.vals, bcc.blk_ids,
                              torch.cat([V, V.new_zeros((J_pad - J, R))]))}


def check_kernels(args_by_kernel, errs: dict, scales=None) -> None:
    """Each kernel on the card against its plain version on the same inputs;
    each call must launch its kernel once."""
    import torch

    table = kernels()
    scales = scales or {}
    for name, args in args_by_kernel.items():
        wrapper, plain, _ = table[name]
        f64 = args[0].dtype == torch.float64
        before = launches()[name]
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if launches()[name] != before + 1:
            fail(f"{name} did not launch its kernel")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{name}: shape {tuple(g.shape)} != plain {tuple(w.shape)}")
            err, ok = within(g, w, f64, scales.get(name))
            if not ok:
                fail(f"{name} ({'f64' if f64 else 'f32'}, shape "
                     f"{tuple(args[0].shape)}): max |kernel - plain| = {err:.3e}")
            e, s = errs.get(name, (0.0, 0.0))
            errs[name] = (max(e, err), max(s, float(w.abs().max()) if w.numel() else 0.0))


def check_empty(dtype, dev) -> None:
    """A K=0 bucket: zeros of the right shapes through every wrapper, and
    no launch."""
    import torch

    z = dict(dtype=dtype, device=dev)
    I, C, R = 8, 16, 5
    vals, Vg, Q = (torch.zeros(s, **z) for s in ((0, I, C), (0, C, R), (0, I, R)))
    Yc, YkV, Wb = (torch.zeros(s, **z) for s in ((0, R, C), (0, R, R), (0, R)))
    H, cm, m = torch.eye(R, **z), torch.zeros((0, C), **z), torch.zeros((0,), **z)
    args = {
        "fused_procrustes_b": (vals, Vg, Wb, H), "fused_mode1_xkv": (Q, Q, Wb),
        "fused_mode2_compact": (vals, Q, H, Wb, cm), "fused_ykv": (vals, Q, Vg),
        "ykv": (Yc, Vg), "mode1": (Yc, Vg, Wb), "mode1_reuse": (YkV, Wb),
        "mode2_compact": (Yc, H, Wb, cm), "mode3": (Yc, Vg, H, m),
        "mode3_reuse": (YkV, H, m),
    }
    shapes = {
        "fused_procrustes_b": [(0, I, R), (0, I, R)], "fused_mode1_xkv": [(R, R)],
        "fused_mode2_compact": [(0, C, R)], "fused_ykv": [(0, R, R)],
        "ykv": [(0, R, R)], "mode1": [(R, R)], "mode1_reuse": [(R, R)],
        "mode2_compact": [(0, C, R)], "mode3": [(0, R)], "mode3_reuse": [(0, R)],
    }
    N, ix = 8, dict(dtype=torch.int32, device=dev)
    v0, i0 = torch.zeros((0, N), **z), torch.zeros((0, N), **ix)
    args.update({
        "scoo_xk_times_v": (v0, i0, i0, Vg, I, torch.zeros((0, I), **ix)),
        "scoo_project": (v0, i0, i0, Q, C, i0, torch.zeros((0, C), **ix)),
        "gather_matmul": (torch.zeros((0, I, 2, 128), **z), torch.zeros((0, 2), **ix),
                          torch.zeros((256, R), **z)),
    })
    args["gram_inv_sqrt"] = (torch.zeros((0, R, R), **z),)
    args["tridiag_solve"] = (torch.zeros((N, 0), **z), torch.ones((), **z), 0.1)  # no column
    shapes.update({"scoo_xk_times_v": [(0, I, R)], "scoo_project": [(0, R, C)],
                   "gather_matmul": [(0, I, R)], "gram_inv_sqrt": [(0, R, R)],
                   "tridiag_solve": [(N, 0)]})
    before = launches()
    for name, (wrapper, _, _) in kernels().items():
        out = wrapper(*args[name])
        out = list(out) if isinstance(out, tuple) else [out]
        if [tuple(o.shape) for o in out] != shapes[name] or any(o.abs().sum() for o in out):
            fail(f"K=0 bucket: {name} gave wrong shapes or non-zero output")
    if launches() != before:
        fail("K=0 bucket launched a kernel")


def scoo_dataset(name: str):
    """The reference's three SCOO test datasets (``tests/test_scoo.py``)."""
    import numpy as np
    from repro_torch.sparse import IrregularCOO, SubjectCOO, random_irregular

    if name == "random-odd":
        return random_irregular(n_subjects=13, n_cols=37, max_rows=9,
                                avg_nnz_per_subject=18, seed=0, nonneg=False)
    if name == "random-padded":
        return random_irregular(n_subjects=11, n_cols=50, max_rows=12,
                                avg_nnz_per_subject=25, seed=3)
    rng, n_cols = np.random.default_rng(7), 29

    def sub(n_rows, nnz):
        cells = rng.choice(n_rows * n_cols, size=nnz, replace=False)
        return SubjectCOO(rows=(cells // n_cols).astype(np.int32),
                          cols=(cells % n_cols).astype(np.int32),
                          vals=rng.standard_normal(nnz), n_rows=n_rows, n_cols=n_cols)

    empty = SubjectCOO(rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
                       vals=np.zeros(0), n_rows=3, n_cols=n_cols)
    return IrregularCOO([sub(9, 25), empty, sub(1, 1), sub(200, 5), sub(13, 40),
                         sub(6, 11)], n_cols)


def check_sparse_kernels(dtype, dev, errs: dict) -> None:
    """Rows 11 and 12 over the three SCOO datasets at R = 1, 5, 72 with
    padded subjects and over explicit zero-valued triplets; row 13 over
    the BCC geometries."""
    import numpy as np
    import torch
    from repro_torch.core import bucketize, to_block_bucket
    from repro_torch.sparse import random_irregular

    for name in SCOO_DATA:
        data = scoo_dataset(name)
        bt = bucketize(data, format="scoo", dtype=dtype, device=dev, col_align=4,
                       max_buckets=3, subject_align=4)
        for R in (1, 5, 72):
            rng = np.random.default_rng(R)
            V = torch.tensor(rng.standard_normal((data.n_cols, R)), dtype=dtype, device=dev)
            for b in bt.buckets:
                Q = torch.tensor(rng.standard_normal((b.kb, b.i_pad, R)), dtype=dtype,
                                 device=dev)
                args, scales = scoo_args(b, V, Q)
                check_kernels(args, errs, scales)
    # stored zeros inside the true nnz: what follows them must still count
    z, ix = dict(dtype=dtype, device=dev), dict(dtype=torch.int32, device=dev)
    vals = torch.tensor([[0.0, 0.0, 2.0, 3.0]], **z)
    rows, lcols = torch.tensor([[0, 0, 1, 2]], **ix), torch.tensor([[0, 1, 2, 3]], **ix)
    ones = torch.ones((1, 4, 2), **z)
    check_kernels({"scoo_xk_times_v": (vals, rows, lcols, ones, 4,
                                       torch.tensor([[2, 3, 4, 4]], **ix)),
                   "scoo_project": (vals, rows, lcols, ones, 4, lcols,
                                    torch.tensor([[1, 2, 3, 4]], **ix))}, errs)
    for seed, J, R in BCC_GEOMETRIES:
        data = random_irregular(n_subjects=9, n_cols=J, max_rows=12,
                                avg_nnz_per_subject=40, seed=seed)
        V = torch.tensor(np.random.default_rng(seed).standard_normal((J, R)), **z)
        for b in bucketize(data, max_buckets=2, dtype=dtype, device=dev).buckets:
            check_kernels(bcc_args(to_block_bucket(b, J), V), errs)


def scoo_arrays(n_rows, C, N, nnz, seed, one_col=False, one_row=False) -> dict:
    """SCOO arrays of one bucket, laid out as ``bucketize`` lays them out:
    subject k's nnz[k] triplets sorted by (row, column), pads past them,
    ``row_ends`` the row segments' ends, ``cperm`` the stable column order
    and ``col_ends`` its segment ends. ``one_col``/``one_row`` put every
    triplet of a subject in column 0 / row 0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Kb = len(nnz)
    out = dict(vals=np.zeros((Kb, N)), rows=np.zeros((Kb, N), np.int32),
               lcols=np.zeros((Kb, N), np.int32), row_ends=np.zeros((Kb, n_rows), np.int32),
               cperm=np.tile(np.arange(N, dtype=np.int32), (Kb, 1)),
               col_ends=np.zeros((Kb, C), np.int32))
    for k, n in enumerate(nnz):
        r = rng.integers(0, n_rows, n)
        c = np.zeros(n, np.int64) if one_col else rng.integers(0, C, n)
        if one_row:
            r[:] = 0
        o = np.lexsort((c, r))
        out["vals"][k, :n] = rng.standard_normal(n)
        out["rows"][k, :n], out["lcols"][k, :n] = r[o], c[o]
        out["row_ends"][k] = np.cumsum(np.bincount(r, minlength=n_rows))
        out["cperm"][k, :n] = np.argsort(c[o], kind="stable")
        out["col_ends"][k] = np.cumsum(np.bincount(c, minlength=C))
    return out


def offset_copy(a, dtype, dev, offset: int):
    """``a`` on the card, starting ``offset`` elements past an allocation's
    (16-byte aligned) start."""
    import torch

    t = torch.empty(a.size + offset, dtype=dtype, device=dev)[offset:].view(a.shape)
    return t.copy_(torch.as_tensor(a, dtype=dtype))


def check_variant_edges(dtype, dev, errs: dict) -> set:
    """Rows 5, 8, 11 and 12 at the edges of their variants against their
    plain versions; in f32 each shape must take the variant stated. Returns
    the (kernel, variant) pairs reached."""
    import numpy as np
    import torch
    from repro_torch.kernels import mttkrp_mode2, scoo, ykv

    f32, seen = dtype == torch.float32, set()
    for (K, R, C, offset), want in YKV_EDGES.items():
        rng = np.random.default_rng(K + R + C + offset)
        Yc = offset_copy(rng.standard_normal((K, R, C)), dtype, dev, offset)
        Vg = torch.tensor(rng.standard_normal((K, C, R)), dtype=dtype, device=dev)
        got = ykv.ykv_variant(Yc, Vg)
        if f32 and got != want:
            fail(f"ykv at K={K} R={R} C={C} offset {offset} took {got}, want {want}")
        seen.add(("ykv", got))
        check_kernels({"ykv": (Yc, Vg)}, errs)
    for (K, R, C, offset), want in MODE2_EDGES.items():
        rng = np.random.default_rng(K + R + C + offset)
        Yc = offset_copy(rng.standard_normal((K, R, C)), dtype, dev, offset)
        H, Wb = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                 for s in ((R, R), (K, R)))
        cm = torch.tensor(rng.random((K, C)) < 0.7, dtype=dtype, device=dev)
        sm = torch.ones(K, dtype=dtype, device=dev)
        sm[0] = 0
        got = mttkrp_mode2.mode2_compact_variant(Yc, cm)
        if f32 and got != want:
            fail(f"mode2_compact at K={K} R={R} C={C} offset {offset} took {got}, want {want}")
        seen.add(("mode2_compact", got))
        check_kernels({"mode2_compact": (Yc, H, Wb, cm, sm)}, errs)
    for (n_rows, C, N, nnz, R, one_col, offset), want in PROJECT_EDGES.items():
        a = scoo_arrays(n_rows, C, N, nnz, seed=N + R, one_col=one_col)
        vals = offset_copy(a["vals"], dtype, dev, offset)
        rows, lcols, cperm, ends = (torch.tensor(a[k], device=dev)
                                    for k in ("rows", "lcols", "cperm", "col_ends"))
        Q = torch.tensor(np.random.default_rng(R).standard_normal((len(nnz), n_rows, R)),
                         dtype=dtype, device=dev)
        got = scoo.scoo_project_variant(vals, rows, lcols, Q, C, cperm=cperm, col_ends=ends)
        if f32 and got != want:
            fail(f"scoo_project at I={n_rows} C={C} N={N} R={R} offset {offset} took {got}, "
                 f"want {want}")
        seen.add(("scoo_project", got))
        check_kernels({"scoo_project": (vals, rows, lcols, Q, C, cperm, ends)}, errs,
                      {"scoo_project": prefix_scale(vals, rows, Q)})
    for (n_rows, C, N, nnz, R, one_row, offset), want in XKV_EDGES.items():
        a = scoo_arrays(n_rows, C, N, nnz, seed=N + R, one_row=one_row)
        vals = offset_copy(a["vals"], dtype, dev, offset)
        rows, lcols, ends = (torch.tensor(a[k], device=dev) for k in ("rows", "lcols", "row_ends"))
        Vg = torch.tensor(np.random.default_rng(R).standard_normal((len(nnz), C, R)),
                          dtype=dtype, device=dev)
        got = scoo.scoo_xk_times_v_variant(vals, rows, lcols, Vg, n_rows, row_ends=ends)
        if f32 and got != want:
            fail(f"scoo_xk_times_v at I={n_rows} C={C} N={N} R={R} offset {offset} took {got}, "
                 f"want {want}")
        seen.add(("scoo_xk_times_v", got))
        check_kernels({"scoo_xk_times_v": (vals, rows, lcols, Vg, n_rows, ends)}, errs,
                      {"scoo_xk_times_v": prefix_scale(vals, lcols, Vg)})
    return seen


def check_slab_edges(dev, errs: dict) -> None:
    """F4 and F3 at the edges of their variants (``SLAB_EDGES``) with a
    float32, float64, bfloat16 and float16 slab against their plain
    versions (f64 to 1e-12, the others to the f32 bound), twice with the
    same bits; each shape must take the variant stated, and every variant
    of each kernel must be reached at each dtype."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused

    queries = (("fused_ykv", fused.ykv_fused_variant, fused.F4_VARIANTS),
               ("fused_mode2_compact", fused.mode2_compact_fused_variant, fused.F3_VARIANTS))
    table = kernels()
    for dtype, key in ((torch.float32, "f32"), (torch.float64, "f64"),
                       (torch.bfloat16, "half"), (torch.float16, "half")):
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        seen = {name: set() for name, _, _ in queries}
        for (K, I, C, R, offset), want in SLAB_EDGES.items():
            rng = np.random.default_rng(K + I + C + R + offset)
            vals = offset_copy(rng.standard_normal((K, I, C)), dtype, dev, offset)
            Vg = torch.tensor(rng.standard_normal((K, C, R)), device=dev).to(dtype)
            Q, H, Wb = (torch.tensor(rng.standard_normal(s), dtype=acc, device=dev)
                        for s in ((K, I, R), (R, R), (K, R)))
            Wb[::3] = 0                                   # masked subjects, folded in
            cm = torch.tensor(rng.random((K, C)) < 0.7, dtype=acc, device=dev)
            args = {"fused_ykv": (vals, Q, Vg), "fused_mode2_compact": (vals, Q, H, Wb, cm)}
            for (name, query, _), stated in zip(queries, want[key]):
                got = query(vals, R)
                if got != stated:
                    fail(f"{name} ({dtype}) at K={K} I={I} C={C} R={R} offset {offset} took "
                         f"{got}, want {stated}")
                seen[name].add(got)
                check_kernels({name: args[name]}, errs)
                first = table[name][0](*args[name])
                if not torch.equal(bits(table[name][0](*args[name])), bits(first)):
                    fail(f"{name} ({dtype}) at K={K} I={I} C={C} R={R} gave other bits on "
                         f"the same input")
                if name == "fused_mode2_compact" and (first[::3].any() or first[cm == 0].any()):
                    fail(f"{name} ({dtype}) at K={K} I={I} C={C} R={R}: a masked subject or "
                         f"column is not zero")
        for name, _, variants in queries:
            half = key == "half"
            reach = {v for v in variants if half or "mma" not in v}
            if seen[name] != reach:
                fail(f"{name} ({dtype}) did not reach {sorted(reach - seen[name])}")


def check_f1_half_edges(dev, errs: dict) -> None:
    """F1 at bfloat16 and float16 at the edges of its tensor-core ring
    (``F1_HALF_EDGES``) against its plain version (XkV and B to the f32
    bound), every third subject masked (its B zero), twice with the same
    bits; each shape must take the variant stated, and both variants must
    be reached at each dtype."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused

    for dtype in (torch.bfloat16, torch.float16):
        seen = set()
        for (K, I, C, R, offset), want in F1_HALF_EDGES.items():
            rng = np.random.default_rng(K + I + C + R + offset)
            vals = offset_copy(rng.standard_normal((K, I, C)), dtype, dev, offset)
            Vg = torch.tensor(rng.standard_normal((K, C, R)), device=dev).to(dtype)
            Wb, H = (torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
                     for s in ((K, R), (R, R)))
            Wb[::3] = 0
            got = fused.procrustes_b_variant(vals, R)
            if got != want:
                fail(f"fused_procrustes_b ({dtype}) at K={K} I={I} C={C} R={R} offset "
                     f"{offset} took {got}, want {want}")
            seen.add(got)
            args = (vals, Vg, Wb, H)
            check_kernels({"fused_procrustes_b": args}, errs)
            first = fused.fused_procrustes_b(*args)
            again = fused.fused_procrustes_b(*args)
            if not all(torch.equal(bits(x), bits(y)) for x, y in zip(first, again)):
                fail(f"fused_procrustes_b ({dtype}) at K={K} I={I} C={C} R={R} gave other "
                     f"bits on the same input")
            if first[1][::3].any():
                fail(f"fused_procrustes_b ({dtype}) at K={K} I={I} C={C} R={R}: a masked "
                     f"subject's B is not zero")
        if seen != {"ring-mma", "ring-mma-element-copies"}:
            fail(f"fused_procrustes_b ({dtype}) reached only {sorted(seen)} at half width")


def reduction_mask(K: int, kind, dtype, dev):
    """A subject mask of F2_EDGES / MODE1_REUSE_EDGES: None, "some" (the
    first and every third subject masked) or "all"."""
    import torch

    if kind is None:
        return None
    m = torch.ones(K, dtype=dtype, device=dev)
    m[:: 1 if kind == "all" else 3] = 0
    return m


def bits(t):
    """A float tensor's bits, for comparisons that must be exact."""
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def check_reduction_edges(dtype, dev, errs: dict) -> set:
    """F2 and row 7 at their edges against their plain versions. Two more
    calls on the same input must give the first call's bits, and so must a
    call on the largest bucket after the smaller ones (each launch leaves its
    ticket counter at 0 for the next, whatever its K). In f32 each F2 shape
    must take the variant stated. Returns the (kernel, variant) pairs
    reached."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused

    f32, seen, largest = dtype == torch.float32, set(), {}
    table = kernels()

    def check(name, args, K):
        check_kernels({name: args}, errs)
        first = table[name][0](*args)
        for _ in range(2):
            if not torch.equal(bits(table[name][0](*args)), bits(first)):
                fail(f"{name} at K={K} gave other bits on the same input")
        if K >= largest.get(name, (0,))[0]:
            largest[name] = (K, args, first)

    for (K, I, R, offset, mk), want in F2_EDGES.items():
        rng = np.random.default_rng(K + I + R + offset)
        exact = (K, I, R, offset, mk) in F2_FULL_SMEM
        draw = (lambda sh: rng.integers(-2, 3, sh)) if exact else rng.standard_normal
        Q = offset_copy(draw((K, I, R)), dtype, dev, offset)
        XkV, Wb = (torch.tensor(draw(sh), dtype=dtype, device=dev) for sh in ((K, I, R), (K, R)))
        got = fused.mode1_xkv_variant(Q, XkV)
        if f32 and got != want:
            fail(f"fused_mode1_xkv at K={K} I={I} R={R} offset {offset} took {got}, want {want}")
        seen.add(("fused_mode1_xkv", got))
        args = (Q, XkV, Wb, reduction_mask(K, mk, dtype, dev))
        check("fused_mode1_xkv", args, K)
        if exact and not torch.equal(fused.fused_mode1_xkv(*args), fused.mode1_xkv_plain(*args)):
            fail(f"fused_mode1_xkv at K={K} I={I} R={R}: not exactly its plain version on "
                 f"integer operands")
    for K, R, mk in MODE1_REUSE_EDGES:
        rng = np.random.default_rng(K + R)
        YkV, Wb = (torch.tensor(rng.standard_normal(sh), dtype=dtype, device=dev)
                   for sh in ((K, R, R), (K, R)))
        check("mode1_reuse", (YkV, Wb, reduction_mask(K, mk, dtype, dev)), K)
    for name, (K, args, first) in largest.items():
        if not torch.equal(bits(table[name][0](*args)), bits(first)):
            fail(f"{name} at K={K} gave other bits after the smaller buckets")
    return seen


def check_mode3_edges(dtype, dev, errs: dict) -> set:
    """Rows 9 and 10 at row 9's edges against their plain versions, twice
    with the same bits, and mode3 equal to mode3_reuse of ykv bit for bit;
    in f32 each shape must take row 9's variant stated. Returns the
    (kernel, variant) pairs reached."""
    import numpy as np
    import torch
    from repro_torch.kernels import mttkrp_mode3, ykv

    f32, seen = dtype == torch.float32, set()
    for (K, R, C, offset, mk), want in MODE3_EDGES.items():
        rng = np.random.default_rng(K + R + C + offset)
        Yc = offset_copy(rng.standard_normal((K, R, C)), dtype, dev, offset)
        Vg, H = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                 for s in ((K, C, R), (R, R)))
        YkV = offset_copy(ykv.ykv(Yc, Vg).cpu().numpy(), dtype, dev, offset)
        m = reduction_mask(K, mk, dtype, dev)
        got = mttkrp_mode3.mode3_variant(Yc, Vg)
        if f32 and got != want:
            fail(f"mode3 at K={K} R={R} C={C} offset {offset} took {got}, want {want}")
        seen.add(("mode3", got))
        args = {"mode3": (Yc, Vg, H, m), "mode3_reuse": (YkV, H, m)}
        check_kernels(args, errs)
        first = {name: kernels()[name][0](*a) for name, a in args.items()}
        for name, a in args.items():
            if not torch.equal(bits(kernels()[name][0](*a)), bits(first[name])):
                fail(f"{name} at K={K} R={R} C={C} gave other bits on the same input")
        if not torch.equal(bits(first["mode3"]), bits(first["mode3_reuse"])):
            fail(f"mode3 != mode3_reuse(ykv) bit for bit at K={K} R={R} C={C} offset {offset}")
        if mk == "all" and first["mode3"].any():
            fail(f"mode3 at K={K} R={R} C={C}: every subject masked, not all zeros")
    return seen


def p1_grams(R: int, K: int, kind, dtype, dev, seed: int):
    """K symmetric R x R Grams of one kind: "zero" (padded subjects),
    "identity" (one repeated eigenvalue), "rankdef" (B^T B with B's last
    columns exactly zero), "lowrank" (B^T B of a B with fewer rows than R),
    or a condition number (E diag(lambda) E^T, lambda from 1 down to
    1/condition, E random orthogonal)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if kind == "zero":
        G = np.zeros((K, R, R))
    elif kind == "identity":
        G = np.broadcast_to(np.eye(R), (K, R, R)).copy()
    elif kind in ("rankdef", "lowrank"):
        B = rng.standard_normal((K, R + 3 if kind == "rankdef" else max(1, R // 2), R))
        if kind == "rankdef":
            B[:, :, R // 2:] = 0.0
        G = np.swapaxes(B, 1, 2) @ B
    else:
        E = np.linalg.qr(rng.standard_normal((K, R, R)))[0]
        lam = np.geomspace(1.0, 1.0 / kind, R) * rng.uniform(0.5, 4.0, (K, 1))
        G = (E * lam[:, None, :]) @ np.swapaxes(E, 1, 2)
        G = (G + np.swapaxes(G, 1, 2)) / 2
    return torch.tensor(G, dtype=dtype, device=dev)


def p1_tolerance(kind, R: int, f64: bool) -> float:
    """P1 against its plain version, relative to max |P_inv|. f64: 1e-12,
    and at condition 1e6 the first-order bound R * condition * 2^-53 that
    any two backward-stable eigensolvers are held to (two correct solvers
    differ by ~1e-11 there); f32 (both solve in f64, then round): 1e-6 up to
    condition 10, 1e-4 at 1e2."""
    cond = kind if isinstance(kind, float) else 1.0
    if f64:
        return max(1e-12, R * cond * 2.0 ** -53) if cond > 1e2 else 1e-12
    return 1e-6 if cond <= 10 else 1e-4


def check_polar(dtype, dev, errs: dict) -> set:
    """P1 against its plain version at every rank, kind and size; zero
    Grams give exact zeros, every call is one launch; and Q = polar(B) is
    orthonormal on full-rank B. Returns the variants reached."""
    import torch
    from repro_torch.core.procrustes import solve_q
    from repro_torch.kernels import polar

    f64 = dtype == torch.float64
    kinds = ["zero", "identity", "rankdef", 1.0, 10.0, 100.0] + ([1e6, "lowrank"] if f64 else [])
    cases = [(R, K, kind) for R in P1_RANKS for K in P1_SMALL_K for kind in kinds]
    cases += [(R, K, kind) for R, K, kind in P1_LARGE]
    worst: dict = {}
    f32_eigh: dict = {}     # R -> what an f32 eigh departs by, condition <= 10
    variants = set()
    for i, (R, K, kind) in enumerate(cases):
        G = p1_grams(R, K, kind, dtype, dev, seed=i)
        if K >= 1000:
            G[::7] = 0.0                                   # padded subjects
        before = launches()["gram_inv_sqrt"]
        got = polar.gram_inv_sqrt(G)
        want = p1_plain(G)
        torch.cuda.synchronize()
        if launches()["gram_inv_sqrt"] != before + 1:
            fail(f"gram_inv_sqrt at R={R}, K={K} did not launch its kernel once")
        if got.shape != want.shape or got.dtype != G.dtype:
            fail(f"gram_inv_sqrt: shape {tuple(got.shape)} {got.dtype}, want "
                 f"{tuple(want.shape)} {G.dtype}")
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.abs().max())
        zero = got if kind == "zero" else got[::7] if K >= 1000 else None
        if zero is not None and bool((zero != 0).any()):
            fail(f"gram_inv_sqrt: zero Grams gave non-zero output (R={R}, K={K})")
        tol = p1_tolerance(kind, R, f64)
        if err > tol * max(scale, 1e-300) and not (scale == 0.0 and err == 0.0):
            fail(f"gram_inv_sqrt ({'f64' if f64 else 'f32'}, R={R}, K={K}, {kind}): max "
                 f"|kernel - plain| = {err:.3e} > {tol:.1e} x {scale:.3e}")
        rel = err / scale if scale else err
        worst[kind] = max(worst.get(kind, 0.0), rel)
        if not f64 and K < 1000 and scale > 0 and kind in ("identity", "rankdef", 1.0, 10.0):
            dep = float((p1_library(G).double() - want.double()).abs().max()) / scale
            f32_eigh[R] = max(f32_eigh.get(R, 0.0), dep)
        e, sc = errs.get("gram_inv_sqrt", (0.0, 0.0))
        errs["gram_inv_sqrt"] = (max(e, err), max(sc, scale))
        variants.add(("gram_inv_sqrt", polar.gram_inv_sqrt_variant(R)))
    orth = 0.0
    for R in (5, 40):
        gen = torch.Generator(device="cpu").manual_seed(R)
        B = torch.randn((64, 56, R), generator=gen, dtype=torch.float64).to(dtype).to(dev)
        before = launches()["gram_inv_sqrt"]
        Q = solve_q(B)
        if launches()["gram_inv_sqrt"] != before + 1:
            fail("solve_q on the card did not take P1 once")
        eye = torch.eye(R, dtype=torch.float64, device=dev)
        orth = max(orth, float((Q.transpose(1, 2).double() @ Q.double() - eye).abs().max()))
    if orth > (1e-12 if f64 else 1e-5):
        fail(f"Q^T Q - I = {orth:.3e} on full-rank B ({dtype})")
    print(f"[p1] {'f64' if f64 else 'f32'}: {len(cases)} cases, R in {P1_RANKS}, K in "
          f"{P1_SMALL_K} and {P1_LARGE}; largest |kernel - plain| / max |plain| by kind "
          + json.dumps({str(k): float(f"{v:.3e}") for k, v in worst.items()})
          + f"; max |Q^T Q - I| on B [64, 56, R in (5, 40)] {orth:.3e}", flush=True)
    if f32_eigh:
        print("[p1] f32: an eigh in f32 (the library call) departs from the f64 solve by, "
              "relative to max |P_inv|, at condition <= 10, by R: "
              + json.dumps({R: float(f"{v:.3e}") for R, v in f32_eigh.items()}), flush=True)
    return variants


def p2_tolerance(lam: float, f64: bool) -> float:
    """P2's tolerance relative to max |Z|: 1e-12 in f64; in f32 1e-6 times
    the matrix's condition bound 1 + 8 lam / rho (two backward-stable solves
    of one system part by about the condition number times the rounding)."""
    return 1e-12 if f64 else 1e-6 * (1.0 + 8.0 * lam / P2_RHO)


def check_tridiag(dtype, dev, errs: dict) -> None:
    """P2 against its plain version at every edge (``P2_N`` x ``P2_R`` x
    ``P2_LAM``), one launch a call and the same bits twice; then a captured
    call replayed after rho changed in place on the device, which only a
    kernel that reads rho from device memory follows; then the device
    kernels of one call at W's rows, counted in a captured graph, against
    the level count the C library reports."""
    import numpy as np
    import torch
    from repro_torch.kernels import tridiag

    f64 = dtype == torch.float64
    rng = np.random.default_rng(22)
    worst = 0.0
    for N in P2_N:
        for R in P2_R:
            Y = torch.tensor(rng.standard_normal((N, R)), dtype=dtype, device=dev)
            rho = torch.full((), P2_RHO, dtype=dtype, device=dev)
            for lam in P2_LAM:
                before = launches()["tridiag_solve"]
                got = tridiag.tridiag_solve(Y, rho, lam)
                again = tridiag.tridiag_solve(Y, rho, lam)
                want = tridiag.tridiag_solve_plain(Y, rho, lam)
                torch.cuda.synchronize()
                if launches()["tridiag_solve"] != before + 2:
                    fail(f"tridiag_solve at N={N}, R={R} did not launch its kernel once a call")
                if not torch.equal(got, again):
                    fail(f"tridiag_solve at N={N}, R={R}, lam={lam}: two calls differ")
                err = float((got.double() - want.double()).abs().max())
                scale = float(want.abs().max())
                if err > p2_tolerance(lam, f64) * scale:
                    fail(f"tridiag_solve ({'f64' if f64 else 'f32'}, N={N}, R={R}, lam={lam}): "
                         f"max |kernel - plain| = {err:.3e} > {p2_tolerance(lam, f64):.1e} x "
                         f"{scale:.3e}")
                worst = max(worst, err / scale)
                e, sc = errs.get("tridiag_solve", (0.0, 0.0))
                errs["tridiag_solve"] = (max(e, err), max(sc, scale))
    Y = torch.tensor(rng.standard_normal((4097, 5)), dtype=dtype, device=dev)
    rho = torch.full((), P2_RHO, dtype=dtype, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tridiag.tridiag_solve(Y, rho, 0.1)           # the workspace, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = tridiag.tridiag_solve(Y, rho, 0.1)
    rho.fill_(2.5)
    graph.replay()
    torch.cuda.synchronize()
    err = float((out.double() - tridiag.tridiag_solve_plain(Y, rho, 0.1).double()).abs().max())
    if err > p2_tolerance(0.1, f64) * float(out.abs().max()):
        fail(f"tridiag_solve replayed after rho changed on the device is off by {err:.3e}")
    counted = {}
    for N in (116225, 464900):
        Y = torch.tensor(rng.standard_normal((N, 5)), dtype=dtype, device=dev)
        counted[N] = captured_kernels(lambda: tridiag.tridiag_solve(Y, rho, 0.1))
        if counted[N] != tridiag.device_kernels(N):
            fail(f"tridiag_solve at N={N}: {counted[N]} device kernels in a captured call, "
                 f"its C library reports {tridiag.device_kernels(N)}")
    print(f"[p2] {'f64' if f64 else 'f32'}: N in {P2_N}, R in {P2_R}, lam in {P2_LAM}, rho "
          f"{P2_RHO}: largest |kernel - plain| / max |plain| {worst:.3e}, each within "
          f"{'1e-12' if f64 else '1e-6 (1 + 8 lam / rho)'}; two calls the same bits; device "
          f"kernels a call (one launch) at N = 116,225 and 464,900, R 5, counted in a "
          f"captured graph: "
          f"{counted[116225]}, {counted[464900]}; a captured call follows rho changed on the "
          f"device ({err:.3e})", flush=True)


def check_cores(dtype, dev, errs: dict) -> set:
    """F1-F4 and rows 5, 7, 8 and 10 on the compression path's core buckets
    [Kb, S, 128] (``CORE_SPECS``: S = 18 at R = 5, S = 16 at R = 4), made by
    the rsvd pass on the card, against their plain versions, with the
    variant each takes there; and P1 at R = S on the same buckets' range
    finder Grams (``Y^T Y``; the thin subjects' rank-deficient Grams and the
    padded subjects' zero ones among them), Gram by Gram. Returns the
    variants of F2 and rows 5 and 8 reached (F1's is printed)."""
    import numpy as np
    import torch
    from repro_torch.core import Parafac2Options, bucketize, parse_preprocess_spec
    from repro_torch.kernels import fused, mttkrp_mode2, polar, sketch, ykv
    from repro_torch.sparse import random_irregular

    data = random_irregular(**CORE_DATA)
    bt = bucketize(data, max_buckets=2, dtype=dtype, device=dev, subject_align=8)
    rng = np.random.default_rng(11)
    seen, variants = [], set()
    for spec, R in CORE_SPECS:
        pp = parse_preprocess_spec(spec)
        S = pp.sketch_dim(R)
        comp = pp.apply(bt, Parafac2Options(rank=R, dtype=dtype, backend="auto"), seed=0)
        H, V, W = (torch.tensor(rng.standard_normal(sh), dtype=dtype, device=dev)
                   for sh in ((R, R), (data.n_cols, R), (data.n_subjects, R)))
        omega = sketch.gaussian_sketch(0, data.n_cols, S, dtype, dev)
        for b, cb in zip(bt.buckets, comp.buckets):
            if not cb.compressed:
                continue
            core = cb.core
            Q = torch.tensor(rng.standard_normal((core.kb, S, R)), dtype=dtype, device=dev)
            args = kernel_args(core, H, V, W, Q)
            check_kernels({k: args[k] for k in CORE_KERNELS}, errs)
            Yc, Vg = args["ykv"]
            v = {"fused_procrustes_b": fused.procrustes_b_variant(core.vals, R),
                 "fused_mode1_xkv": fused.mode1_xkv_variant(*args["fused_mode1_xkv"][:2]),
                 "ykv": ykv.ykv_variant(Yc, Vg),
                 "mode2_compact": mttkrp_mode2.mode2_compact_variant(Yc, core.col_mask)}
            variants |= {(k, x) for k, x in v.items() if k != "fused_procrustes_b"}
            Y = sketch.power_iterate(b, sketch.sketch_bucket(b, omega), pp.param("q"))
            G = Y.transpose(1, 2) @ Y
            thin = int(((b.row_counts < S) & (b.subject_mask > 0)).sum())
            padded = int((b.subject_mask == 0).sum())
            err, scale = p1_main_path_check(
                G, S, label=f"the range Grams of a [{b.kb}, {b.i_pad}, {b.c_pad}] bucket "
                f"({thin} thin subjects, {padded} padded)", tag="[cores]")
            if bool((polar.gram_inv_sqrt(G)[b.subject_mask == 0] != 0).any()):
                fail("gram_inv_sqrt: a padded subject's zero range Gram gave non-zero output")
            e, sc = errs.get("gram_inv_sqrt", (0.0, 0.0))
            errs["gram_inv_sqrt"] = (max(e, err), max(sc, scale))
            seen.append((core.kb, S, core.c_pad, R, thin, padded, v))
    if not any(t for *_, t, _, _ in seen) or not any(p for *_, p, _ in seen):
        fail("the core check saw no thin or no padded subject")
    print(f"[cores] {str(dtype).removeprefix('torch.')}: F1-F4 and rows 5, 7, 8 and 10 "
          f"match their plain versions on the rsvd cores (Kb, S, C_pad, R, thin subjects, "
          f"padded subjects, variants): {seen}", flush=True)
    return variants


def phase2_kernels(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import bucketize
    from repro_torch.sparse import random_irregular

    errs: dict = {}
    variants = set()
    check_slab_edges(dev, errs)
    check_f1_half_edges(dev, errs)
    for dtype in (torch.float32, torch.float64):
        check_sparse_kernels(dtype, dev, errs)
        variants |= check_variant_edges(dtype, dev, errs)
        variants |= check_reduction_edges(dtype, dev, errs)
        variants |= check_mode3_edges(dtype, dev, errs)
        variants |= check_polar(dtype, dev, errs)
        variants |= check_cores(dtype, dev, errs)
        check_tridiag(dtype, dev, errs)
        for g in GEOMETRIES:
            data = random_irregular(n_subjects=g["K"], n_cols=g["J"],
                                    max_rows=g.get("max_rows", 9),
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
        check_empty(dtype, dev)
    if set(errs) != set(ALL):
        fail(f"phase 2 did not check {sorted(set(ALL) - set(errs))}")
    from repro_torch.kernels._launch import RING_VARIANTS
    from repro_torch.kernels.fused import F2_VARIANTS
    want = {(name, v) for name in ("ykv", "mode2_compact", "mode3", "scoo_xk_times_v",
                                   "scoo_project") for v in RING_VARIANTS}
    want |= {("fused_mode1_xkv", v) for v in F2_VARIANTS}
    from repro_torch.kernels.polar import VARIANTS as P1_VARIANTS
    want |= {("gram_inv_sqrt", v) for v in P1_VARIANTS}
    if variants != want:
        fail(f"phase 2 did not reach the variants {sorted(want - variants)}")
    print(f"[kernels] all fifteen match their plain versions (f32, f64; "
          f"{len(GEOMETRIES)} CC geometries, R in {sorted({g['R'] for g in GEOMETRIES})}, "
          f"C_pad up to 1024; SCOO {', '.join(SCOO_DATA)} at R 1/5/72 and explicit "
          f"zero-valued triplets; BCC {BCC_GEOMETRIES}; rows 5, 8, 11 and 12 at "
          f"{len(YKV_EDGES)}, {len(MODE2_EDGES)}, {len(XKV_EDGES)} and "
          f"{len(PROJECT_EDGES)} edge shapes, F1's tensor-core ring at "
          f"{len(F1_HALF_EDGES)} in bf16 and f16, F4 and F3 at {len(SLAB_EDGES)} in f32, f64, "
          f"bf16 and f16 (every variant reached at each, each twice with the same bits), "
          f"F2 and row 7 at {len(F2_EDGES)} and "
          f"{len(MODE1_REUSE_EDGES)}, rows 9 and 10 at {len(MODE3_EDGES)} with mode3 == "
          f"mode3_reuse(ykv) bit for bit, each twice with the same bits, P2 at "
          f"{len(P2_N) * len(P2_R) * len(P2_LAM)} edges, variants "
          f"{sorted(variants)}; padded subjects, K=0): "
          + json.dumps({k: v[0] for k, v in errs.items()}), flush=True)
    return errs


def check_launches(route: str, got: dict, want: int, path: dict = ON_MAIN_PATH) -> None:
    """The route's kernels on ``path`` (the main path's, or ``ON_CORES``)
    launched ``want`` times each, and no other kernel launched."""
    for name, n in got.items():
        expect = want if name in path[route] else 0
        if n != expect:
            fail(f"{route}: {name} launched {n} times, want {expect}")


def phase3_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.procrustes import solve_q
    from repro_torch.launch import decompose as dec

    t0 = time.perf_counter()
    data = dec.load_dataset("choa", MAIN_SCALE, 0)
    t_data = time.perf_counter() - t0
    bts, dev_bytes = {}, {}
    for fmt in ("cc", "scoo"):          # one generation, bucketized twice
        t0 = time.perf_counter()
        bts[fmt], stats = dec.prepare(data, buckets=4, device=dev, dtype=torch.float32,
                                      format=fmt)
        torch.cuda.synchronize()
        dev_bytes[fmt] = sum(r["device_bytes"] for r in stats)
        shapes = [(r["i_pad"], r["c_pad"], r["n_subjects"], r.get("nnz_pad"), r["format"],
                   round(r["density"], 4)) for r in stats]
        print(f"[main] choa scale {MAIN_SCALE} {fmt}: K={data.n_subjects} nnz={data.nnz} "
              f"buckets (I_pad, C_pad, subjects, N_pad, format, density)={shapes} "
              f"device bytes {dev_bytes[fmt]} ({dev_bytes[fmt] / 2**30:.3f} GiB); "
              f"generation {t_data:.1f}s, bucketize+upload {time.perf_counter() - t0:.1f}s",
              flush=True)
    bt, bt_sc = bts["cc"], bts["scoo"]
    kw = dict(rank=5, iters=ITERS, tol=0.0, seed=0, dtype=torch.float32, verbose=False)
    # (label, buckets, backend): the CC routes, then the SCOO ones
    runs = [("auto", bt, "auto"), ("staged", bt, "staged"), ("torch", bt, "torch"),
            ("staged-scoo", bt_sc, "staged"), ("scoo-scoo", bt_sc, "scoo"),
            ("auto-scoo", bt_sc, "auto")]
    # two iterations of each route first, so that no timed run pays for the
    # first launches (module loads, cuBLAS/cuSOLVER handles)
    for _, b_, backend in runs:
        dec.decompose(b_, backend=backend, **{**kw, "iters": 2})

    hist, ms, counts, peaks = {}, {}, {}, {}
    for label, b_, backend in runs:
        resident = torch.cuda.memory_allocated()       # both formats' buckets
        torch.cuda.reset_peak_memory_stats()
        state, hist[label], secs = dec.decompose(b_, backend=backend, **kw)  # counts from 0
        counts[label] = launches()                     # read right after the run
        peak = torch.cuda.max_memory_allocated()
        peaks[label] = (peak - resident) / 2**30        # what the fit adds
        ms[label] = secs / len(hist[label]) * 1e3
        if label == "auto":
            main_state = state
        fmt = "scoo" if label.endswith("-scoo") else "cc"
        print(f"[main] {label}: {len(hist[label])} iters, {ms[label]:.2f} ms/iter, "
              f"peak device memory {peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} "
              f"GiB above the resident buckets; {fmt} buckets alone "
              f"{(peak - resident + dev_bytes[fmt]) / 2**30:.3f} GiB), launches "
              f"{ {k: v for k, v in counts[label].items() if v} }", flush=True)
        print(f"[main] {label} fit history {json.dumps(hist[label])}", flush=True)
        if len(hist[label]) != ITERS or not np.all(np.isfinite(hist[label])):
            fail(f"{label}: main path fit history is not finite or short")
    print(f"[main] device bytes: CC {dev_bytes['cc']}, SCOO {dev_bytes['scoo']} "
          f"({dev_bytes['scoo'] / dev_bytes['cc']:.3f} of CC)", flush=True)
    for label in ("auto", "staged", "torch", "staged-scoo", "scoo-scoo", "auto-scoo"):
        n_buckets = len((bt_sc if label.endswith("-scoo") else bt).buckets)
        check_launches(label, counts[label], n_buckets * ITERS)
    from repro_torch.kernels import fused, mttkrp_mode2, scoo, ykv
    print(f"[main] auto: F1 variant per CC bucket (I_pad, C_pad, subjects): "
          f"{[(b.i_pad, b.c_pad, b.kb, fused.procrustes_b_variant(b.vals, 5)) for b in bt.buckets]}",
          flush=True)

    def yc_like(b):     # the staged route's Yc: a fresh contiguous [Kb, R, C_pad]
        return torch.empty((b.kb, 5, b.c_pad), device=dev)

    def vg_like(b):     # b.gather_v(V): a fresh contiguous [Kb, C_pad, R]
        return torch.empty((b.kb, b.c_pad, 5), device=dev)

    def project_variant(b):
        Q = torch.empty((b.kb, b.i_pad, 5), device=dev)   # as solve_q returns it
        return scoo.scoo_project_variant(b.vals, b.rows, b.lcols, Q, b.c_pad, cperm=b.cperm,
                                         col_ends=b.col_ends)

    def staged_variants(b):     # rows 5 and 8
        return (ykv.ykv_variant(yc_like(b), vg_like(b)),
                mttkrp_mode2.mode2_compact_variant(yc_like(b), b.col_mask))

    cc_v = [(b.c_pad, b.kb, *staged_variants(b)) for b in bt.buckets]
    sc_v = [(b.i_pad, b.c_pad, b.n_pad, b.kb,
             scoo.scoo_xk_times_v_variant(b.vals, b.rows, b.lcols, vg_like(b), b.i_pad,
                                          row_ends=b.row_ends),
             project_variant(b), *staged_variants(b)) for b in bt_sc.buckets]
    print(f"[main] staged: rows 5 and 8 variants per CC bucket (C_pad, subjects): {cc_v}; "
          f"staged-scoo: rows 11, 12, 5 and 8 per SCOO bucket (I_pad, C_pad, N_pad, "
          f"subjects): {sc_v}", flush=True)
    for label in ("auto", "staged", "staged-scoo", "scoo-scoo", "auto-scoo"):
        diff = float(np.max(np.abs(np.asarray(hist[label]) - np.asarray(hist["torch"]))))
        print(f"[main] max |fit {label} - fit torch (CC)| over {ITERS} iterations = "
              f"{diff:.3e}", flush=True)
        if diff > 1e-4:
            fail(f"{label} fit history differs from the torch route by {diff:.3e} > 1e-4")

    common = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters",
              str(ITERS), "--tol", "0", "--dtype", "float64", "--device", "cuda"]
    s64 = {backend: dec.main(common + ["--backend", backend, "--json",
                                       str(OUT / f"decompose_f64_{backend}.json")])
           for backend in ("auto", "staged", "torch")}
    for fmt in ("scoo", "auto"):
        for backend in ("staged", "scoo", "auto"):
            s64[f"{backend}-{fmt}"] = dec.main(common + [
                "--backend", backend, "--format", fmt,
                "--json", str(OUT / f"decompose_f64_{backend}_{fmt}.json")])
    # the whole fit as one captured iteration replayed, stopping on the device
    s64["auto-scan0"] = dec.main(common + ["--backend", "auto", "--engine", "scan",
                                           "--check-every", "0", "--json",
                                           str(OUT / "decompose_f64_auto_scan0.json")])
    for label, summary in s64.items():
        if label == "torch":
            continue
        diff64 = float(np.max(np.abs(np.asarray(summary["fit_history"])
                                     - np.asarray(s64["torch"]["fit_history"]))))
        print(f"[main] scale 0.002 f64: max |fit {label} - fit torch (CC)| = {diff64:.3e}; "
              f"launches { {k: v for k, v in summary['kernel_launches'].items() if v} }",
              flush=True)
        if diff64 > 1e-8:
            fail(f"f64 {label} fit history differs by {diff64:.3e} > 1e-8")
        if label.endswith("-auto") and {r["format"] for r in summary["buckets"]} != {"scoo"}:
            fail(f"{label}: format auto kept a CC bucket at CHOA's density")
        route = (label if label in ON_MAIN_PATH else "auto" if label == "auto-scan0"
                 else label.rsplit("-", 1)[0] + "-scoo")
        check_launches(route, summary["kernel_launches"], len(summary["buckets"]) * ITERS)
    check_launches("torch", s64["torch"]["kernel_launches"],
                   len(s64["torch"]["buckets"]) * ITERS)
    if (s64["auto-scan0"]["engine"], s64["auto-scan0"]["check_every"]) != ("scan", 0):
        fail("the f64 scan run's summary does not report engine scan, check_every 0")

    # the two staged kernels off the main path: mode1 (mode1_reuse=False) ...
    short = dict(kw, iters=3)
    _, h_full, _ = dec.decompose(bt, backend="staged", mode1_reuse=False, **short)
    counts["mode1"] = launches()
    _, h_full_t, _ = dec.decompose(bt, backend="torch", mode1_reuse=False, **short)
    diff = float(np.max(np.abs(np.asarray(h_full) - np.asarray(h_full_t))))
    print(f"[main] staged, mode1_reuse=False, 3 iters: mode1 launched "
          f"{counts['mode1']['mode1']} times; max |fit - torch| = {diff:.3e}", flush=True)
    if counts["mode1"]["mode1"] != len(bt.buckets) * 3 or diff > 1e-4:
        fail("the mode1_reuse=False path did not launch mode1 buckets x iterations "
             "times or left the torch route's fit")
    # ... and mode3, from the backend's array-level contraction
    staged_be, torch_be = get_backend("staged"), get_backend("torch")
    H, V, W = main_state.H, main_state.V, main_state.W
    Ycs = []
    for b in bt.buckets:
        _, B = torch_be.procrustes_b_bucket(b, H, W[b.subject_ids.long()], V)
        Ycs.append(b.project(solve_q(B) * b.subject_mask[:, None, None]))
    reset_launches()
    rows = [staged_be.mode3(Yc, b.gather_v(V), H, b.subject_mask)
            for b, Yc in zip(bt.buckets, Ycs)]
    counts["mode3"] = launches()
    err = max(within(r, torch_be.mode3(Yc, b.gather_v(V), H, b.subject_mask), False)[0]
              for r, b, Yc in zip(rows, bt.buckets, Ycs))
    from repro_torch.kernels import mttkrp_mode3
    v9 = [(b.c_pad, b.kb, mttkrp_mode3.mode3_variant(Yc, vg_like(b)))
          for b, Yc in zip(bt.buckets, Ycs)]
    print(f"[main] array-level mode3 over the {len(bt.buckets)} buckets: launched "
          f"{counts['mode3']['mode3']} times; max |kernel - torch| = {err:.3e}; row 9 "
          f"variant per bucket (C_pad, subjects): {v9}", flush=True)
    if counts["mode3"]["mode3"] != len(bt.buckets):
        fail("the array-level mode3 did not launch once per bucket")

    cut, bcc, counts["bcc"] = bcc_cut(bt, main_state.V)

    # each kernel's launches in the run of the path that reaches it (P2's
    # path is the constrained fit of phase3_constrained)
    path_of = {**dict.fromkeys(FUSED, "auto"), **dict.fromkeys(STAGED, "staged"),
               "mode1": "mode1", "mode3": "mode3", **dict.fromkeys(SCOO, "staged-scoo"),
               "gather_matmul": "bcc", "gram_inv_sqrt": "auto"}
    per_kernel = {name: counts[path_of[name]][name] for name in ALL if name in path_of}
    peaks["dev_bytes"] = dev_bytes
    return bt, bt_sc, (cut, bcc), main_state, per_kernel, ms, hist, peaks, data


def scan_opts(backend: str, check_every: int, constraints=None, precision: str = "f32"):
    import torch
    from repro_torch.core import Parafac2Options

    return Parafac2Options(rank=5, backend=backend, dtype=torch.float32, engine="scan",
                           check_every=check_every, constraints=constraints,
                           precision=precision)


def steady_ms(data, backend: str, check_every: int, constraints=None,
              precision: str = "f32") -> tuple:
    """(set-up seconds, its warm-up's kernel launches, ms per iteration) of
    the scan engine on ``data``: the chunk (or the while variant) made once
    from the seeded start (warm-up and capture: the set-up), then ``ITERS``
    iterations timed as ``fit_device`` runs them, the fits read at the end
    of each chunk."""
    import torch
    from repro_torch.core import engine, init_state

    opts = scan_opts(backend, check_every, constraints, precision)
    s0 = init_state(data, opts, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = (engine.make_als_chunk(data, opts, check_every, state=s0) if check_every
           else engine.make_als_while(data, opts, ITERS, 0.0, state=s0))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    if check_every:
        s = s0
        for _ in range(ITERS // check_every):
            s, fits = run(s)
            fits.tolist()
    else:
        _, hist, n = run(s0)
        hist[: int(n)].tolist()
    return setup, sum(run.setup_launches.values()), (time.perf_counter() - t0) / ITERS * 1e3


def phase3_engines(bt, bt_sc, hist: dict, ms: dict, peaks: dict) -> dict:
    """The scan engine (CUDA graphs) beside the host engine on the CC auto,
    CC staged and SCOO staged routes, at check_every 10 and 0 (the while
    variant): each fit through ``decompose`` (launch counts: buckets x
    iterations under replay, the warm-up's kept apart), its history against
    the same route's host history (bit for bit, else within 1e-6) and the CC
    torch route's (1e-4), peak memory, and the steady ms/iter with the
    set-up (warm-up and capture) outside the timing; a second fit on the
    same data, which replays the kept chunk (no new chunk made, the same
    bits), with its ms/iter with set-up beside the host engine's. Then no host sync in an
    eager ``als_step`` or a replay (``set_sync_debug_mode("error")``), the
    while variant's stop and its masked iterations at a tol that the fit
    crosses, and a chunked run's overshoot. Returns the steady ms/iter."""
    import numpy as np
    import torch
    from repro_torch.core import Parafac2Options, als_step, engine, init_state
    from repro_torch.launch import decompose as dec

    data_of = {"auto": (bt, "auto"), "staged": (bt, "staged"), "staged-scoo": (bt_sc, "staged")}
    kw = dict(rank=5, iters=ITERS, seed=0, dtype=torch.float32, verbose=False)
    steady = {}
    for label in SCAN_ROUTES:
        data, backend = data_of[label]
        for ce in (10, 0):
            name = f"{label} scan{ce}"
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, h, secs = dec.decompose(data, backend=backend, tol=0.0, engine="scan",
                                           check_every=ce, **kw)
            counts = launches()
            peak = torch.cuda.max_memory_allocated()
            check_launches(label, counts, len(data.buckets) * ITERS)
            if len(h) != ITERS or not np.all(np.isfinite(h)) or h[-1] != float(state.fit):
                fail(f"{name}: fit history short, not finite or not the state's fit")
            bitwise = h == hist[label]
            d_host = float(np.max(np.abs(np.asarray(h) - np.asarray(hist[label]))))
            d_torch = float(np.max(np.abs(np.asarray(h) - np.asarray(hist["torch"]))))
            setup, warm_launches, steady[name] = steady_ms(data, backend, ce)
            peaks[name] = (peak - resident) / 2**30
            alone = peaks[name] + peaks["dev_bytes"]["scoo" if label.endswith("-scoo") else "cc"] / 2**30
            print(f"[scan] {name}: {steady[name]:.2f} ms/iter replayed (host engine "
                  f"{ms[label]:.2f}), set-up (warm-up {engine.WARMUP_ITERS} iterations, "
                  f"{warm_launches} launches of the port's kernels kept apart, + capture) "
                  f"{setup:.2f}s, the fit with set-up {secs / ITERS * 1e3:.2f} "
                  f"ms/iter; peak device memory {peaks[name]:.3f} GiB above what was held "
                  f"before the fit (host engine {peaks[label]:.3f}; the route's buckets and "
                  f"this fit alone {alone:.3f} GiB); launches "
                  f"{ {k: v for k, v in counts.items() if v} }; fit history bit for bit the "
                  f"host engine's: {bitwise}, max |scan - host| {d_host:.3e}, max |scan - "
                  f"torch (CC)| {d_torch:.3e}", flush=True)
            if d_host > 1e-6 or d_torch > 1e-4:
                fail(f"{name}: fit history differs from the host engine's by {d_host:.3e} "
                     f"(> 1e-6) or from the torch route's by {d_torch:.3e} (> 1e-4)")
            # a second fit on the same data replays the kept chunk: no warm-up, no capture
            made = engine.CHUNKS.made
            state2, h2, secs2 = dec.decompose(data, backend=backend, tol=0.0, engine="scan",
                                              check_every=ce, **kw)
            check_launches(label, launches(), len(data.buckets) * ITERS)
            same = h2 == h and all(torch.equal(getattr(state2, f), getattr(state, f))
                                   for f in ("H", "V", "W", "fit"))
            print(f"[scan] {name} second call on the same data: chunks made "
                  f"{engine.CHUNKS.made - made} (the kept one replayed, no warm-up or capture); "
                  f"the fit with set-up {secs2 / ITERS * 1e3:.2f} ms/iter against the first "
                  f"call's {secs / ITERS * 1e3:.2f} and the host engine's {ms[label]:.2f}; "
                  f"history and state bit for bit the first call's: {same}, history the host "
                  f"engine's: {h2 == hist[label]}", flush=True)
            if engine.CHUNKS.made != made or not same:
                fail(f"{name}: a second fit on the same data made a new chunk or gave other "
                     f"bits than the first")
            del state2

    # no host sync: one eager als_step and one replay of a captured chunk
    for label in SCAN_ROUTES:
        data, backend = data_of[label]
        opts = Parafac2Options(rank=5, backend=backend, dtype=torch.float32)
        s = als_step(data, init_state(data, opts, seed=0), opts)
        chunk = engine.make_als_chunk(data, scan_opts(backend, 10), 10, state=s)
        torch.cuda.synchronize()
        for what, call in (("an eager als_step", lambda: als_step(data, s, opts)),
                           ("a replay of a captured chunk", lambda: chunk(s))):
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
            except RuntimeError as e:
                fail(f"{label}: {what} synchronised with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        del chunk
    print(f"[scan] no host sync (set_sync_debug_mode('error')) in one eager als_step or "
          f"one chunk replay on {', '.join(SCAN_ROUTES)}", flush=True)

    # the stop: a tol halfway between two of CC auto's fit changes
    d = np.sort(np.abs(np.diff(hist["auto"])))
    tol = float((d[len(d) // 2 - 1] + d[len(d) // 2]) / 2)
    _, h_host, _ = dec.decompose(bt, backend="auto", tol=tol, **kw)
    opts = scan_opts("auto", 0)
    s0 = init_state(bt, opts, seed=0)
    run = engine.make_als_while(bt, opts, ITERS, tol, state=s0)
    _, h_while, n = run(s0)
    n = int(n)
    h_while = h_while[:n].tolist()
    state_c, h_chunk, _ = dec.decompose(bt, backend="auto", tol=tol, engine="scan",
                                        check_every=10, **kw)
    d_while = float(np.max(np.abs(np.asarray(h_while) - np.asarray(h_host))))
    print(f"[scan] auto at tol {tol:.3e}: host engine stops after {len(h_host)} iterations; "
          f"while variant after {n} ({run.replays} replays: {run.replays - n} masked past the "
          f"stop), history bit for bit the host's: {h_while == h_host}, max |while - host| "
          f"{d_while:.3e}; chunked (check_every 10) ran {len(h_chunk)}", flush=True)
    if n != len(h_host) or d_while > 1e-6 or len(h_host) >= ITERS:
        fail("the while variant did not stop after the host loop's iteration")
    if not (len(h_host) <= len(h_chunk) < len(h_host) + 10) or h_chunk[-1] != float(state_c.fit):
        fail("the chunked run overshot by a chunk or more, or did not end on its state's fit")
    return steady


def half_kernel_args(b, bs, H, V, W, Q, Qs, half) -> dict:
    """The nine kernels' half-width operands at the largest CC bucket ``b``
    and the largest SCOO bucket ``bs``, as the routes pass them at that
    precision: the slab, Yc, Vg and the SCOO values half, every other
    operand f32; row 5 also with Yc f32 and with Vg f32. Returns name ->
    list of argument tuples."""
    import torch
    from repro_torch.kernels.common import fold_subject_mask

    Vg = b.gather_v(V)
    Wr = W[b.subject_ids.long()]
    Wb = fold_subject_mask(Wr, b.subject_mask)
    vh, gh = b.vals.to(half), Vg.to(half)
    Yc = torch.bmm(Q.transpose(1, 2), b.vals)
    yh = Yc.to(half)
    sargs, _ = scoo_args(bs, V, Qs)
    xa, pa = sargs["scoo_xk_times_v"], sargs["scoo_project"]
    svh = bs.vals.to(half)
    return {
        "fused_procrustes_b": [(vh, gh, Wb, H)],
        "fused_mode2_compact": [(vh, Q, H, Wb, b.col_mask)],
        "fused_ykv": [(vh, Q, gh)],
        "ykv": [(yh, gh), (Yc, gh), (yh, Vg)],
        "mode1": [(yh, gh, Wr, b.subject_mask)],
        "mode2_compact": [(yh, H, Wb, b.col_mask)],
        "mode3": [(yh, gh, H, b.subject_mask)],
        "scoo_xk_times_v": [(svh, xa[1], xa[2], xa[3].to(half), *xa[4:])],
        "scoo_project": [(svh, *pa[1:])],
    }


def check_half_refusals(b, half) -> None:
    """One combination each kernel family does not take raises a TypeError
    before any launch: F1 with an f32 slab and a half Vg, row 5 with
    bfloat16 beside float16, row 11 with half values and an f32 Vg."""
    import torch
    from repro_torch.kernels import fused, scoo, ykv

    other = torch.float16 if half == torch.bfloat16 else torch.bfloat16
    K, I, C, R = 4, 8, 16, 5
    z = dict(device=b.vals.device)
    cases = {
        "fused": lambda: fused.fused_procrustes_b(
            torch.ones((K, I, C), **z), torch.ones((K, C, R), dtype=half, **z),
            torch.ones((K, R), **z), torch.eye(R, **z)),
        "staged": lambda: ykv.ykv(torch.ones((K, R, C), dtype=half, **z),
                                  torch.ones((K, C, R), dtype=other, **z)),
        "scoo": lambda: scoo.scoo_xk_times_v(
            torch.ones((K, 8), dtype=half, **z), torch.zeros((K, 8), dtype=torch.int32, **z),
            torch.zeros((K, 8), dtype=torch.int32, **z), torch.ones((K, C, R), **z), I,
            row_ends=torch.zeros((K, I), dtype=torch.int32, **z)),
    }
    before = launches()
    for family, call in cases.items():
        try:
            call()
        except TypeError:
            continue
        fail(f"{family}: a combination of dtypes its kernels do not take was not refused")
    if launches() != before:
        fail("a refused half combination launched a kernel")


def phase3_half(bt, bt_sc, state, hist: dict, ms: dict, peaks: dict) -> tuple:
    """Half precision (bf16, f16). The nine kernels that take half operands
    against their plain versions on the same half inputs at the main path's
    largest CC and SCOO buckets (row 5 also with one operand f32), each
    launching its kernel, f32 tolerance (products of half values are exact
    in f32: only the order of the sums differs); one refused combination
    per kernel family. Then the choa 0.25 fits of CC auto, CC staged and
    SCOO staged at each precision, host and scan (check_every 10) engines:
    finite, within 1e-3 of the same route's f32 host fit of phase 3, scan
    bit for bit the host, the route's kernels buckets x iterations times,
    no host sync in an eager step or a chunk replay; ms/iter and the device
    memory each fit adds, its half copy of the values included. Last, the
    paths that reach rows 6 and 9 at bf16 (``mode1_reuse=False``, the
    array-level ``mode3``). Returns (errors by kernel and precision,
    bf16 launches by kernel, ms by run)."""
    import numpy as np
    import torch
    from repro_torch.core import Parafac2Options, als_step, engine, init_state
    from repro_torch.core.backend import get_backend
    from repro_torch.core.procrustes import solve_q
    from repro_torch.kernels.common import PRECISION_DTYPES
    from repro_torch.launch import decompose as dec

    table = kernels()
    b = max(bt.buckets, key=lambda x: x.vals.numel())
    bs = max(bt_sc.buckets, key=lambda x: x.kb)
    H, V, W = state.H.contiguous(), state.V, state.W
    _, B = get_backend("auto", b.vals.device).procrustes_b_bucket(
        b, H, W[b.subject_ids.long()] * b.subject_mask[:, None], V)
    Q = solve_q(B) * b.subject_mask[:, None, None]
    _, Bs = get_backend("staged").procrustes_b_bucket(
        bs, H, W[bs.subject_ids.long()] * bs.subject_mask[:, None], V)
    Qs = solve_q(Bs) * bs.subject_mask[:, None, None]
    errs = {}
    for prec in HALF:
        half = PRECISION_DTYPES[prec]
        for name, calls in half_kernel_args(b, bs, H, V, W, Q, Qs, half).items():
            wrapper, plain, _ = table[name]
            for args in calls:
                before = launches()[name]
                got = wrapper(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                if launches()[name] != before + 1:
                    fail(f"{name} ({prec}) did not launch its kernel")
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                scale = None
                if name in SCOO:
                    idx = args[2] if name == "scoo_xk_times_v" else args[1]
                    scale = prefix_scale(args[0], idx, args[3])
                for g, w in zip(got, want):
                    if g.dtype != torch.float32 or g.shape != w.shape:
                        fail(f"{name} ({prec}): {g.dtype} {tuple(g.shape)}, want float32 "
                             f"{tuple(w.shape)}")
                    err, ok = within(g, w, False, scale)
                    if not ok:
                        fail(f"{name} ({prec}, operands "
                             f"{[str(a.dtype)[6:] for a in args if torch.is_tensor(a)]}): "
                             f"max |kernel - plain| = {err:.3e}")
                    e, sc = errs.get((name, prec), (0.0, 0.0))
                    errs[(name, prec)] = (max(e, err), max(sc, float(w.abs().max())))
        check_half_refusals(b, half)
    print(f"[half] the nine kernels match their plain versions on half inputs at the main "
          f"path's largest CC (K={b.kb} I={b.i_pad} C={b.c_pad}) and SCOO (Kb={bs.kb} "
          f"N={bs.n_pad}) buckets, row 5 also with Yc or Vg f32; one refused combination "
          f"a family raised: "
          + json.dumps({f"{n}[{p}]": v[0] for (n, p), v in errs.items()}), flush=True)

    data_of = {"auto": (bt, "auto"), "staged": (bt, "staged"), "staged-scoo": (bt_sc, "staged")}
    kw = dict(rank=5, iters=ITERS, seed=0, dtype=torch.float32, verbose=False, tol=0.0)
    for _, (data, backend) in data_of.items():      # two iterations first, as phase 3
        dec.decompose(data, backend=backend, **{**kw, "iters": 2}, precision="bf16")
    half_ms, counts_bf16 = {}, {}
    for prec in HALF:
        for label in SCAN_ROUTES:
            data, backend = data_of[label]
            n = len(data.buckets) * ITERS
            runs = {}
            for eng in ("host", "scan"):
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                _, h, secs = dec.decompose(data, backend=backend, engine=eng, check_every=10,
                                           precision=prec, **kw)
                counts = launches()
                added = (torch.cuda.max_memory_allocated() - resident) / 2**30
                check_launches(label, counts, n)
                if len(h) != ITERS or not np.all(np.isfinite(h)):
                    fail(f"{label} {prec} {eng}: fit history short or not finite")
                runs[eng] = h
                key = f"{label} {prec} {eng}"
                half_ms[key] = secs / ITERS * 1e3
                peaks[key] = added
                if prec == "bf16" and eng == "host":
                    counts_bf16[label] = counts
                d32 = float(np.max(np.abs(np.asarray(h) - np.asarray(hist[label]))))
                print(f"[half] {key}: {half_ms[key]:.2f} ms/iter"
                      f"{' (with the set-up)' if eng == 'scan' else ''} (f32 host "
                      f"{ms[label]:.2f}), device memory added {added:.3f} GiB (f32 host "
                      f"{peaks[label]:.3f}; the half copy of the values "
                      f"{sum(x.vals.numel() * 2 for x in data.buckets) / 2**30:.3f} GiB); "
                      f"max |fit - f32 fit| {d32:.3e}; launches "
                      f"{ {k: v for k, v in counts.items() if v} }", flush=True)
                print(f"[half] {key} fit history {json.dumps(h)}", flush=True)
                if d32 > 1e-3:
                    fail(f"{key}: fit history departs from the f32 fit by {d32:.3e} > 1e-3")
                torch.cuda.empty_cache()        # release the fit's half copy
            if runs["scan"] != runs["host"]:
                fail(f"{label} {prec}: the scan engine's history is not the host engine's "
                     f"bit for bit")
            if prec == "bf16":
                setup, _, half_ms[f"{label} bf16 scan10 replay"] = steady_ms(
                    data, backend, 10, precision="bf16")
                print(f"[half] {label} bf16 scan10: "
                      f"{half_ms[f'{label} bf16 scan10 replay']:.2f} ms/iter replayed, "
                      f"set-up {setup:.2f}s", flush=True)
    print(f"[half] scan (check_every 10) bit for bit the host engine on "
          f"{', '.join(SCAN_ROUTES)} at {', '.join(HALF)}", flush=True)

    # no host sync at half precision: one eager als_step and one chunk replay
    for label in SCAN_ROUTES:
        data, backend = data_of[label]
        opts = Parafac2Options(rank=5, backend=backend, dtype=torch.float32, precision="bf16")
        dh = data.with_compute_values("bf16")
        s = als_step(dh, init_state(dh, opts, seed=0), opts)
        chunk = engine.make_als_chunk(data, scan_opts(backend, 10, precision="bf16"), 10,
                                      state=s)
        torch.cuda.synchronize()
        for what, call in (("an eager als_step", lambda: als_step(dh, s, opts)),
                           ("a replay of a captured chunk", lambda: chunk(s))):
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
            except RuntimeError as e:
                fail(f"{label} bf16: {what} synchronised with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        del chunk, dh
    print(f"[half] no host sync (set_sync_debug_mode('error')) in one eager bf16 als_step "
          f"or one chunk replay on {', '.join(SCAN_ROUTES)}", flush=True)

    # rows 6 and 9 at bf16, on their own paths
    _, h6, _ = dec.decompose(bt, backend="staged", mode1_reuse=False, precision="bf16",
                             **{**kw, "iters": 3})
    counts_bf16["mode1"] = launches()
    if counts_bf16["mode1"]["mode1"] != len(bt.buckets) * 3 or not np.all(np.isfinite(h6)):
        fail("the bf16 mode1_reuse=False path did not launch mode1 buckets x iterations")
    be = get_backend("staged", precision="bf16")
    reset_launches()
    for bb in bt.buckets:
        Yc = be.project_bucket(bb, torch.zeros((bb.kb, bb.i_pad, 5), device=bb.vals.device))
        be.mode3(Yc, be._pc(bb.gather_v(V)), H, bb.subject_mask)
    counts_bf16["mode3"] = launches()
    if counts_bf16["mode3"]["mode3"] != len(bt.buckets):
        fail("the bf16 array-level mode3 did not launch once per bucket")
    path_of = {**dict.fromkeys(("fused_procrustes_b", "fused_mode2_compact", "fused_ykv"),
                               "auto"),
               "ykv": "staged", "mode2_compact": "staged", "mode1": "mode1", "mode3": "mode3",
               **dict.fromkeys(SCOO, "staged-scoo")}
    per_kernel = {name: counts_bf16[path_of[name]][name] for name in HALF_KERNELS}
    print(f"[half] bf16 launches of the nine kernels on their paths: {per_kernel}", flush=True)
    return errs, per_kernel, half_ms


def work_half(name: str, K: int, I: int, C: int, R: int) -> tuple:
    """(bytes, operations) of a CC kernel at half precision: the streamed
    operands (the slab, Yc, Vg) at 2 bytes a value, every other operand and
    the output at 4; operations as ``work``'s."""
    slab, ir, cr, kr, rr, krr = K * I * C, K * I * R, K * C * R, K * R, R * R, K * R * R
    streamed = {"fused_procrustes_b": (slab + cr, kr + rr + 2 * ir),
                "fused_mode2_compact": (slab, ir + rr + kr + K * C + cr),
                "fused_ykv": (slab + cr, ir + krr),
                "ykv": (2 * cr, krr), "mode1": (2 * cr, kr + rr + K),
                "mode2_compact": (cr, rr + kr + K * C + cr),
                "mode3": (2 * cr, rr + K + kr)}
    half, full = streamed[name]
    return 2 * half + 4 * full, work(name, K, I, C, R, 4)[1]


def sparse_work_half(name: str, b, R: int) -> tuple:
    """(bytes, operations) of rows 11 and 12 at half precision on this run's
    data: the values (and row 11's Vg rows) at 2 bytes, Q, the indices and
    the f32 output as ``sparse_work`` counts them."""
    nbytes, ops = sparse_work(name, b, R)
    nnz = int(b.nnz_counts.sum())
    saved = 2 * nnz + (2 * int(b.col_mask.sum()) * R if name == "scoo_xk_times_v" else 0)
    return nbytes - saved, ops


def phase4_half(bt, bt_sc, state, per_kernel: dict, errs: dict) -> list:
    """The nine half kernels at bf16 at the main path's largest CC and SCOO
    buckets: time by CUDA events and in a replayed CUDA graph, the plain
    version's time, the byte bound at half width, and one PyTorch call a
    function on the same half inputs (the X_k V part of F1, row 5's
    product, rows 11 and 12's sparse products; for F3, F4 and rows 6, 8 and
    9, whose f32 operands no call takes beside half ones, an einsum with
    every operand at bf16)."""
    import torch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.procrustes import solve_q
    from repro_torch.kernels import fused, mttkrp_mode2, mttkrp_mode3, scoo, ykv
    from repro_torch.launch.kernel_ab import graph_ms

    b = max(bt.buckets, key=lambda x: x.vals.numel())
    bs = max(bt_sc.buckets, key=lambda x: x.kb)
    H, V, W = state.H.contiguous(), state.V, state.W
    _, B = get_backend("auto", b.vals.device).procrustes_b_bucket(
        b, H, W[b.subject_ids.long()] * b.subject_mask[:, None], V)
    Q = solve_q(B) * b.subject_mask[:, None, None]
    _, Bs = get_backend("staged").procrustes_b_bucket(
        bs, H, W[bs.subject_ids.long()] * bs.subject_mask[:, None], V)
    Qs = solve_q(Bs) * bs.subject_mask[:, None, None]
    half = torch.bfloat16
    variant = {   # the variant each launch takes, where a kernel has several
        "fused_procrustes_b": lambda a: fused.procrustes_b_variant(a[0], a[1].shape[-1]),
        "fused_mode2_compact": lambda a: fused.mode2_compact_fused_variant(a[0], a[1].shape[-1]),
        "fused_ykv": lambda a: fused.ykv_fused_variant(a[0], a[1].shape[-1]),
        "ykv": lambda a: ykv.ykv_variant(*a),
        "mode2_compact": lambda a: mttkrp_mode2.mode2_compact_variant(a[0], a[3]),
        "mode3": lambda a: mttkrp_mode3.mode3_variant(a[0], a[1]),
        "scoo_xk_times_v": lambda a: scoo.scoo_xk_times_v_variant(*a[:5], row_ends=a[5]),
        "scoo_project": lambda a: scoo.scoo_project_variant(*a[:5], cperm=a[5],
                                                            col_ends=a[6]),
    }
    args = {n: a[0] for n, a in half_kernel_args(b, bs, H, V, W, Q, Qs, half).items()}
    K, I, C = b.vals.shape
    R = H.shape[0]
    xa = args["scoo_xk_times_v"]
    csr = {}

    def sparse_half():          # the bucket's CSR at half width, made at the first call
        if "A" not in csr:
            csr["A"] = block_csr(bs).to(half)
        return torch.sparse.mm(csr["A"], xa[3].reshape(-1, R))

    def sparse_half_t():        # the transposed CSR at half width (row 12's yardstick)
        if "At" not in csr:
            csr["At"] = block_csr(bs, transpose=True).to(half)
        return torch.sparse.mm(csr["At"], qsh.reshape(-1, R))

    # one PyTorch call a function, on the same operands with every f32 one
    # (Q, H, Wb, the masks) cast to bf16 as well: no call takes half values
    # beside f32 ones, so these compute the function with all products at
    # bf16 (a yardstick of time only)
    vh, gh = args["fused_ykv"][0], args["fused_ykv"][2]
    yh = args["mode3"][0]
    qh, hh, qsh = Q.to(half), H.to(half), Qs.to(half)
    Wbh = args["fused_procrustes_b"][2].to(half)
    Wrh, mh = args["mode1"][2].to(half), b.subject_mask.to(half)
    cmh = b.col_mask.to(half)
    library = {"fused_procrustes_b": lambda: torch.bmm(args["fused_procrustes_b"][0],
                                                       args["fused_procrustes_b"][1]),
               "fused_mode2_compact": lambda: torch.einsum("kic,kir,rl,kl,kc->kcl", vh, qh, hh,
                                                           Wbh, cmh),
               "fused_ykv": lambda: torch.einsum("kir,kic,kcl->krl", qh, vh, gh),
               "ykv": lambda: torch.bmm(*args["ykv"]),
               "mode1": lambda: torch.einsum("krc,kcl,kl,k->rl", yh, gh, Wrh, mh),
               "mode2_compact": lambda: torch.einsum("krc,rl,kl,kc->kcl", yh, hh, Wbh, cmh),
               "mode3": lambda: torch.einsum("krc,kcl,rl,k->kl", yh, gh, hh, mh),
               "scoo_xk_times_v": sparse_half, "scoo_project": sparse_half_t}
    rows = []
    for name in HALF_KERNELS:
        wrapper, plain, source = kernels()[name]
        a = args[name]
        if name in SCOO:
            nbytes, ops = sparse_work_half(name, bs, R)
            where = f"Kb={bs.kb} I={bs.i_pad} C={bs.c_pad} N={bs.n_pad}"
        else:
            nbytes, ops = work_half(name, K, I, C, R)
            where = f"K={K} I={I} C={C}"
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / HALF_FLOPS * 1e3
        lib_ms, lib_note = None, ""
        if name in library:
            try:
                lib_ms = time_ms(library[name])
            except (RuntimeError, TypeError, NotImplementedError) as e:   # a yardstick only
                lib_note = f" (library call refused: {str(e).splitlines()[0][:80]})"
        r = {"name": f"{name}[bf16]", "precision": "bf16", "route": "cuda", "source": source,
             "replaces": REPLACES[name], "launches": per_kernel[name],
             "max_abs_err": errs[(name, "bf16")][0], "max_abs_plain": errs[(name, "bf16")][1],
             "max_abs_err_f16": errs[(name, "f16")][0],
             "ms": time_ms(lambda: wrapper(*a)), "plain_ms": time_ms(lambda: plain(*a)),
             "graph_ms": graph_ms(lambda: wrapper(*a), torch.cuda.Stream()),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": lib_ms}
        if name in variant:
            r["variant"] = variant[name](a)
        rows.append(r)
        print(f"[time] {name} bf16 at {where} R={R}: kernel {r['ms']:.4f} ms, in a graph "
              f"{r['graph_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nbytes} B at half width, {ops} ops), plain {r['plain_ms']:.4f} ms, library "
              f"{'none' if lib_ms is None else format(lib_ms, '.4f') + ' ms'}{lib_note}, "
              f"launches {r['launches']}, variant {r.get('variant', 'one design')}", flush=True)
    return rows


def check_constrained_launches(label: str, got: dict, n_buckets: int, specs: dict) -> None:
    """A constrained fit's launches: the route's main-path kernels buckets x
    iterations times each, P2 once per prox of a smooth W (the duals'
    start, then ``admm_iters`` = 10 an iteration), no other kernel."""
    want = dict.fromkeys(ON_MAIN_PATH[label], n_buckets * ITERS)
    if specs.get("w", "").startswith("smooth"):
        want["tridiag_solve"] = 1 + 10 * ITERS
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label} with {specs}: {name} launched {n} times, want {want.get(name, 0)}")


def phase3_constrained(bt, bt_sc) -> dict:
    """The constraint layer at the main path's width: choa 0.25, rank 5, 20
    iterations, f32, with ``CONSTRAINED``'s specs, on CC auto and SCOO
    staged (``CONSTRAINED_ROUTES``) beside the CC torch route with the same
    specs: the host engine, then the scan engine at check_every 10 and 0,
    each history and state bit for bit the host engine's and within 1e-4 of the CC
    torch route's, the launches (``check_constrained_launches``) and the
    replayed ms/iter; no host sync in an eager step or a chunk replay; then
    choa 0.002 in f64 through ``decompose.main --constraint`` on the card
    against the port's own CPU run, within 1e-8. Returns the ms/iter by run,
    P2's launches on CC auto and CC auto's fitted l1-smooth state."""
    import numpy as np
    import torch
    from repro_torch.core import Parafac2Options, als_step, engine, init_state
    from repro_torch.launch import decompose as dec

    data_of = {"torch": (bt, "torch"), "auto": (bt, "auto"), "staged-scoo": (bt_sc, "staged")}
    kw = dict(rank=5, iters=ITERS, tol=0.0, seed=0, dtype=torch.float32, verbose=False)
    out = {"ms": {}}
    for cname, specs in CONSTRAINED.items():
        hist = {}
        for label in ("torch",) + tuple(CONSTRAINED_ROUTES):
            data, backend = data_of[label]
            dec.decompose(data, backend=backend, constraints=specs, **{**kw, "iters": 2})
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, h, secs = dec.decompose(data, backend=backend, constraints=specs, **kw)
            counts = launches()
            added = (torch.cuda.max_memory_allocated() - resident) / 2**30
            check_constrained_launches(label, counts, len(data.buckets), specs)
            if len(h) != ITERS or not np.all(np.isfinite(h)):
                fail(f"{cname} {label}: fit history short or not finite")
            hist[label] = h
            out["ms"][f"{cname} {label} host"] = secs / ITERS * 1e3
            d_torch = float(np.max(np.abs(np.asarray(h) - np.asarray(hist["torch"]))))
            print(f"[constrained] {cname} {specs} {label}, host engine: "
                  f"{secs / ITERS * 1e3:.2f} ms/iter, {added:.3f} GiB above what was held, "
                  f"fit {h[-1]:.6f}, max |fit - torch (CC)| {d_torch:.3e}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
            print(f"[constrained] {cname} {label} fit history {json.dumps(h)}", flush=True)
            if d_torch > 1e-4:
                fail(f"{cname} {label}: fit history differs from the torch route's by "
                     f"{d_torch:.3e} > 1e-4")
            if label == "auto" and cname == "l1-smooth":
                out["p2_launches"], out["state"] = counts["tridiag_solve"], state
            if label == "torch":
                continue
            for ce in (10, 0):
                s_scan, hs, secs_s = dec.decompose(data, backend=backend, constraints=specs,
                                                   engine="scan", check_every=ce, **kw)
                counts = launches()
                check_constrained_launches(label, counts, len(data.buckets), specs)
                if hs != h or hs[-1] != float(s_scan.fit):
                    d = float(np.max(np.abs(np.asarray(hs) - np.asarray(h))))
                    fail(f"{cname} {label} scan{ce}: fit history not bit for bit the host "
                         f"engine's (max difference {d:.3e})")
                got, want = engine._flatten(s_scan), engine._flatten(state)
                if [k for k, _ in got] != [k for k, _ in want] or not all(
                        torch.equal(x, y) for (_, x), (_, y) in zip(got, want)):
                    fail(f"{cname} {label} scan{ce}: the state (H, V, W or a dual) is not bit "
                         f"for bit the host engine's")
                setup, warm, steady = steady_ms(data, backend, ce, specs)
                out["ms"][f"{cname} {label} scan{ce}"] = steady
                print(f"[constrained] {cname} {label} scan{ce}: {steady:.2f} ms/iter "
                      f"replayed (host engine {secs / ITERS * 1e3:.2f}), set-up {setup:.2f}s "
                      f"({warm} warm-up launches kept apart), the fit with set-up "
                      f"{secs_s / ITERS * 1e3:.2f} ms/iter; history and every state tensor "
                      f"bit for bit the host engine's; launches { {k: v for k, v in counts.items() if v} }",
                      flush=True)
        for label in CONSTRAINED_ROUTES:
            data, backend = data_of[label]
            opts = Parafac2Options(rank=5, backend=backend, dtype=torch.float32,
                                   constraints=specs)
            s = als_step(data, init_state(data, opts, seed=0), opts)
            chunk = engine.make_als_chunk(data, scan_opts(backend, 10, specs), 10, state=s)
            torch.cuda.synchronize()
            for what, call in (("an eager als_step", lambda: als_step(data, s, opts)),
                               ("a replay of a captured chunk", lambda: chunk(s))):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    call()
                except RuntimeError as e:
                    fail(f"{cname} {label}: {what} synchronised with the host: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
            del chunk
        print(f"[constrained] {cname}: no host sync (set_sync_debug_mode('error')) in one "
              f"eager als_step or one chunk replay on {', '.join(CONSTRAINED_ROUTES)}",
              flush=True)

    for cname, specs in CONSTRAINED.items():
        common = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters",
                  str(ITERS), "--tol", "0", "--dtype", "float64", "--constraint",
                  ",".join(f"{m}={v}" for m, v in specs.items())]
        cpu = dec.main(common + ["--device", "cpu", "--backend", "torch"])
        for backend, fmt in (("auto", "cc"), ("staged", "scoo")):
            gpu = dec.main(common + ["--device", "cuda", "--backend", backend, "--format", fmt,
                                     "--json", str(OUT / f"decompose_f64_{cname}_{backend}_{fmt}.json")])
            d = float(np.max(np.abs(np.asarray(gpu["fit_history"])
                                    - np.asarray(cpu["fit_history"]))))
            label = "auto" if fmt == "cc" else "staged-scoo"
            check_constrained_launches(label, gpu["kernel_launches"], len(gpu["buckets"]), specs)
            print(f"[constrained] scale 0.002 f64 {cname} {backend}/{fmt} on the card: max "
                  f"|fit - the port's CPU run| = {d:.3e}; constraints {gpu['constraints']}",
                  flush=True)
            if d > 1e-8:
                fail(f"f64 {cname} {backend}/{fmt}: the card's fit history differs from the "
                     f"CPU's by {d:.3e} > 1e-8")
    return out


def phase3_compress(bt, bt_sc, hist: dict) -> dict:
    """The compression path (``compress="rsvd"``: S = 18 at rank 5) on the
    main path's choa 0.25 buckets, on CC auto, CC staged and SCOO staged:
    the pass alone (seconds, captured energy, the GiB the cores and bases
    hold, its peak), the core ALS alone (host engine ms/iter after two
    warm-up iterations, each core kernel buckets x iterations times and no
    other; scan engine replays), then the entry point end to end
    (``decompose(..., compress="rsvd")``: pass, core fit, expansion, exact
    fit) on the host and scan (check_every 10) engines: the GiB the fit
    adds, the core kernels launched, the history within 1e-3 relative of
    the route's uncompressed history (``hist``) and its last entry, the
    exact fit at a fresh Q, within 1e-3 relative of the uncompressed final
    state's exact fit at a fresh Q (``exact_fit`` on the original buckets),
    scan bit for bit the host.
    Then choa 0.002 in f64 through ``decompose.main --compress`` on the card
    (CC auto, SCOO staged) within 1e-8 of the port's CPU run. Returns CC
    auto's pass and fitted state, the core ms/iter and each kernel's
    launches on the cores."""
    import numpy as np
    import torch
    from repro_torch.core import Parafac2Options, parse_preprocess_spec
    from repro_torch.core import compress as cmp_mod
    from repro_torch.core import parafac2 as p2
    from repro_torch.core.backend import get_backend
    from repro_torch.launch import decompose as dec

    pp = parse_preprocess_spec(COMPRESS)
    kw = dict(rank=5, iters=ITERS, tol=0.0, seed=0, dtype=torch.float32, verbose=False)
    out = {"ms": {}, "launches": {}}
    for label, (fmt, backend) in COMPRESS_ROUTES.items():
        data = bt if fmt == "cc" else bt_sc
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = pp.apply(data, Parafac2Options(rank=5, backend=backend), seed=0)
        torch.cuda.synchronize()
        t_pass = time.perf_counter() - t0
        pass_launches = {k: v for k, v in launches().items() if v}
        held = (torch.cuda.memory_allocated() - resident) / 2**30
        pass_peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        energy = comp.core_norm_sq / comp.data.norm_sq
        nb = sum(cb.compressed for cb in comp.buckets)
        if nb != len(data.buckets) or pass_launches != {"gram_inv_sqrt": nb}:
            fail(f"{label}: the pass compressed {nb} of {len(data.buckets)} buckets, "
                 f"launches {pass_launches} (want P1 once a bucket)")
        core_shapes = [tuple(cb.core.vals.shape) for cb in comp.buckets]
        dec.decompose(comp.data, backend=backend, **{**kw, "iters": 2})     # warm-up
        _, h_core, secs = dec.decompose(comp.data, backend=backend, **kw)
        counts = launches()
        check_launches(label, counts, nb * ITERS, ON_CORES)
        out["launches"][label] = counts
        out["ms"][label] = secs / ITERS * 1e3
        setup, _, out["ms"][f"{label} scan10"] = steady_ms(comp.data, backend, 10)
        if label == "auto":
            out["comp"], out["range_launches"] = comp, pass_launches["gram_inv_sqrt"]
        del comp
        runs = {}
        for engine in ("host", "scan"):
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, h, secs = dec.decompose(data, backend=backend, engine=engine,
                                           check_every=10, compress=COMPRESS, **kw)
            added = (torch.cuda.max_memory_allocated() - resident) / 2**30
            runs[engine] = (state, h, secs, launches(), added)
            if len(h) != ITERS or not np.all(np.isfinite(h)) or h[-1] != float(state.fit):
                fail(f"{label} {engine} compressed: fit history short, not finite or its last "
                     f"entry not the state's exact fit")
            missing = [k for k in ON_CORES[label] if not runs[engine][3][k]]
            if missing:
                fail(f"{label} {engine} compressed: {missing} did not launch on the cores")
        (s_host, h_host, secs_host, c_host, add_host), (s_scan, h_scan, secs_scan, _, add_scan) = \
            runs["host"], runs["scan"]
        # like with like: the engines' entries take the step-start Q on both
        # paths; the last compressed entry is the exact fit at a fresh Q, so
        # it is held to the uncompressed final state's exact fit at a fresh Q
        s_un, h_un, _ = dec.decompose(data, backend=backend, **kw)
        opts_un = Parafac2Options(rank=5, backend=backend)
        be = get_backend(backend, data.device)
        Qs = [p2._procrustes_project(b, s_un.H, s_un.V, s_un.W, opts_un, i, be)[2]
              for i, b in enumerate(data.buckets)]
        exact_un = float(cmp_mod.exact_fit(data, s_un, opts_un, Qs))
        del Qs, s_un
        rel_hist = max(abs(a - b) / abs(b) for a, b in zip(h_host[:-1], hist[label][:-1]))
        rel = abs(h_host[-1] - exact_un) / abs(exact_un)
        raw = abs(h_host[-1] - hist[label][-1]) / abs(hist[label][-1])
        bitwise = h_scan == h_host and torch.equal(s_scan.V, s_host.V)
        if label == "auto":
            out["state"] = s_host
        print(f"[compress] {label} ({fmt} buckets, backend {backend}) {COMPRESS}: pass "
              f"{t_pass:.3f}s, captured energy {energy:.6f}, cores {core_shapes}, the cores "
              f"and bases hold {held:.3f} GiB (pass peak {pass_peak:.3f} GiB above what it "
              f"found); core ALS {out['ms'][label]:.2f} ms/iter on the host engine (the "
              f"uncompressed route's is in [main]), {out['ms'][f'{label} scan10']:.2f} ms/iter "
              f"replayed (scan 10, set-up {setup:.2f}s); core launches "
              f"{ {k: v for k, v in counts.items() if v} }; the entry point end to end: host "
              f"{secs_host:.3f}s ({secs_host / ITERS * 1e3:.2f} ms/iter with the pass and the "
              f"expansion), scan 10 {secs_scan:.3f}s, GiB added host {add_host:.3f}, scan "
              f"{add_scan:.3f}; launches { {k: v for k, v in c_host.items() if v} }; "
              f"iterations 1-{ITERS - 1} within {rel_hist:.3e} relative of the uncompressed "
              f"history (step-start Q on both; the uncompressed rerun bit for bit phase 3's: "
              f"{h_un == hist[label]}); final exact fit {h_host[-1]:.6f} against the "
              f"uncompressed final state's exact fit {exact_un:.6f} ({rel:.3e} relative) and "
              f"its last history entry {hist[label][-1]:.6f} ({raw:.3e} relative: the fresh Q's "
              f"one-step gain); scan bit for bit the host: {bitwise}", flush=True)
        print(f"[compress] {label} core fit history {json.dumps(h_core)}; end to end "
              f"{json.dumps(h_host)}", flush=True)
        if rel > 1e-3 or rel_hist > 1e-3:
            fail(f"{label} compressed: final exact fit {rel:.3e} relative from the uncompressed "
                 f"one, or the history {rel_hist:.3e} from the uncompressed history (> 1e-3)")
        if not bitwise:
            fail(f"{label} compressed: the scan engine's history or V is not bit for bit the "
                 f"host engine's")
        del runs, s_host, s_scan
        free_cached(f"the compressed {label} fits")

    common = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", str(ITERS),
              "--tol", "0", "--dtype", "float64", "--compress", COMPRESS]
    for backend, fmt in (("auto", "cc"), ("staged", "scoo")):
        cpu = dec.main(common + ["--device", "cpu", "--backend", "torch", "--format", fmt])
        gpu = dec.main(common + ["--device", "cuda", "--backend", backend, "--format", fmt,
                                 "--json", str(OUT / f"decompose_f64_compress_{backend}_{fmt}.json")])
        d = float(np.max(np.abs(np.asarray(gpu["fit_history"]) - np.asarray(cpu["fit_history"]))))
        block = gpu["resolved_options"]["compress"]
        label = "auto" if fmt == "cc" else "staged-scoo"
        missing = [k for k in ON_CORES[label] if not gpu["kernel_launches"][k]]
        print(f"[compress] scale 0.002 f64 {backend}/{fmt} {COMPRESS} on the card: max |fit - "
              f"the port's CPU run| = {d:.3e}; compress block {block}; launches "
              f"{ {k: v for k, v in gpu['kernel_launches'].items() if v} }", flush=True)
        if d > 1e-8 or missing or block != {"spec": "rsvd", "sketch_dim": 18, "power_iters": 1}:
            fail(f"f64 compressed {backend}/{fmt}: the card's fit differs from the CPU's by "
                 f"{d:.3e} (> 1e-8), or {missing} did not launch, or the block is {block}")
    return out


def same_state(a, b) -> bool:
    """Every tensor of two ``Parafac2State``s equal bit for bit."""
    import torch
    from repro_torch.core import engine

    la, lb = engine._flatten(a), engine._flatten(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


MESH_ROUTES = (("auto", "cc"), ("staged", "scoo"))   # phase3_mesh (a): backend, format
MESH_SHARDS = 4         # phase3_mesh (b): the rank shards of the balanced plan
CU_GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
                       5: "empty", 6: "wait_event", 7: "event_record", 10: "mem_alloc",
                       11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_nodes(graph) -> dict:
    """The nodes of a kept CUDA graph (``keep_graph=True``) by kind, and its
    kernel nodes whose function name starts with ``nccl`` (``nccl``), read
    from the driver (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``)."""
    import collections
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes could not count the mesh chunk's nodes")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes could not list the mesh chunk's nodes")
    kinds, nccl = collections.Counter(), 0
    params = ctypes.create_string_buffer(256)      # CUDA_KERNEL_NODE_PARAMS: func first
    name = ctypes.c_char_p()
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType could not read a node's kind")
        kinds[CU_GRAPH_NODE_KINDS.get(kind.value, str(kind.value))] += 1
        if kind.value == 0 and cu.cuGraphKernelNodeGetParams(ctypes.c_void_p(node),
                                                             params) == 0:
            func = ctypes.c_void_p.from_buffer(params).value
            if cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)) == 0:
                nccl += (name.value or b"").lower().startswith(b"nccl")
    return {"nodes": dict(kinds), "nccl": nccl}


def stage_rows(b, be, H, V, W, J: int) -> tuple:
    """One bucket's per-subject stage outputs through the route's kernels
    (F1's XkV and B, the polar's Q on P1, F4's G, F3's A) and its partial
    sums over subjects (M1 through F2, the mode-2 scatter's M2, the mode-3
    rows as M3, the fit's delta), at fixed H, V and a global W."""
    import torch
    from repro_torch.core.procrustes import solve_q

    Wb = W[b.subject_ids.long()] * b.subject_mask[:, None]
    XkV, B = be.procrustes_b_bucket(b, H, Wb, V, b.gather_v(V))
    Q = solve_q(B, "gram_eigh") * b.subject_mask[:, None, None]
    proj = be.project_bucket(b, Q)
    G = be.ykv_bucket(b, proj, V)
    A = be.mode2_bucket(b, proj, H, Wb)
    M3 = torch.zeros_like(W)
    M3[b.subject_ids[: b.n_real].long()] = be.mode3_bucket(b, proj, H, YkV=G)[: b.n_real]
    delta = (-2.0 * torch.einsum("rl,krl,kl,k->", H, G, Wb, b.subject_mask)
             + torch.einsum("rl,rl,kr,kl,k->", H.T @ H, V.T @ V, Wb, Wb, b.subject_mask))
    sums = {"M1": be.mode1_xkv_bucket(b, Q, XkV, Wb),
            "M2": be.mode2_scatter(A, b.cols, J, order=(b.scatter_perm, b.scatter_ends)),
            "M3": M3, "delta": delta}
    return {"XkV": XkV, "B": B, "Q": Q, "G": G, "A": A}, sums


def bucket_bytes(bt) -> dict:
    """Device bytes of ``bt``'s buckets: in all, in the column sort of the
    kept entries (``scatter_perm``) and its [J] column ends, and per bucket
    one subject slot's share of the rest."""
    def nb(t):
        return t.numel() * t.element_size()

    perm = [nb(b.scatter_perm) for b in bt.buckets]
    ends = [nb(b.scatter_ends) for b in bt.buckets]
    alls = [b.nbytes() for b in bt.buckets]
    return dict(all=sum(alls), perm=sum(perm), ends=sum(ends),
                slot=[(a - p - e) / b.kb for a, p, e, b in zip(alls, perm, ends, bt.buckets)])


def phase3_mesh(bt, bt_sc, state, data) -> None:
    """The mesh engine on the card, in two parts (one card: a world of more
    than one rank runs only on the CPU, over gloo, in the CPU tests).

    (a) A world of one over NCCL (an in-memory ``HashStore``): CC auto and
    SCOO staged, rank 5, f32, 20 iterations, at check_every 10 and 0: the
    history and every state tensor bit for bit the scan engine's on the same
    data, the same kernel launches under replay, the subject all-reduces
    issued inside the capture (4 an iteration with a global W: M1, M2, M3
    and the fit's delta; a graph of the chunk's nodes by kind, NCCL's
    kernels among them), the bytes all-reduced an iteration, and the second
    fit's ms/iter with set-up (the kept chunk replayed) beside the scan
    engine's. The group is destroyed at the end.

    (b) The shard cut on the kernels, in one process: choa 0.25's CC plan
    nnz-balanced for ``MESH_SHARDS`` ranks, each rank's shard bucketized on
    its own (``bucketize(shard=...)``). Per bucket, each shard's per-subject
    stage outputs through the hand kernels (F1's XkV and B, P1's Q, F4's G,
    F3's A) at the main path's H, V and W must equal the unsharded buckets'
    rows for the same subjects bit for bit; the shards' partial M1, M2, M3
    and delta, summed, the unsharded ones within the f32 stage tolerance
    (1e-6 of the output's largest magnitude); each shard's device bytes at
    most a quarter of the unsharded buckets' plus one subject slot a bucket
    (the padding), its [J] column ends and its kept entries' excess in the
    column sort."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core import bucketize, engine, fit
    from repro_torch.core.backend import get_backend
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import decompose as dec
    from repro_torch.launch import mesh as lm

    # ---- (a) a world of one over NCCL ------------------------------------
    dev = lm.init_distributed("cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"the mesh phase's world is {dist.get_backend()} x {dist.get_world_size()}, "
             f"not NCCL x 1")
    lm.local_mesh(dev)
    base_graph = torch.cuda.CUDAGraph
    kept = []

    def kept_graph(keep_graph: bool = True):
        """A CUDA graph that keeps its cudaGraph_t, for its nodes (what the
        engine makes while ``torch.cuda.CUDAGraph`` is this)."""
        g = base_graph(keep_graph=True)
        kept.append(g)
        return g

    kw = dict(max_iters=ITERS, tol=0.0, seed=0)

    def timed_fit(b_, opts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, h = fit(b_, opts, **kw)
        torch.cuda.synchronize()
        return s, h, (time.perf_counter() - t0) / ITERS * 1e3

    per_iter = 4 * (engine.WARMUP_ITERS + 1)      # all-reduces: warm-up and capture
    for backend, fmt in MESH_ROUTES:
        b_ = bt if fmt == "cc" else bt_sc
        for ce in (10, 0):
            label = f"{fmt.upper()} {backend}, check_every {ce}"
            opts = scan_opts(backend, ce)
            mesh_opts = dataclasses.replace(opts, engine="mesh")
            engine.clear_chunk_cache()
            torch.cuda.CUDAGraph = kept_graph
            try:
                kept.clear()
                s_scan, h_scan, _ = timed_fit(b_, opts)
                scan_graph = graph_nodes(kept[-1])
                reset_launches()
                _, _, scan_ms = timed_fit(b_, opts)     # the kept chunk replayed
                scan_launches = launches()
                kept.clear()
                dsh.COLLECTIVES.reset()
                s_mesh, h_mesh, first_ms = timed_fit(b_, mesh_opts)
                calls, nbytes = dsh.COLLECTIVES.calls, dsh.COLLECTIVES.bytes
                mesh_graph = graph_nodes(kept[-1])
                reset_launches()
                s_mesh2, h_mesh2, mesh_ms = timed_fit(b_, mesh_opts)
                mesh_launches = launches()
            finally:
                torch.cuda.CUDAGraph = base_graph
            if dsh.COLLECTIVES.calls != calls:
                fail(f"mesh {label}: the kept chunk's second fit issued all-reduces from "
                     f"Python (they belong to the graph)")
            if not (h_mesh == h_scan and same_state(s_mesh, s_scan)
                    and h_mesh2 == h_scan and same_state(s_mesh2, s_scan)):
                fail(f"mesh {label}: not bit for bit the scan engine")
            if mesh_launches != scan_launches:
                fail(f"mesh {label}: replays launched {mesh_launches}, scan {scan_launches}")
            if calls != per_iter:
                fail(f"mesh {label}: {calls} all-reduces in the warm-up and capture, "
                     f"not {per_iter}")
            print(f"[mesh] world of one (NCCL), {label}: bit for bit the scan engine "
                  f"(history and every state tensor, both fits), the same launches; "
                  f"{calls // (engine.WARMUP_ITERS + 1)} all-reduces an iteration in the "
                  f"capture, {nbytes // (engine.WARMUP_ITERS + 1)} bytes an iteration; "
                  f"graph nodes {mesh_graph['nodes']} ({mesh_graph['nccl']} NCCL kernels) "
                  f"against the scan chunk's {scan_graph['nodes']}; second fit "
                  f"{mesh_ms:.3f} ms/iter with set-up (scan {scan_ms:.3f}; the mesh's first "
                  f"fit, with its capture, {first_ms:.3f})", flush=True)
    lm.shutdown()
    free_cached("the world-of-one mesh fits")

    # ---- (b) the shard cut on the kernels ----------------------------------
    n = MESH_SHARDS
    plan, balance = dec.plan_data(data, buckets=4, format="cc", n_shards=n)
    fmts = ["cc"] * plan.n_buckets
    t0 = time.perf_counter()
    shards = [bucketize(data, dtype=torch.float32, device=dev, plan=plan, formats=fmts,
                        subject_align=n, shard=(r, n)) for r in range(n)]
    torch.cuda.synchronize()
    print(f"[mesh] choa {MAIN_SCALE} CC cut into {n} rank shards in "
          f"{time.perf_counter() - t0:.1f}s; nnz imbalance "
          f"{balance['imbalance_unbalanced']:.4f} -> {balance['imbalance_max_over_mean']:.4f}"
          f" (max/mean)", flush=True)
    if [(b.i_pad, b.c_pad) for b in bt.buckets] != list(plan.shapes):
        fail("the balanced plan's buckets are not the main path's")
    whole = bucket_bytes(bt)
    for r, sh in enumerate(shards):
        got = bucket_bytes(sh)
        bound = (whole["all"] / n + sum(whole["slot"]) + got["ends"]
                 + max(0.0, got["perm"] - whole["perm"] / n))
        print(f"[mesh] shard {r}: {got['all']} device bytes ({got['all'] / 2**30:.3f} GiB), "
              f"a quarter of the whole {whole['all'] / n:.0f}, bound {bound:.0f}", flush=True)
        if got["all"] > bound:
            fail(f"shard {r} holds {got['all']} bytes, more than {bound:.0f}")
    be = get_backend("auto", dev)
    H, V, W = state.H.float(), state.V.float(), state.W.float()
    J = bt.n_cols
    reset_launches()
    total = {}
    sums_whole = {}
    for i, b in enumerate(bt.buckets):
        rows_w, sums = stage_rows(b, be, H, V, W, J)
        for k, v in sums.items():
            sums_whole[k] = sums_whole.get(k, 0) + v
        slot = torch.full((bt.n_subjects,), -1, dtype=torch.long, device=dev)
        slot[b.subject_ids[: b.n_real].long()] = torch.arange(b.n_real, device=dev)
        for r, sh in enumerate(shards):
            sb = sh.buckets[i]
            rows_s, sums = stage_rows(sb, be, H, V, W, J)
            for k, v in sums.items():
                total[k] = total.get(k, 0) + v
            at = slot[sb.subject_ids[: sb.n_real].long()]
            for k, v in rows_s.items():
                if not torch.equal(v[: sb.n_real], rows_w[k][at]):
                    fail(f"shard {r} bucket {i}: {k} rows differ from the unsharded rows")
        del rows_w
    counts = launches()
    for k in ("fused_procrustes_b", "fused_mode1_xkv", "fused_mode2_compact", "fused_ykv",
              "gram_inv_sqrt"):
        if not counts.get(k):
            fail(f"the shard stages did not launch {k}")
    errs = []
    for k, v in total.items():
        err, ok = within(v, sums_whole[k], False)
        errs.append(f"{k} {err / max(1.0, float(sums_whole[k].abs().max())):.3e}")
        if not ok:
            fail(f"the shards' {k} partials summed differ from the unsharded {k} by {err:.3e}")
    print(f"[mesh] {n} shards through the hand kernels: XkV, B, Q, G, A bit for bit the "
          f"unsharded rows of every subject; partial sums against the unsharded, over "
          f"the largest magnitude: {', '.join(errs)} (f32 tolerance 1e-6); launches "
          f"{ {k: counts[k] for k in sorted(counts) if counts[k]} }", flush=True)
    del shards


def phase3_stream(bt, state, data) -> dict:
    """The serving layer at choa 0.25, rank 5, f32: the synthetic stream of
    ``data`` (warm fraction 0.6), a service per ``STREAM_RUNS`` entry warm
    started by 20 iterations (a service of the same backend and format as
    an earlier one restores that one's warm checkpoint: the same fit), then
    the first ``STREAM_LIMIT`` payloads: the
    dispatch latency (p50/p99, host staging and device apart), subjects per
    second, each kernel's launches a dispatch (``ON_STREAM`` must launch,
    nothing else may), the ``_adopt`` pass's seconds; on the two 8-slot
    services, save, restore and one more batch bit for bit the uninterrupted
    service, and a cold refit bit for bit the batch fit over the union (its
    seconds), and the GiB a service with one refit adds. Then the same
    ``update_subjects`` pass ``_adopt`` makes over the whole 116,225-subject
    union (the main path's CC buckets, the main state), and the f64 choa
    0.002 replay on the card against the port's CPU (``kept_condition``).
    Returns the auto
    8-slot service and payloads it has not seen, for phase 5."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import Parafac2Options, fit, update_subjects
    from repro_torch.launch import decompose as dec
    from repro_torch.launch import stream

    t0 = time.perf_counter()
    warm, payloads = stream.synthetic_stream(data, warm_frac=0.6, seed=0)
    print(f"[stream] choa {MAIN_SCALE}: warm population {warm.n_subjects} subjects, "
          f"{warm.nnz} nnz; {len(payloads)} payloads "
          f"({sum('subject' in p for p in payloads)} accruals); split "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    served, warm_ckpt = {}, {}
    for backend, fmt, slots in STREAM_RUNS:
        label = f"{backend}-{fmt} x{slots}"
        opts = Parafac2Options(rank=5, backend=backend)
        kw = dict(batch_slots=slots, format=fmt, refit="cold", refit_iters=ITERS,
                  refit_tol=0.0, drift_threshold=float("inf"), device="cuda")
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if (backend, fmt) in warm_ckpt:     # the same warm fit: restored, not refitted
            t0 = time.perf_counter()
            svc = stream.StreamService.from_checkpoint(warm_ckpt[(backend, fmt)], warm, opts,
                                                       **kw)
            info = dict(fit=float("nan"), seconds=time.perf_counter() - t0, restored=True)
        else:
            svc, info = stream.StreamService.warm_start(warm, opts, iters=ITERS, tol=0.0,
                                                        seed=0, **kw)
            warm_ckpt[(backend, fmt)] = tempfile.mkdtemp(prefix="stream_warm_", dir=OUT)
            svc.save(warm_ckpt[(backend, fmt)])
        reset_launches()                                # counts from 0 for the stream
        t0 = time.perf_counter()
        for p in payloads[:STREAM_LIMIT]:
            svc.submit(p)
        svc.flush()
        stream_s = time.perf_counter() - t0
        counts = {k: v for k, v in launches().items() if v}
        st = svc.stats()
        lat = np.asarray(svc.batch_latencies) * 1e3
        host = np.asarray(svc.stage_latencies) * 1e3
        devp = lat - host
        pct = lambda a, q: float(np.percentile(a, q))  # noqa: E731
        per = {k: v / svc.n_batches for k, v in counts.items()}
        print(f"[stream] {label}: {st['appends']} appends in {st['batches']} dispatches "
              f"({stream_s:.2f}s); dispatch latency p50 {pct(lat, 50):.3f} ms, p99 "
              f"{pct(lat, 99):.3f} ms; host staging p50 {pct(host, 50):.3f} ms, p99 "
              f"{pct(host, 99):.3f} ms; device part (update, sync, copy back) p50 "
              f"{pct(devp, 50):.3f} ms, p99 {pct(devp, 99):.3f} ms; "
              f"{st['subjects_per_s']:.1f} subjects/s; launches a dispatch {per}; "
              f"geometries {st['compiled_geometries']} (I_pad, C_pad, N_pad "
              f"{svc._i_pad, svc._c_pad, svc._n_pad}); "
              + (f"warm state restored from the 8-slot service's warm checkpoint in "
                 f"{info['seconds']:.2f}s" if info.get("restored") else
                 f"warm fit {info['fit']:.6f} in {info['seconds']:.2f}s, its _adopt pass "
                 f"over {warm.n_subjects} subjects {svc.adopt_latencies[0]:.3f}s")
              + f"; stream_fit {st['stream_fit']:.6f}, drift {st['drift']:.3e}", flush=True)
        if set(counts) != set(ON_STREAM[backend]):
            fail(f"stream {label}: launched {sorted(counts)}, want {sorted(ON_STREAM[backend])}")
        if not np.isfinite(st["stream_fit"]) or st["appends"] != STREAM_LIMIT:
            fail(f"stream {label}: stream_fit not finite or appends short")
        if slots == 8:
            nxt = payloads[STREAM_LIMIT:STREAM_LIMIT + slots]
            ck = tempfile.mkdtemp(prefix="stream_ckpt_", dir=OUT)
            t0 = time.perf_counter()
            svc.save(ck)
            save_s = time.perf_counter() - t0
            back = stream.StreamService.from_checkpoint(ck, svc.union_data(), opts, **kw)
            for s_ in (svc, back):
                for p in nxt:
                    s_.submit(p)
                s_.flush()
            same = (np.array_equal(back.W, svc.W) and torch.equal(back.H, svc.H)
                    and torch.equal(back.V, svc.V)
                    and np.array_equal(back._sub_resid, svc._sub_resid)
                    and back.stream_fit == svc.stream_fit)
            del back
            t0 = time.perf_counter()
            rinfo = svc.refit(mode="cold")
            refit_s = time.perf_counter() - t0
            added = (torch.cuda.max_memory_allocated() - resident) / 2**30
            bt_u = svc._bucketize_union(svc.union_data())
            s_b, h_b = fit(bt_u, opts, max_iters=ITERS, tol=0.0, seed=0)
            W_b, _ = update_subjects(bt_u, s_b.H, s_b.V, opts, w_init=s_b.W)
            cold = (torch.equal(svc.H, s_b.H) and torch.equal(svc.V, s_b.V)
                    and rinfo["fit"] == h_b[-1] and np.array_equal(svc.W, W_b.cpu().numpy()))
            del bt_u, s_b, W_b
            print(f"[stream] {label}: save {save_s:.3f}s, restore and one more batch bit for "
                  f"bit the uninterrupted service: {same}; cold refit over "
                  f"{rinfo['n_subjects']} subjects {refit_s:.2f}s ({rinfo['iters']} "
                  f"iterations, fit {rinfo['fit']:.6f}; its _adopt pass "
                  f"{svc.adopt_latencies[-1]:.3f}s) bit for bit the batch fit over the "
                  f"union: {cold}; the service with one refit added {added:.3f} GiB of "
                  f"device memory", flush=True)
            if not (same and cold):
                fail(f"stream {label}: the restored service or the cold refit is not bit "
                     f"for bit its reference")
        if (backend, slots) == ("auto", 8):
            served = dict(svc=svc, payloads=payloads[STREAM_LIMIT + slots:
                                                     STREAM_LIMIT + 2 * slots])
        else:
            del svc
    del warm, payloads

    # the _adopt pass over the whole union: the main path's CC buckets
    opts = Parafac2Options(rank=5, backend="auto")
    for _ in range(2):                                  # the second one timed
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W_u, r_u = update_subjects(bt, state.H, state.V, opts, w_init=state.W)
        r_u.sum().item()
        union_s = time.perf_counter() - t0
    counts = {k: v for k, v in launches().items() if v}
    print(f"[stream] the _adopt pass over the whole union ({bt.n_subjects} subjects, "
          f"{len(bt.buckets)} CC buckets, auto): {union_s * 1e3:.3f} ms, launches "
          f"{counts}", flush=True)
    if set(counts) != set(ON_STREAM["auto"]) or not bool(torch.isfinite(W_u).all()):
        fail("the union pass did not launch F1, F4 and P1 alone, or gave non-finite rows")
    del W_u, r_u

    # f64 choa 0.002: the card against the port's CPU. The warm fits at the
    # model level; the serving path (the _adopt pass, then the dispatches)
    # from the same factors, the CPU warm fit's, on both devices
    small = dec.load_dataset("choa", 0.002, 0)
    warm, payloads = stream.synthetic_stream(small, warm_frac=0.6, seed=0)
    kw = dict(batch_slots=8, drift_threshold=float("inf"))
    for backend, fmt in (("auto", "cc"), ("staged", "scoo")):
        opts = Parafac2Options(rank=5, backend=backend, dtype=torch.float64)
        fits = {d: stream.StreamService.warm_start(warm, opts, iters=ITERS, tol=0.0,
                                                   format=fmt, device=d, **kw)
                for d in ("cpu", "cuda")}
        base = fits["cpu"][0]
        d_warm = max(abs(fits["cpu"][1]["fit"] - fits["cuda"][1]["fit"]),
                     abs(base.baseline_fit - fits["cuda"][0].baseline_fit))
        svcs = {}
        for device in ("cpu", "cuda"):
            svc = stream.StreamService(warm.subjects, warm.n_cols, opts, H=base.H.cpu(),
                                       V=base.V.cpu(), W=base.W, format=fmt, device=device,
                                       **kw)
            svc._adopt(svc._bucketize_union(svc.union_data()), base.H.cpu(), base.V.cpu(),
                       base.W)
            for p in payloads[:STREAM_F64]:
                svc.submit(p)
            svc.flush()
            svcs[device] = svc
        a, b = svcs["cpu"], svcs["cuda"]
        kappa = kept_condition(a)
        dw = np.abs(a.W - b.W).max(1) / np.maximum(1.0, np.abs(a.W).max(1))
        dr = np.abs(a._sub_resid - b._sub_resid) / np.maximum(1.0, a._sub_norm)
        well = kappa <= 1e4
        model = max(abs(a.stream_fit - b.stream_fit), abs(a.drift - b.drift),
                    abs(a.baseline_fit - b.baseline_fit))
        worst = int(np.argmax(dw))
        print(f"[stream] f64 choa 0.002 {backend}-{fmt}: warm fits and baselines, card against "
              f"CPU, within {d_warm:.3e}; from the CPU's warm factors, {STREAM_F64} payloads: "
              f"stream_fit, drift and baseline within {model:.3e}; the {int(well.sum())} of "
              f"{well.size} subjects whose kept Gram condition is at most 1e4: max |W| "
              f"{dw[well].max():.3e} of the row's largest magnitude, max |resid| "
              f"{dr[well].max():.3e} of ||X_k||^2; over all subjects max |W| {dw.max():.3e} "
              f"(subject {worst}, condition {kappa[worst]:.3e}), max |resid| {dr.max():.3e}",
              flush=True)
        if max(d_warm, model, dw[well].max(), dr[well].max()) > 1e-8:
            fail(f"f64 stream replay {backend}-{fmt}: card and CPU differ by more than 1e-8")
    return served


def kept_condition(svc):
    """Each subject's condition number of its Procrustes Gram B_k^T B_k at
    the service's W, over the spectrum the polar keeps (above 1e-12 of the
    largest), on the CPU: a W row moves by about that times 2^-53 under a
    rounding of H or V (the polar at a near-singular B_k), so card and CPU
    are held per subject on the well-conditioned subjects, and at the
    model level on all."""
    import numpy as np
    import torch
    from repro_torch.core.backend import get_backend

    bt = svc._bucketize_union(svc.union_data())
    W = torch.as_tensor(svc.W)
    H, V = svc.H.cpu(), svc.V.cpu()
    out = np.zeros(bt.n_subjects)
    for b in bt.buckets:
        _, B = get_backend("torch").procrustes_b_bucket(
            b, H, W[b.subject_ids.long()] * b.subject_mask[:, None], V)
        ev = torch.linalg.eigvalsh(B.transpose(1, 2) @ B)
        kept = torch.where(ev > ev[:, -1:] * 1e-12, ev, torch.full_like(ev, float("inf")))
        out[b.subject_ids[: b.n_real].long().numpy()] = (
            ev[:, -1] / kept.min(1).values)[: b.n_real].numpy()
    return out


def phase3_supervisor(bt) -> None:
    """The supervised scan fit on CC auto (scan 10, 20 iterations, f32):
    faultless, a blip (``--fail-at 1``), retries exhausted and a restore
    from disk (``--fail-at 1:5``), a NaN rollback (``--nan-at 1``) and a
    resume after 10 iterations, each bit for bit the bare scan fit (history
    and every state tensor), each twice; ms/iter of each (the faster call)
    beside the bare fit's, with and without a chunk cache shared across
    calls; a checkpoint write's
    seconds; a ridge escalation's fit (``nan_steps={1: 2}``)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import fit
    from repro_torch.dist import FaultInjector, SupervisorConfig, supervised_fit

    opts = scan_opts("auto", 10)
    kw = dict(max_iters=ITERS, tol=0.0, seed=0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / ITERS * 1e3

    (s_bare, h_bare), bare_ms = timed(lambda: fit(bt, opts, **kw))
    print(f"[supervisor] bare scan fit (CC auto, check_every 10, {ITERS} iterations): "
          f"{bare_ms:.2f} ms/iter with its capture, fit {h_bare[-1]:.6f}", flush=True)

    def run(label, make_cfg):
        """Two supervised fits of ``make_cfg()`` (fresh injectors, fresh
        directories), both bit for bit the bare fit; the faster reported
        (a call's set-up, its capture, moves by ~0.1 s between calls)."""
        mss = []
        for _ in range(2):
            cfg = SupervisorConfig(**make_cfg())
            (s, h, rep), ms = timed(lambda: supervised_fit(bt, opts, config=cfg, **kw))
            mss.append(ms * ITERS / (ITERS - (rep.resumed_from_step or 0)))   # iterations run
            if not (h == h_bare and same_state(s, s_bare)):
                fail(f"supervised {label}: not bit for bit the bare scan fit")
        print(f"[supervisor] {label}: {min(mss):.2f} ms/iter (bare {bare_ms:.2f}; both calls "
              f"{mss[0]:.2f}, {mss[1]:.2f}); retries {rep.retries}, restores {rep.restores}, "
              f"rollbacks {rep.rollbacks}, checkpoints {rep.checkpoints_written}; both bit "
              f"for bit the bare scan fit", flush=True)
        return rep

    def resumed():
        ck = tempfile.mkdtemp(prefix="sup_resume_", dir=OUT)
        supervised_fit(bt, opts, config=SupervisorConfig(ckpt_dir=ck),
                       **{**kw, "max_iters": 10})
        return dict(ckpt_dir=ck, resume=True)

    run("faultless", dict)
    run("--fail-at 1", lambda: dict(injector=FaultInjector({1: 1})))
    rep = run("--fail-at 1:5 --ckpt-dir", lambda: dict(
        injector=FaultInjector({1: 5}), ckpt_dir=tempfile.mkdtemp(prefix="sup_ckpt_", dir=OUT)))
    if rep.restores != 1:
        fail("--fail-at 1:5 did not restore from the checkpoint")
    rep = run("--nan-at 1", lambda: dict(injector=FaultInjector(nan_steps=[1])))
    if rep.rollbacks != 1:
        fail("--nan-at 1 did not roll back")
    rep = run("resume after 10 iterations (the resumed call)", resumed)
    if rep.resumed_from_step != 10:
        fail("the resumed fit did not start from step 10")
    cache = {}
    supervised_fit(bt, opts, config=SupervisorConfig(chunk_cache=cache), **kw)
    run("faultless, a chunk cache shared with an earlier call", lambda: dict(chunk_cache=cache))
    del cache
    t0 = time.perf_counter()
    ckpt.save(tempfile.mkdtemp(prefix="sup_write_", dir=OUT), ITERS, s_bare)
    write_s = time.perf_counter() - t0
    (s_r, h_r, rep), ms = timed(lambda: supervised_fit(
        bt, opts, config=SupervisorConfig(injector=FaultInjector(nan_steps={1: 2})), **kw))
    print(f"[supervisor] a checkpoint write of the state (W {tuple(s_bare.W.shape)}): "
          f"{write_s * 1e3:.2f} ms; ridge escalation (nan_steps {{1: 2}}): "
          f"{rep.escalations} escalation, ridge {rep.ridge_final:g}, {rep.rollbacks} "
          f"rollbacks, fit {h_r[-1]:.6f} against the bare {h_bare[-1]:.6f} "
          f"(|gap| {abs(h_r[-1] - h_bare[-1]):.3e}), {ms:.2f} ms/iter", flush=True)
    if rep.escalations != 1 or not all(map(np.isfinite, h_r)) or abs(h_r[-1] - h_bare[-1]) > 1e-3:
        fail("the ridge escalation did not recover a finite fit near the bare one")


LM_SERVE = ("qwen3-0.6b", "mamba2-780m")   # phase3_lm: served at full width
LM_SERVE_ARGS = ["--batch", "4", "--prompt-len", "16", "--gen", "16"]
LM_STEPS = 8            # decode steps of each reduced arch, card against CPU
LM_TOL = 1e-5           # f32 logits, relative to their largest magnitude
LM_SELF_TOL = 0.1       # bf16 full width: decode against prefill, same bound


def lm_nbytes(tree) -> int:
    from repro_torch.models.common import tree_map

    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), tree)
    return sum(total)


def lm_full_width_check(arch: str, dev) -> dict:
    """At full width (bf16): the prompt prefilled in one ``prefill_step``
    against the same prompt teacher-forced through ``decode_step`` (the
    path ``serve`` takes): finite logits of the expected shape, the largest
    gap relative to the prefill's largest magnitude, and the greedy tokens
    where the prefill's top-two margin exceeds ``LM_SELF_TOL`` of that
    row's largest magnitude (``decided``). Then the same decode with the
    cache zeroed before every step, as a cache that is never written would
    leave it (``blind_gap``: the bound must be tight enough to see it). Then
    one eager decode step profiled: its device kernels, their device time
    and the share of the step's unprofiled time they fill. Runs in its own
    process (``--lm-full-width``), so that its profiler session cannot touch
    another phase's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.common import tree_map

    cfg = get_config(arch)
    bundle = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init_params(gen, device=dev)
    B, P = 4, 16
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    cache = bundle.init_cache(B, P + 4, device=dev)

    def gap_to(full, dec):
        return float((dec.float() - full.float()).abs().max() / full.float().abs().max())

    with torch.inference_mode():
        full = bundle.prefill_step(params, {"tokens": prompts})
        steps, blind = [], []
        for t in range(P):
            logits, cache = bundle.decode_step(params, cache, prompts[:, t:t + 1], t)
            steps.append(logits)
        dec = torch.cat(steps, dim=1)
        if full.shape != (B, P, cfg.vocab_size) or dec.shape != full.shape:
            fail(f"{arch}: logits of shape {tuple(full.shape)} / {tuple(dec.shape)}")
        if not (bool(torch.isfinite(full).all()) and bool(torch.isfinite(dec).all())):
            fail(f"{arch}: non-finite logits at full width")
        top2 = torch.sort(full.float(), dim=-1).values[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > LM_SELF_TOL * full.float().abs().amax(-1)
        same = bool((dec.argmax(-1) == full.argmax(-1))[sure].all())
        zeroed = bundle.init_cache(B, P + 4, device=dev)
        for t in range(P):
            tree_map(lambda c: c.zero_(), zeroed)
            blind.append(bundle.decode_step(params, zeroed, prompts[:, t:t + 1], t)[0])
        blind_gap = gap_to(full, torch.cat(blind, dim=1))

        def step():
            return bundle.decode_step(params, cache, prompts[:, :1], P)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(OUT / f"lm_decode_step_trace_{arch}.json"))
    kern = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not kern:
        fail(f"{arch}: the profiled decode step ran nothing on the device")
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span_ms = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    nbytes = lm_nbytes(params) + lm_nbytes(cache)
    return {"gap": gap_to(full, dec), "blind_gap": blind_gap, "greedy_same": same,
            "decided": int(sure.sum()), "positions": B * P, "step_ms": step_ms,
            "kernels": len(kern), "busy_ms": busy_ms, "span_ms": span_ms,
            "param_bytes": lm_nbytes(params), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def lm_full_width_child() -> int:
    """``chip_smoke.py --lm-full-width``: ``lm_full_width_check`` of every
    ``LM_SERVE`` arch in this process, one JSON line each."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on a GPU")
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    for arch in LM_SERVE:
        print(json.dumps({"arch": arch, **lm_full_width_check(arch, torch.device("cuda"))}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


def phase3_lm(dev) -> None:
    """The LM testbed's serving path (ROADMAP A8a), which runs no hand
    kernel: every kernel count is reset before it and must read 0 after.
    ``repro_torch.launch.serve`` at the full width of qwen3-0.6b and
    mamba2-780m (batch 4, prompt 16, gen 16; bf16; the port's random init),
    with prefill ms, decode ms a step, tok/s and peak GiB; the full-width
    decode against the full-width prefill, against a decode that never
    writes its cache, and a profiled decode step (``lm_full_width_check``,
    in a child process); then all ten reduced archs on the card against the
    port's CPU run (``serve.against_cpu``, f32, within ``LM_TOL``, greedy
    tokens equal)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import serve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    t_phase = time.perf_counter()
    reset_launches()
    vocab = {arch: get_config(arch).vocab_size for arch in LM_SERVE}
    for arch in LM_SERVE:
        t0 = time.perf_counter()
        out = serve.main(["--arch", arch, *LM_SERVE_ARGS])
        gen = out["generated"]
        if gen.shape != (4, 16) or int(gen.min()) < 0 or int(gen.max()) >= vocab[arch]:
            fail(f"{arch}: generated tokens of shape {tuple(gen.shape)}, in "
                 f"[{int(gen.min())}, {int(gen.max())}]")
        print(f"[lm] {arch} full width ({card}): prefill {out['prefill_ms']:.3f} ms (16 "
              f"teacher-forced steps), decode {out['decode_ms_per_step']:.3f} ms a step, "
              f"{out['tokens_per_s']:.1f} tok/s, peak {out['peak_gib']:.3f} GiB while "
              f"serving; the whole call {time.perf_counter() - t0:.1f} s", flush=True)
        free_cached(f"serve {arch}")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--lm-full-width"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        print(child.stdout[-4000:] + child.stderr[-4000:], flush=True)
        fail(f"the full-width LM check's process exited with {child.returncode}")
    checks = [json.loads(line) for line in child.stdout.splitlines() if line.startswith('{"arch"')]
    if [c["arch"] for c in checks] != list(LM_SERVE):
        fail(f"the full-width LM check reported {[c['arch'] for c in checks]}")
    for chk in checks:
        arch = chk["arch"]
        print(f"[lm] {arch} full width (own process): decode against prefill {chk['gap']:.3e} "
              f"of the largest logit (bound {LM_SELF_TOL:g}, bf16), a decode whose cache is "
              f"zeroed before every step {chk['blind_gap']:.3e}; greedy tokens equal on "
              f"{chk['decided']} of {chk['positions']} positions decided by a top-two margin "
              f"over {LM_SELF_TOL:g} of the row's largest logit: {chk['greedy_same']}; one "
              f"eager decode step {chk['step_ms']:.3f} ms, {chk['kernels']} device kernels, "
              f"busy {chk['busy_ms']:.3f} ms ({chk['busy_ms'] / chk['step_ms']:.1%} of the "
              f"step; {chk['busy_ms'] / chk['span_ms']:.1%} of the first-to-last kernel span "
              f"{chk['span_ms']:.3f} ms); bytes a step {chk['bytes']:,} (parameters "
              f"{chk['param_bytes']:,}): byte bound {chk['bound_ms']:.4f} ms at 3.35 TB/s, "
              f"the step {chk['step_ms'] / chk['bound_ms']:.1f}x it", flush=True)
        if not (chk["gap"] <= LM_SELF_TOL < chk["blind_gap"]):
            fail(f"{arch}: full-width decode parts from its prefill, or the bound does not "
                 f"see a cache that is never written")
        if not chk["decided"] or not chk["greedy_same"]:
            fail(f"{arch}: greedy tokens differ, or no position was decided")
    print(f"[lm] the full-width checks' process: {time.perf_counter() - t0:.1f} s", flush=True)
    for arch in list_archs():
        r = serve.against_cpu(arch, dev, steps=LM_STEPS, tol=LM_TOL)
        print(f"[lm] {arch} reduced, card against CPU (f32): logits {r['forward']:.3e}, "
              f"{LM_STEPS} decode steps {r['decode']:.3e} (bound {LM_TOL:g}); greedy "
              f"{r['same']}/{r['decided']} decided tokens equal", flush=True)
        if not (r["finite"] and r["forward"] <= LM_TOL and r["decode"] <= LM_TOL
                and r["same"] == r["decided"] and r["decided"] >= 2 * LM_STEPS - 1):
            fail(f"{arch}: reduced arch on the card parts from the CPU run: {r}")
    got = {k: n for k, n in launches().items() if n}
    if got:
        fail(f"the LM path launched hand kernels: {got}")
    print(f"[lm] no hand kernel launched on the LM path (counts reset before it, all 0 "
          f"after); phase {time.perf_counter() - t_phase:.1f} s", flush=True)


LM_TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--steps", "8", "--batch", "8", "--seq", "256",
                 "--log-every", "1"]        # phase3_lm_train (b): full width, on the card
LM_FAULT_ARGS = ["--arch", "qwen3-0.6b", "--reduce", "--steps", "20", "--batch", "4",
                 "--seq", "32", "--ckpt-every", "6", "--log-every", "100"]
LM_FAULT_AT = "15"      # (c): a persistent fault past the checkpoint of step 12
EXAMPLE_TOL = 1e-8      # (d): the example's f64 fit history, card against the CPU's torch route
EXAMPLE_KERNELS = ("fused_procrustes_b", "fused_mode1_xkv", "fused_mode2_compact",
                   "fused_ykv", "gram_inv_sqrt")       # F1-F4 and P1


def lm_train_floor(params, B: int, S: int, cfg) -> dict:
    """The least time of one full-width train step: the larger of its
    operations over the bf16 peak (6 x parameters x tokens for the
    products, forward and backward, the tied head once; attention's QK^T
    and PV over whole blocks; remat's recompute not counted, it is a
    choice) and its bytes over the memory rate (the parameters, m and v
    each read once and written once)."""
    n = lm_nbytes(params) // 2                      # bf16 parameters
    ops = (6 * n * B * S + 12 * cfg.n_layers * B * S * S * cfg.n_heads
           * cfg.resolved_head_dim)
    nbytes = n * (2 + 4 + 4) * 2
    t_ops, t_bytes = ops / HALF_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"params": n, "ops": ops, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lm_train_full_width(dev) -> dict:
    """(b): ``repro_torch.launch.train`` at the full width of qwen3-0.6b
    (bf16, remat, batch 8 x 256, 8 steps: warm-up 1 step) with its step ms
    and peak GiB; then the same model from the same seed on one fixed batch
    for 8 steps (the loss must fall) and one more step profiled: its device
    kernels, their device time and the share of the step's time they fill."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.models import build

    out = train.main(LM_TRAIN_ARGS)
    del out["params"], out["opt"]
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-0.6b")
    B, S = 8, 256
    bundle = build(cfg, lr=1e-3, total_steps=8)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = bundle.init_opt(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             TokenStream(vocab_size=cfg.vocab_size, batch=B, seq_len=S).batch_at(0).items()}
    fixed, fixed_ms = [], []
    for i in range(8):
        t0 = time.perf_counter()
        params, opt, m = bundle.train_step(params, opt, batch, i)
        fixed.append(float(m["loss"]))
        fixed_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = bundle.train_step(params, opt, batch, 8)
    float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt, m = bundle.train_step(params, opt, batch, 8)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not kern:
        fail("the profiled full-width train step ran nothing on the device")
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
    top_ops = [[e.key, e.self_device_time_total / 1e3, e.count] for e in ops]
    return {"driver_losses": out["losses"], "driver_ms": out["step_ms"],
            "peak_gib": out["peak_gib"], "fixed_losses": fixed, "fixed_ms": fixed_ms,
            "step_ms": step_ms, "kernels": len(kern),
            "busy_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3,
            "top": [[name[:60], ms] for name, ms in top], "top_ops": top_ops,
            "log_v": float(np.log(cfg.vocab_size)), **lm_train_floor(params, B, S, cfg)}


def lm_train_fault() -> dict:
    """(c): reduced qwen3 on the card, 20 steps, under
    ``torch.use_deterministic_algorithms(True)``: an uninterrupted run and
    one whose fault at step 15 persists past the retries (restored at the
    checkpoint of step 12, then rewound). Whether the losses and the final
    parameters and moments are the same bits."""
    import tempfile

    import torch
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves

    torch.use_deterministic_algorithms(True)
    try:
        plain = train.main(LM_FAULT_ARGS)
        with tempfile.TemporaryDirectory(dir=OUT) as d:
            faulted = train.main([*LM_FAULT_ARGS, "--ckpt-dir", d, "--fail-at", LM_FAULT_AT,
                                  "--fail-persistent"])
    finally:
        torch.use_deterministic_algorithms(False)
    a = tree_leaves((plain["params"], plain["opt"]))
    b = tree_leaves((faulted["params"], faulted["opt"]))
    return {"losses": plain["losses"], "same_losses": plain["losses"] == faulted["losses"],
            "same_state": len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
            "gap": max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))}


def lm_train_example() -> dict:
    """(d): ``repro_torch.examples.lm_activation_signatures`` on the card,
    its kernel launches counted from 0. Its activations' Grams have
    condition numbers near 1e7, so an f32 fit of them is chaotic (the CPU's
    own f32 fit moves by 1.6e-2 when its input moves by 1e-7): the card's
    f32 history is printed beside the CPU's, and the check is the same fit
    in f64, the card's ``auto`` route (its launches counted too) against
    the CPU's torch route from the same initial state (``init_state`` draws
    V on the CPU from the seed on either device)."""
    import dataclasses

    import torch
    from repro_torch.core import bucketize, fit
    from repro_torch.examples import lm_activation_signatures as example
    from repro_torch.sparse import from_dense_slices

    reset_launches()
    out = example.main([])
    got = launches()
    data = from_dense_slices(out["slices"])
    f64 = dataclasses.replace(example.OPTS, dtype=torch.float64)

    def history(opts, device, dtype):
        b = bucketize(data, max_buckets=2, device=device, dtype=dtype)
        return fit(b, opts, max_iters=40, tol=1e-6)[1]

    cpu32 = history(dataclasses.replace(example.OPTS, backend="torch"), "cpu", torch.float32)
    reset_launches()
    card64 = history(f64, "cuda", torch.float64)
    got64 = launches()
    cpu64 = history(dataclasses.replace(f64, backend="torch"), "cpu", torch.float64)

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    return {"launches": {k: got.get(k, 0) for k in EXAMPLE_KERNELS},
            "launches64": {k: got64.get(k, 0) for k in EXAMPLE_KERNELS},
            "all_launches": {k: v for k, v in got.items() if v}, "history": out["history"],
            "cpu_history": cpu32, "history64": card64, "cpu_history64": cpu64,
            "loss": out["loss"], "gap": gap(out["history"], cpu32), "gap64": gap(card64, cpu64)}


def lm_train_child() -> int:
    """``chip_smoke.py --lm-train``: ``phase3_lm_train``'s four parts in
    this process, one JSON line each."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on a GPU")
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    from repro_torch.configs import list_archs
    from repro_torch.launch import train

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for arch in list_archs():
        print(json.dumps({"part": "a", "arch": arch, **train.against_cpu(arch, dev)}),
              flush=True)
    print(json.dumps({"part": "a_s", "s": time.perf_counter() - t0}), flush=True)
    for part, fn in (("b", lambda: lm_train_full_width(dev)), ("c", lm_train_fault),
                     ("d", lm_train_example)):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        print(json.dumps({"part": part, **out, "s": time.perf_counter() - t0}), flush=True)
    return 0


def phase3_lm_train() -> None:
    """The LM testbed's training path (ROADMAP A8b), in a child process
    (``chip_smoke.py --lm-train``, with cuBLAS's workspace fixed so that
    (c) may ask for deterministic algorithms): (a) the ten reduced archs'
    train steps 0-2 on the card against the port's CPU run
    (``train.against_cpu``: losses within 1e-5, parameters and moments
    within ``step_gaps``'s bounds); (b) qwen3-0.6b trained at full width
    (``lm_train_full_width``); (c) a persistent fault at reduced width
    (``lm_train_fault``): bit for bit an uninterrupted run; (d) the
    activation-signatures example, whose fit runs F1-F4 and P1, and the
    same fit in f64 within ``EXAMPLE_TOL`` of the CPU's torch route
    (``lm_train_example``)."""
    import numpy as np
    from repro_torch.launch import train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    t_phase = time.perf_counter()
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--lm-train"],
                           capture_output=True, text=True, timeout=900, env=env)
    (OUT / "lm_train_child.log").write_text(child.stdout + child.stderr)
    if child.returncode != 0:
        print(child.stdout[-6000:] + child.stderr[-6000:], flush=True)
        fail(f"the LM training check's process exited with {child.returncode}")
    parts, problems = {}, []
    for line in child.stdout.splitlines():
        if line.startswith('{"part"'):
            rec = json.loads(line)
            parts.setdefault(rec["part"], []).append(rec)
    if sorted(parts) != ["a", "a_s", "b", "c", "d"] or len(parts["a"]) != 10:
        print(child.stdout[-6000:] + child.stderr[-6000:], flush=True)
        fail(f"the LM training check reported {sorted(parts)}")
    for r in parts["a"]:
        print(f"[lm-train] {r['arch']} reduced, train steps 0-2 card against CPU (f32, "
              f"{card}): losses {r['loss']:.3e} (bound {train.LOSS_TOL:g}), step 0's first "
              f"moments {r['grad']:.3e} (bound {train.GRAD_TOL:g}), parameters "
              f"{r['param_lr']:.3e} lr at most and {r['param_frac']:.2e} of them past "
              f"{train.PARAM_ABS:g} (bounds {train.PARAM_LR:g} lr, {train.PARAM_FRAC:g}), "
              f"moments {r['moment']:.3e} (bound {train.MOMENT_TOL:g}); step 0 unmoved: "
              f"{r['unmoved']}", flush=True)
        if not (r["finite"] and r["unmoved"] and r["loss"] <= train.LOSS_TOL and r["within"]):
            problems.append(f"{r['arch']}: train steps on the card part from the CPU run")
    print(f"[lm-train] (a) {parts['a_s'][0]['s']:.1f} s ({card})", flush=True)

    b = parts["b"][0]
    drv = b["driver_ms"][1:]
    med = float(np.median(drv))
    print(f"[lm-train] qwen3-0.6b full width ({card}), bf16, remat, batch 8 x 256 = 2,048 "
          f"tokens a step, {b['params']:,} parameters: `launch.train` losses "
          f"{[round(x, 4) for x in b['driver_losses']]}, step ms {[round(x, 1) for x in b['driver_ms']]} "
          f"(median of steps 1-7 {med:.1f} ms, {2048 / med * 1e3:.1f} tokens/s), peak "
          f"{b['peak_gib']:.3f} GiB", flush=True)
    print(f"[lm-train] qwen3-0.6b full width ({card}), one fixed batch: losses "
          f"{[round(x, 4) for x in b['fixed_losses']]}, step ms "
          f"{[round(x, 1) for x in b['fixed_ms']]}; one more step {b['step_ms']:.1f} ms, "
          f"profiled: {b['kernels']:,} device kernels, busy {b['busy_ms']:.3f} ms "
          f"({b['busy_ms'] / b['step_ms']:.1%} of the unprofiled step); floor "
          f"{b['bound_ms']:.3f} ms by {b['bound_by']} ({b['ops']:.3e} operations at 989 "
          f"TFLOP/s: {b['ops_ms']:.3f} ms; {b['bytes']:,} bytes at 3.35 TB/s: "
          f"{b['bytes_ms']:.3f} ms), the step {b['step_ms'] / b['bound_ms']:.1f}x it, its "
          f"device time {b['busy_ms'] / b['bound_ms']:.1f}x; (b) {b['s']:.1f} s", flush=True)
    for name, ms in b["top"]:
        print(f"[lm-train]   device {ms:9.3f} ms  {name} ({card})", flush=True)
    for name, ms, count in b["top_ops"]:
        print(f"[lm-train]   device {ms:9.3f} ms  x{count:<5d} {name} (its own kernels; "
              f"{card})", flush=True)
    lo, hi = 0.5 * b["log_v"], 3.0 * b["log_v"]
    if not all(np.isfinite(b["driver_losses"] + b["fixed_losses"])):
        problems.append("qwen3-0.6b at full width: a non-finite loss")
    if not (lo < b["driver_losses"][0] < hi and lo < b["fixed_losses"][0] < hi):
        problems.append(f"qwen3-0.6b at full width: step 0's loss outside ({lo:.3f}, {hi:.3f})")
    if not b["fixed_losses"][-1] < b["fixed_losses"][0]:
        problems.append("qwen3-0.6b at full width: the loss did not fall on a fixed batch")

    c = parts["c"][0]
    print(f"[lm-train] fault at reduced width ({card}), deterministic algorithms: a "
          f"persistent fault at step {LM_FAULT_AT}, restored at step 12 and rewound: losses "
          f"equal to the uninterrupted run's: {c['same_losses']}; parameters and moments bit "
          f"for bit: {c['same_state']} (largest gap {c['gap']:.3e}); (c) {c['s']:.1f} s",
          flush=True)
    if not (c["same_losses"] and c["same_state"]):
        problems.append("the rewound run parts from the uninterrupted run")

    d = parts["d"][0]
    print(f"[lm-train] activation-signatures example ({card}): LM loss {d['loss']:.3f}; f32 "
          f"fit {d['history'][-1]:.6f} after {len(d['history'])} iterations, the CPU torch "
          f"route's {d['cpu_history'][-1]:.6f} after {len(d['cpu_history'])}, largest gap "
          f"{d['gap']:.3e} (not bounded: Grams of condition ~1e7 make an f32 fit chaotic); "
          f"f64 fit {d['history64'][-1]:.9f} after {len(d['history64'])} iterations, the CPU "
          f"torch route's after {len(d['cpu_history64'])}, largest gap {d['gap64']:.3e} "
          f"(bound {EXAMPLE_TOL:g}); launches in the example {d['all_launches']}, in the f64 "
          f"fit {d['launches64']}; (d) {d['s']:.1f} s", flush=True)
    for key in ("launches", "launches64"):
        if not all(d[key].values()):
            problems.append(f"a fit of the example did not run "
                            f"{[k for k, v in d[key].items() if not v]}")
    if not (d["gap64"] <= EXAMPLE_TOL and len(d["history64"]) == len(d["cpu_history64"])):
        problems.append("the example's f64 fit on the card parts from the CPU's torch route")
    print(f"[lm-train] phase {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    if problems:
        fail("; ".join(problems))


LM_MESH_ARCH = "phi3.5-moe-42b-a6.6b"     # phase3_lm_mesh (a): one MoE block at full width
LM_MESH_TOKENS = (4, 512)                  # (a)'s batch x sequence
LM_MESH_CPU_TOKENS = (1, 512)              # (a)'s card-against-CPU call: a quarter
LM_MESH_PSUM_ARCH = "qwen3-0.6b"           # (b): compressed_psum on its parameter shapes
LM_MESH_LAYOUT_ARCHS = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b")   # (c)
LM_BF16_TOL, LM_F32_TOL = 1e-3, 1e-5       # (a): the LM's bf16 bound, and f32's
# (a), card against CPU in f32: sums of up to 6,400 products in another
# order (cuBLAS against the CPU's BLAS), ~7x the reduced archs' 1e-5 at
# widths of 64-128 (sqrt of the ratio of the sums' lengths)
LM_F32_CPU_TOL = 1e-4


def lm_mesh_gap(got, want) -> float:
    """max |got - want| over the largest |want|, on ``got``'s device (the
    expert gradients are GBs: copies to the host took most of (a)'s time)."""
    got, want = got.double(), want.to(got.device).double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def lm_mesh_grads(block, p, x, w):
    """(output, aux, gradients of sum(y * w) + aux on every leaf of ``p``
    and on ``x``) of ``block(p, x)``."""
    import torch
    from repro_torch.models.common import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_() for t in tree_leaves(p) + [x]]
    y, aux = block(tree_unflatten(p, leaves[:-1]), leaves[-1])
    grads = torch.autograd.grad((y.float() * w).sum() + aux, leaves)
    return y.detach(), aux.detach(), list(grads)


def lm_mesh_compare(a, b) -> dict:
    """The gaps of two ``lm_mesh_grads`` results: output, aux (relative),
    the largest over the gradient leaves (each over its largest |g|)."""
    return {"y": lm_mesh_gap(a[0], b[0]), "aux": lm_mesh_gap(a[1], b[1]),
            "grad": max(lm_mesh_gap(g, h) for g, h in zip(a[2], b[2]))}


def lm_mesh_moe(meshes, arch: str = LM_MESH_ARCH, tokens=LM_MESH_TOKENS) -> dict:
    """(a): one MoE block of ``arch`` at full width (its random init, bf16
    experts; the router drawn at std 1/sqrt(d), so that its logits are of
    order one, as a trained router's are: ``init_moe``'s 0.02 routes all but
    evenly) on B x S tokens with a common mean (so that the config's
    capacity drops tokens),
    through ``_moe_block_manual`` on the card's ("data", "model") mesh of
    (1, 1), called directly (a model dimension of 1 routes ``moe_block`` to
    auto, and one card has no second rank). At a no-drop capacity factor
    (E / k: every expert may take every token) against ``_moe_block_auto``
    on the card, in bf16 and in f32; at the config's capacity factor the f32
    block on the card against the port's CPU run of the same call on
    ``LM_MESH_CPU_TOKENS`` (a CPU mesh of (1, 1) over gloo; the full 2,048
    tokens take the CPU ~40 s), with the share of assignments the per-rank
    capacity drops; then the bf16 block's forward and backward ms at the
    config's capacity, its peak GiB and its expert products' operations
    bound."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.moe import _moe_block_auto, _moe_block_manual, init_moe, top_k

    cfg = get_config(arch)
    B, S = tokens
    dev = torch.device("cuda")
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    gen = torch.Generator(device=dev).manual_seed(0)
    p16 = init_moe(gen, cfg, torch.bfloat16, dev)
    p16["router"]["w"] = (torch.randn(cfg.d_model, cfg.n_experts, generator=gen, device=dev)
                          / cfg.d_model ** 0.5)
    # tokens with a common mean, as a residual stream's have: the router
    # then favours some experts, and the config's capacity drops tokens
    x32 = (torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
           + 0.3 * torch.randn(cfg.d_model, generator=gen, device=dev))
    w = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    x16, p32 = x32.bfloat16(), tree_map(lambda t: t.float(), p16)
    x32 = x16.float()
    out = {"arch": arch, "tokens": [B, S], "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "experts": cfg.n_experts, "k": cfg.experts_per_token,
           "expert_bytes": sum(t.numel() * t.element_size() for t in p16["experts"].values())}

    def manual(c, mesh):
        return lambda p, x: _moe_block_manual(p, x, c, mesh)

    t = {"init": time.perf_counter()}
    for name, p, x in (("bf16", p16, x16), ("f32", p32, x32)):
        m = lm_mesh_grads(manual(no_drop, meshes["cuda"]), p, x, w)
        a = lm_mesh_grads(lambda p_, x_: _moe_block_auto(p_, x_, no_drop), p, x, w)
        finite = all(bool(torch.isfinite(t).all()) for t in (m[0], m[1], *m[2]))
        out[name] = {**lm_mesh_compare(m, a), "finite": finite,
                     "shape": list(m[0].shape) == [B, S, cfg.d_model]}
        del m, a
        torch.cuda.synchronize()
        t[name] = time.perf_counter()
    T, k, E = B * S, cfg.experts_per_token, cfg.n_experts

    def dropped(x, T):
        """(slots an expert, the share of assignments past them) on x."""
        cap = max(8, -(-T * k * int(round(cfg.capacity_factor * 4)) // (4 * E)))
        probs = torch.softmax(x.reshape(T, -1).float() @ p16["router"]["w"], dim=-1)
        load = torch.bincount(top_k(probs, k)[1].reshape(-1), minlength=E)
        return cap, float((load - cap).clamp(min=0).sum()) / (T * k)

    b, s = LM_MESH_CPU_TOKENS
    xs, ws = x32[:b, :s].contiguous(), w[:b, :s].contiguous()
    card = lm_mesh_grads(manual(cfg, meshes["cuda"]), p32, xs, ws)
    p_cpu = tree_map(lambda t: t.cpu(), p32)
    t["to_cpu"] = time.perf_counter()
    cpu = lm_mesh_grads(manual(cfg, meshes["cpu"]), p_cpu, xs.cpu(), ws.cpu())
    t["cpu"] = time.perf_counter()
    out["cpu"] = {**lm_mesh_compare(card, cpu), "tokens": [b, s]}
    out["cpu"]["capacity"], out["cpu"]["dropped"] = dropped(xs, b * s)
    del card, cpu, p32, x32
    out["capacity"], out["dropped"] = dropped(x16, T)

    def step():
        return lm_mesh_grads(manual(cfg, meshes["cuda"]), p16, x16, w)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        step()
    end.record()
    torch.cuda.synchronize()
    out["ms"] = start.elapsed_time(end) / 5
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["peak_added_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    t["timed"] = time.perf_counter()
    keys = list(t)
    out["steps_s"] = {k: round(t[k] - t[j], 2) for j, k in zip(keys, keys[1:])}
    # the expert products: 3 forward and 6 backward [cap x d] x [d x f] a
    # local expert, every expert's slots full
    out["ops"] = 9 * 2 * E * out["capacity"] * cfg.d_model * cfg.d_ff
    out["bound_ms"] = out["ops"] / HALF_FLOPS * 1e3
    return out


def lm_mesh_psum(meshes, arch: str = LM_MESH_PSUM_ARCH) -> dict:
    """(b): ``compressed_psum`` over the card's mesh ("data", NCCL) on a
    tree of ``arch``'s parameter shapes in f32 (gradients at scales 0.1, 1
    and 10 by leaf, errors at 1e-3): its ms (5 calls after a warm-up), the
    result and the new errors bit for bit the CPU function's on the same
    tree (a CPU mesh over gloo), the new errors bit for bit each leaf's own
    ``ef_compress_update`` (the error feedback stays local), and the byte
    bound (the gradients and errors read, the result and errors written)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as dsh
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import compressed_psum, ef_compress_update

    dev = torch.device("cuda")
    like = init_lm(torch.Generator(), get_config(arch), device=torch.device("meta"))
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [t.shape for t in tree_leaves(like)]
    grads = tree_unflatten(like, [torch.randn(s, generator=gen, device=dev) * 10.0 ** (i % 3 - 1)
                                  for i, s in enumerate(shapes)])
    errors = tree_unflatten(like, [torch.randn(s, generator=gen, device=dev) * 1e-3
                                   for s in shapes])
    with dsh.axis_rules(dsh.LM_RULES, meshes["cuda"]):
        red, new = compressed_psum(grads, errors, "data")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            compressed_psum(grads, errors, "data")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 5
    local = all(torch.equal(n, ef_compress_update(g, e)[3])
                for g, e, n in zip(tree_leaves(grads), tree_leaves(errors), tree_leaves(new)))
    cpu = [tree_unflatten(like, [t.cpu() for t in tree_leaves(tree)]) for tree in (grads, errors)]
    with dsh.axis_rules(dsh.LM_RULES, meshes["cpu"]):
        c_red, c_new = compressed_psum(*cpu, "data")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves((red, new)),
                                                         tree_leaves((c_red, c_new))))
    n = sum(s.numel() for s in shapes)
    return {"arch": arch, "params": n, "leaves": len(shapes), "ms": ms, "same_as_cpu": same,
            "local": local, "bound_ms": 16 * n / HBM_BYTES_PER_S * 1e3}


def lm_mesh_layouts(mesh) -> dict:
    """(c): ``param_shardings`` of each arch's full parameter tree on the
    card's mesh: every leaf made on the card (bf16, one at a time: phi3.5-moe
    holds 41.9 B parameters) and laid out with ``distribute_tensor`` and its
    placements, whose local shard must have the shape its spec implies."""
    import math

    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import param_shardings
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import init_lm

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = {}
    for arch in LM_MESH_LAYOUT_ARCHS:
        like = init_lm(torch.Generator(), get_config(arch), device=torch.device("meta"))
        leaves, specs = tree_leaves(like), tree_leaves(param_shardings(like, mesh))
        ok = len(leaves) == len(specs)
        for leaf, sh in zip(leaves, specs):
            t = torch.empty(leaf.shape, dtype=leaf.dtype, device="cuda")
            local = distribute_tensor(t, mesh, list(sh.placements)).to_local()
            count = [math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e or ()))
                     for e in sh.spec]
            count += [1] * (len(leaf.shape) - len(count))
            ok &= tuple(local.shape) == tuple(d // c for d, c in zip(leaf.shape, count))
            del t, local
        out[arch] = {"leaves": len(leaves), "ok": bool(ok),
                     "params": sum(t.numel() for t in leaves),
                     "sharded": sum(any(e is not None for e in sh.spec) for sh in specs)}
    return out


def lm_mesh_examples() -> dict:
    """(d): ``repro_torch.examples.quickstart`` and ``phenotyping`` on the
    card: the f32 fit (CC auto) with its kernel launches and ms an
    iteration; the same fit on the CC torch route, whose history is printed
    beside it, not bounded (both f32 fits are ill-conditioned: the CPU's own
    f32 torch-route history moves by 4.2e-5 (quickstart) and 4.0e-3
    (phenotyping) when the data move by 1e-7 relative, and quickstart's tol
    of 1e-7 stops it at f32 noise); the check is the f64 fit on the card
    (launches counted too) within ``EXAMPLE_TOL`` of the CPU's, each
    iteration (``init_state`` draws V on the CPU from the seed on either
    device); quickstart's own asserts."""
    import torch
    from repro_torch.examples import phenotyping, quickstart

    out = {}
    for name, example in (("quickstart", quickstart), ("phenotyping", phenotyping)):
        reset_launches()
        r32 = example.run("cuda")
        got32 = launches()
        torch_route = example.run("cuda", backend="torch")
        reset_launches()
        r64 = example.run("cuda", dtype=torch.float64)
        got64 = launches()
        cpu64 = example.run("cpu", dtype=torch.float64)

        def gap(a, b):          # over the common iterations
            return max(abs(x - y) for x, y in zip(a, b))

        rec = {"launches": {k: got32.get(k, 0) for k in EXAMPLE_KERNELS},
               "launches64": {k: got64.get(k, 0) for k in EXAMPLE_KERNELS},
               "iters": len(r32["history"]), "torch_iters": len(torch_route["history"]),
               "fit": r32["history"][-1],
               "ms_iter": r32["fit_ms"] / len(r32["history"]),
               "torch_ms_iter": torch_route["fit_ms"] / len(torch_route["history"]),
               "gap32": gap(r32["history"], torch_route["history"]),
               "gap64": gap(r64["history"], cpu64["history"]), "iters64": len(r64["history"])}
        if name == "quickstart":
            rec["asserts"] = bool(r32["history"][-1] > 0.5 and r32["readout"]["invariant"])
        out[name] = rec
    return out


def lm_mesh_child() -> int:
    """``chip_smoke.py --lm-mesh``: ``phase3_lm_mesh``'s four parts in this
    process, one JSON line each, in a world of one (an in-memory
    ``HashStore``) whose CUDA tensors go through NCCL and whose CPU tensors
    (the CPU runs held against the card) through gloo."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on a GPU")
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, stated
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {d: init_device_mesh(d, (1, 1), mesh_dim_names=("data", "model"))
                  for d in ("cuda", "cpu")}
        for part, fn in (("a", lambda: lm_mesh_moe(meshes)), ("b", lambda: lm_mesh_psum(meshes)),
                         ("c", lambda: lm_mesh_layouts(meshes["cuda"])), ("d", lm_mesh_examples)):
            t0 = time.perf_counter()
            out = fn()
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps({"part": part, **out, "s": time.perf_counter() - t0}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def phase3_lm_mesh() -> None:
    """The LM on a mesh (ROADMAP A8c) and the two remaining examples (A9),
    in a child process (``chip_smoke.py --lm-mesh``) so that its process
    group cannot touch the earlier phases: (a) one phi3.5-moe MoE block at
    full width through ``_moe_block_manual`` (``lm_mesh_moe``); (b)
    ``compressed_psum`` on qwen3-0.6b's parameter shapes (``lm_mesh_psum``);
    (c) ``param_shardings`` of qwen3-0.6b's and phi3.5-moe's full trees
    through ``distribute_tensor`` (``lm_mesh_layouts``); (d) the quickstart
    and phenotyping examples, whose fits launch F1-F4 and P1
    (``lm_mesh_examples``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    t_phase = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--lm-mesh"],
                           capture_output=True, text=True, timeout=600)
    (OUT / "lm_mesh_child.log").write_text(child.stdout + child.stderr)
    if child.returncode != 0:
        print(child.stdout[-6000:] + child.stderr[-6000:], flush=True)
        fail(f"the LM mesh check's process exited with {child.returncode}")
    parts = {}
    for line in child.stdout.splitlines():
        if line.startswith('{"part"'):
            rec = json.loads(line)
            parts[rec.pop("part")] = rec
    if sorted(parts) != ["a", "b", "c", "d"]:
        print(child.stdout[-6000:] + child.stderr[-6000:], flush=True)
        fail(f"the LM mesh check reported {sorted(parts)}")
    problems = []

    a = parts["a"]
    for name, tol in (("bf16", LM_BF16_TOL), ("f32", LM_F32_TOL)):
        r = a[name]
        print(f"[lm-mesh] {a['arch']} MoE block at full width (d {a['d_model']}, d_ff "
              f"{a['d_ff']}, {a['experts']} experts, top-{a['k']}, {a['tokens'][0]} x "
              f"{a['tokens'][1]} tokens; {card}), _moe_block_manual on a (1, 1) mesh against "
              f"_moe_block_auto at a no-drop capacity, {name}: output {r['y']:.3e}, aux "
              f"{r['aux']:.3e}, gradients {r['grad']:.3e} of each leaf's largest |g| (bound "
              f"{tol:g})", flush=True)
        if not (r["finite"] and r["shape"] and max(r["y"], r["aux"], r["grad"]) <= tol):
            problems.append(f"the manual MoE block parts from the auto one in {name}")
    c = a["cpu"]
    print(f"[lm-mesh] the same block at the config's capacity on {c['tokens'][0]} x "
          f"{c['tokens'][1]} tokens ({c['capacity']} slots an expert, {c['dropped']:.2%} of the "
          f"assignments dropped), f32, card against the port's CPU run: output {c['y']:.3e}, "
          f"aux {c['aux']:.3e}, gradients {c['grad']:.3e} (bound {LM_F32_CPU_TOL:g}; {card})",
          flush=True)
    if max(c["y"], c["aux"], c["grad"]) > LM_F32_CPU_TOL or not c["dropped"] > 0:
        problems.append("the manual MoE block on the card parts from its CPU run, or "
                        "dropped nothing")
    print(f"[lm-mesh] the bf16 block's forward and backward at the config's capacity "
          f"({a['capacity']} slots an expert, {a['dropped']:.2%} of the assignments dropped): "
          f"{a['ms']:.3f} ms ({card}), peak {a['peak_gib']:.3f} GiB ({a['peak_added_gib']:.3f} "
          f"GiB above its inputs; experts {a['expert_bytes'] / 2**30:.3f} GiB); the expert "
          f"products' {a['ops']:.3e} operations at 989 TFLOP/s: {a['bound_ms']:.3f} ms, the "
          f"block {a['ms'] / a['bound_ms']:.1f}x it; (a) {a['s']:.1f} s {a['steps_s']}",
          flush=True)

    b = parts["b"]
    print(f"[lm-mesh] compressed_psum over NCCL on {b['arch']}'s {b['params']:,} parameters "
          f"({b['leaves']} leaves, f32): {b['ms']:.3f} ms a call ({card}); byte bound "
          f"{b['bound_ms']:.3f} ms at 3.35 TB/s; bit for bit the CPU function: "
          f"{b['same_as_cpu']}; error feedback local: {b['local']}; (b) {b['s']:.1f} s",
          flush=True)
    if not (b["same_as_cpu"] and b["local"]):
        problems.append("compressed_psum on the card parts from the CPU or its errors")

    lay = {k: v for k, v in parts["c"].items() if k != "s"}
    for arch, r in lay.items():
        print(f"[lm-mesh] param_shardings of {arch}'s full tree ({r['params']:,} parameters, "
              f"{r['leaves']} leaves, {r['sharded']} with a sharded dimension): every leaf "
              f"laid out by distribute_tensor with the spec's local shape: {r['ok']}",
              flush=True)
        if not r["ok"]:
            problems.append(f"param_shardings of {arch} does not lay out")
    print(f"[lm-mesh] (c) {parts['c']['s']:.1f} s", flush=True)

    d = parts["d"]
    for name in ("quickstart", "phenotyping"):
        r = d[name]
        print(f"[lm-mesh] example {name} ({card}): f32 CC auto fit {r['fit']:.6f} after "
              f"{r['iters']} iterations, {r['ms_iter']:.3f} ms an iteration (the CC torch "
              f"route's {r['torch_ms_iter']:.3f}, {r['torch_iters']} iterations), history "
              f"{r['gap32']:.3e} from the torch route's over their common iterations (not "
              f"bounded: ill-conditioned f32 fits); f64 card against CPU {r['gap64']:.3e} "
              f"over {r['iters64']} iterations (bound {EXAMPLE_TOL:g}); launches f32 "
              f"{r['launches']}, f64 {r['launches64']}"
              + (f"; the script's asserts hold: {r['asserts']}" if "asserts" in r else ""),
              flush=True)
        if not (all(r["launches"].values()) and all(r["launches64"].values())):
            problems.append(f"a fit of {name} did not run "
                            f"{[k for k, v in r['launches'].items() if not v]}")
        if not (r["gap64"] <= EXAMPLE_TOL and r.get("asserts", True)):
            problems.append(f"the {name} example parts from its references")
    print(f"[lm-mesh] (d) {d['s']:.1f} s; phase {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)
    if problems:
        fail("; ".join(problems))


def bcc_cut(bt, V):
    """The largest CC bucket's first subjects, as many as keep the BCC
    values within ``BCC_CUT_BYTES`` (width unchanged, depth cut), converted
    to BCC; ``xk_times_v_bcc`` on them against ``xk_times_v``. Returns the
    cut, its BCC bucket and the launch counts of that one call."""
    import dataclasses

    import torch
    from repro_torch.core import to_block_bucket
    from repro_torch.core.irregular import scatter_order

    big = max(bt.buckets, key=lambda b: b.kb)
    blk = torch.where(big.col_mask > 0, big.cols.long() // 128, -1).sort(1).values
    first = torch.cat([blk[:, :1] >= 0, (blk[:, 1:] != blk[:, :-1]) & (blk[:, 1:] >= 0)], 1)
    nb = int(first.sum(1).max())
    n = min(big.kb, BCC_CUT_BYTES // (big.i_pad * nb * 128 * big.vals.element_size()))
    sl = {f: getattr(big, f)[:n] for f in ("vals", "cols", "col_mask", "subject_ids",
                                           "subject_mask", "row_counts")}
    perm, ends = scatter_order(sl["cols"], V.shape[0], sl["col_mask"])
    cut = dataclasses.replace(big, **sl, n_real=min(n, big.n_real), scatter_perm=perm,
                              scatter_ends=ends)
    t0 = time.perf_counter()
    bcc = to_block_bucket(cut, V.shape[0])
    t_conv = time.perf_counter() - t0
    reset_launches()
    got = cut.xk_times_v_bcc(bcc, V)
    counts = launches()
    err, ok = within(got, cut.xk_times_v(V), False)
    print(f"[bcc] cut of the largest CC bucket: {n} of {big.kb} subjects, I_pad "
          f"{big.i_pad}, NB {bcc.n_blocks}, BCC values {bcc.vals.numel() * 4} B "
          f"({bcc.vals.numel() * 4 / 2**30:.3f} GiB), conversion {t_conv:.1f}s; "
          f"xk_times_v_bcc launched gather_matmul {counts['gather_matmul']} time(s); "
          f"max |bcc - cc| = {err:.3e}", flush=True)
    if counts["gather_matmul"] != 1 or not ok:
        fail("the BCC cut did not launch gather_matmul once or left xk_times_v")
    return cut, bcc, counts


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    import numpy as np
    import torch

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
    return float(np.median(out))


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` (the wrapper's checks and the
    launch, with the device idle before it): what a CUDA-event time of a
    short kernel adds to the kernel."""
    import numpy as np
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(out))


def captured_kernels(fn) -> int:
    """Device kernels that one call of ``fn`` enqueues, read back from the
    driver as the kernel nodes of a CUDA graph captured from the call,
    after a warm-up call on the capture's stream. Fails if the graph holds
    a node of another kind (a copy, a memset). A torch.profiler trace is not
    used for this: on an H100 (torch 2.11) a trace now and then held none of
    a short call's kernels, in three traces running."""
    import ctypes
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes could not count a captured call's nodes")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes could not list a captured call's nodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType could not read a captured node's kind")
        kinds.append(kind.value)
    torch.cuda.synchronize()
    del graph
    if any(k != 0 for k in kinds):             # CU_GRAPH_NODE_TYPE_KERNEL is 0
        fail(f"a captured call holds nodes other than kernels (kinds {sorted(set(kinds))})")
    return len(kinds)


def one_call(fn) -> tuple:
    """(device kernels, caching-allocator allocations, new device segments)
    of one call of ``fn``: the kernels from ``captured_kernels``, the
    allocations and the segments (cudaMalloc calls) from
    torch.cuda.memory_stats around a later eager call."""
    import torch

    n_kernels = captured_kernels(fn)
    fn()
    torch.cuda.synchronize()
    keys = ("allocation.all.allocated", "segment.all.allocated")
    before = [torch.cuda.memory_stats()[k] for k in keys]
    fn()
    after = [torch.cuda.memory_stats()[k] for k in keys]
    return n_kernels, after[0] - before[0], after[1] - before[1]


def work(name: str, K: int, I: int, C: int, R: int, itemsize: int) -> tuple:
    """(bytes, operations) the function needs: each input read once, each
    output written once; the slab and Yc are dense over the padded kept
    columns."""
    slab, ir, cr, kr, rr, krr = K * I * C, K * I * R, K * C * R, K * R, R * R, K * R * R
    rc = cr                                         # Yc [K, R, C]
    table = {
        "fused_procrustes_b": ((slab + cr + kr + rr + 2 * ir), 2 * slab * R + ir * (2 * R + 1)),
        "fused_mode1_xkv": ((2 * ir + kr + rr), 2 * ir * R + 2 * K * rr),
        "fused_mode2_compact": ((slab + ir + rr + kr + K * C + cr),
                                2 * slab * R + cr * (2 * R + 2)),
        "fused_ykv": ((slab + ir + cr + krr), 2 * slab * R + 2 * ir * R),
        "ykv": ((rc + cr + krr), 2 * krr * C),
        "mode1": ((rc + cr + kr + rr), 2 * krr * C + 2 * krr),
        "mode1_reuse": ((krr + kr + rr), 2 * krr),
        "mode2_compact": ((rc + rr + kr + K * C + cr), 2 * cr * R + 2 * cr),
        "mode3": ((rc + cr + rr + K + kr), 2 * krr * C + 2 * krr + kr),
        "mode3_reuse": ((krr + rr + K + kr), 2 * krr + kr),
    }
    nbytes, ops = table[name]
    return nbytes * itemsize, ops


def p1_work(K: int, R: int, itemsize: int) -> tuple:
    """(bytes, operations) of P1's function on K Grams, whatever method
    computes it: G read once and P_inv written once; per Gram the symmetric
    eigendecomposition with vectors by the QR algorithm's count, 9 R^3
    (Golub and Van Loan, Matrix Computations, 8.3), R inverse roots and the
    R (R + 1) / 2 entries of E diag E^T (3 R each). The operations are
    taken at the peak for G's dtype: the kernel's choice to solve in f64
    does not loosen its bound."""
    return 2 * K * R * R * itemsize, K * (9 * R ** 3 + 4 * R + R * (R + 1) // 2 * 3 * R)


def p1_main_path_check(G, R: int, label: str = "the main path's Grams",
                       tag: str = "[time]") -> tuple:
    """P1 on the main path's Grams G [K, R, R] against its plain version on
    the CPU (LAPACK), each Gram held to its own bound: max(floor, R * kappa
    * 2^-53) of its max |P_inv|, kappa over the eigenvalues the clamp keeps
    (subjects with fewer rows than R have Grams near singular, f32 rounding
    their null space into eigenvalues ~1e-8 of the largest), floor 1e-6 in
    f32 and 1e-12 in f64. The CPU's, since on the fitted Grams cuSOLVER's
    f64 eigh itself departs from LAPACK's by up to 1.1 times that bound,
    where P1 stays within 0.82 of it. Returns (max |kernel - plain|, max
    |plain|)."""
    import torch
    from repro_torch.kernels import polar

    floor = 1e-12 if G.dtype == torch.float64 else 1e-6
    P_inv = polar.gram_inv_sqrt(G)
    Gc = G.cpu()
    want = polar.gram_inv_sqrt_plain(Gc).to(G.device)
    lam = torch.linalg.eigvalsh(Gc.double()).to(G.device)
    top = lam[:, -1:].clamp(min=0.0)
    kept = torch.where(lam > top * 1e-12, lam, torch.full_like(lam, float("inf")))
    kappa = (top[:, 0] / kept.min(1).values).nan_to_num(nan=1.0, posinf=1.0)
    err_k = (P_inv.double() - want.double()).abs().amax((1, 2))
    scale_k = want.double().abs().amax((1, 2))
    bound_k = torch.clamp(R * kappa * 2.0 ** -53, min=floor) * scale_k
    if bool((err_k > bound_k).any()):
        k = int((err_k - bound_k).argmax())
        fail(f"gram_inv_sqrt on {label}, Gram {k} at R={R}: |kernel - plain| "
             f"{float(err_k[k]):.3e} > {float(bound_k[k]):.3e} (condition {float(kappa[k]):.3e})")
    print(f"{tag} gram_inv_sqrt on {label} (K={G.shape[0]}, R={R}, "
          f"{str(G.dtype).removeprefix('torch.')}): "
          f"max |kernel - plain| {float(err_k.max()):.3e} against max |plain| "
          f"{float(scale_k.max()):.3e}, each Gram within max({floor:.0e}, R kappa 2^-53) of its max "
          f"|P_inv| (largest relative error "
          f"{float((err_k / scale_k.clamp(min=1e-300)).max()):.3e}, condition up to "
          f"{float(kappa.max()):.3e})", flush=True)
    return float(err_k.max()), float(scale_k.max())


def p1_paper_ranks(bt, b) -> dict:
    """P1 at the paper's ranks past 5 (``P1_PAPER_RANKS``) on the Grams of
    the largest CC bucket ``b``: B from the auto route's F1 on
    ``init_state(rank=R, seed=0)``, G = B^T B; each checked against its
    plain version, then its time (CUDA events, median of 5) beside
    ``p1_work``'s bound and the library call (the chunked eigh; one call
    past R = 32, where cuSOLVER solves one Gram at a time)."""
    import torch
    from repro_torch.core import Parafac2Options, init_state
    from repro_torch.kernels import fused, polar

    out = {}
    for R in P1_PAPER_RANKS:
        st = init_state(bt, Parafac2Options(rank=R, backend="auto"), seed=0)
        Wb = st.W[b.subject_ids.long()] * b.subject_mask[:, None]
        _, B = fused.fused_procrustes_b(b.vals, b.gather_v(st.V), Wb, st.H.contiguous())
        G = B.transpose(1, 2) @ B
        del B
        err, scale = p1_main_path_check(G, R)
        nbytes, ops = p1_work(G.shape[0], R, G.element_size())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        ms = time_ms(lambda: polar.gram_inv_sqrt(G), reps=5, warmup=1)
        lib = time_ms(lambda: p1_library(G), *((5, 1) if R <= 32 else (1, 0)))
        out[R] = {"K": G.shape[0], "variant": polar.gram_inv_sqrt_variant(R), "ms": ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "library_ms": lib, "max_abs_err": err, "max_abs_plain": scale}
        print(f"[time] gram_inv_sqrt at R={R} (K={G.shape[0]}, f32, {out[R]['variant']}): "
              f"kernel {ms:.4f} ms, bound {out[R]['bound_ms']:.4f} ms ({out[R]['bound_by']}, "
              f"{nbytes} B, {ops} ops), library {lib:.4f} ms", flush=True)
    return out


def sparse_work(name: str, b, R: int) -> tuple:
    """(bytes, operations) of rows 11-13 on this run's data: each input read
    once, each output written once. Rows 11/12 read the true nonzeros (the
    pads lie past every segment), the segment ends, the factor rows the
    triplets touch (kept columns of Vg; rows of Q with a nonzero) and write
    the dense output; row 13 reads the BCC values (dense over the kept
    blocks), the block ids and the V blocks they name."""
    import torch

    isz = b.vals.element_size()
    if name == "gather_matmul":
        K, I, NB, L = b.vals.shape
        blocks = int(b.blk_ids[b.blk_mask > 0].unique().numel())
        return (isz * (K * I * NB * L + blocks * L * R + K * I * R) + 4 * K * NB,
                2 * K * I * NB * L * R)
    nnz = int(b.nnz_counts.sum())
    if name == "scoo_xk_times_v":
        kept = int(b.col_mask.sum())
        return (isz * (nnz + kept * R + b.kb * b.i_pad * R) + 4 * (nnz + b.kb * b.i_pad),
                2 * nnz * R)
    ends = b.row_ends
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    touched = int((ends > starts).sum())
    return (isz * (nnz + touched * R + b.kb * R * b.c_pad) + 4 * (2 * nnz + b.kb * b.c_pad),
            2 * nnz * R)


def block_csr(b, transpose: bool = False):
    """A SCOO bucket's X_k stacked block-diagonally as one CSR matrix
    [Kb*I, Kb*C] (or its transpose), for the library yardstick."""
    import torch

    kb, N = b.vals.shape
    real = torch.arange(N, device=b.vals.device)[None, :] < b.nnz_counts[:, None]
    k = torch.arange(kb, device=b.vals.device)[:, None].expand(kb, N)[real]
    r = k * b.i_pad + b.rows[real].long()
    c = k * b.c_pad + b.lcols[real].long()
    shape = (kb * b.i_pad, kb * b.c_pad)
    idx = torch.stack([c, r] if transpose else [r, c])
    return torch.sparse_coo_tensor(idx, b.vals[real], shape[::-1] if transpose else shape
                                   ).coalesce().to_sparse_csr()


def cc_csr(b, J: int):
    """A CC bucket's X_k stacked over the global columns, [Kb*I, J] CSR."""
    import torch

    k, i, c = b.vals.nonzero(as_tuple=True)
    idx = torch.stack([k * b.i_pad + i, b.cols[k, c].long()])
    return torch.sparse_coo_tensor(idx, b.vals[k, i, c], (b.kb * b.i_pad, J)
                                   ).coalesce().to_sparse_csr()


def p2_work(N: int, R: int, itemsize: int) -> tuple:
    """(bytes, operations) of P2's function: Y read once and Z written once;
    by Thomas's count, per row the pivot and its multiplier (3) and per row
    and column the right-hand side's scaling, its elimination (3) and the
    back substitution (2)."""
    return 2 * N * R * itemsize, N * (3 + 6 * R)


def cc_library(b, args: dict, H, XkV, Wb) -> dict:
    """One PyTorch call for each of the ten CC kernels' functions on
    ``kernel_args``' operands (the port never calls them; F1's is its X_k
    Vg_k only)."""
    import torch

    Vg, Q = args["fused_procrustes_b"][1], args["fused_ykv"][1]
    Yc, YkV, m = args["ykv"][0], args["mode1_reuse"][0], b.subject_mask
    return {
        "fused_procrustes_b": lambda: torch.bmm(b.vals, Vg),
        "fused_mode1_xkv": lambda: torch.einsum("kir,kil,kl->rl", Q, XkV, Wb),
        "fused_mode2_compact": lambda: torch.einsum(
            "kic,kir,rl,kl,kc->kcl", b.vals, Q, H, Wb, b.col_mask),
        "fused_ykv": lambda: torch.einsum("kir,kic,kcl->krl", Q, b.vals, Vg),
        "ykv": lambda: torch.bmm(Yc, Vg),
        "mode1": lambda: torch.einsum("krc,kcl,kl->rl", Yc, Vg, Wb),
        "mode1_reuse": lambda: torch.einsum("krl,kl->rl", YkV, Wb),
        "mode2_compact": lambda: torch.einsum("krc,rl,kl,kc->kcl", Yc, H, Wb, b.col_mask),
        "mode3": lambda: torch.einsum("krc,kcl,rl,k->kl", Yc, Vg, H, m),
        "mode3_reuse": lambda: torch.einsum("krl,rl,k->kl", YkV, H, m),
    }


def phase4_cores(bt, comp, state, core_launches: dict, range_launches: int) -> list:
    """F1-F4 and rows 5, 7, 8 and 10 at CC auto's largest core bucket
    [Kb, 18, 128] on the compressed fit's state (Q from F1 and P1 there, as
    the core iteration forms it), and P1 at R = 18 on the range finder's
    Grams of the same original bucket: each against its plain version (P1
    Gram by Gram against LAPACK), its time by events and in a replayed CUDA
    graph (``kernel_ab.graph_ms``), its plain version's and one PyTorch
    call's, beside its bound. Rows ``<kernel>[core]`` and
    ``gram_inv_sqrt[range]``; launches from the core fit of phase 3 (the
    range Grams: the pass's)."""
    import torch
    from repro_torch.core.procrustes import solve_q
    from repro_torch.kernels import fused, mttkrp_mode2, polar, sketch, ykv
    from repro_torch.launch.kernel_ab import graph_ms

    i = max(range(len(comp.buckets)), key=lambda j: comp.buckets[j].core.vals.numel())
    b, orig = comp.buckets[i].core, bt.buckets[i]
    H, V, W = state.H.contiguous(), state.V, state.W
    R = H.shape[0]
    Wb = W[b.subject_ids.long()] * b.subject_mask[:, None]
    XkV, B = fused.fused_procrustes_b(b.vals, b.gather_v(V), Wb, H)
    Q = solve_q(B) * b.subject_mask[:, None, None]
    all_args = kernel_args(b, H, V, W, Q)
    args = {k: a for k, a in all_args.items() if k in CORE_KERNELS}
    errs: dict = {}
    check_kernels(args, errs)
    library = cc_library(b, all_args, H, XkV, Wb)
    K, S, C = b.vals.shape
    Yc = args["ykv"][0]
    variant = {"fused_procrustes_b": fused.procrustes_b_variant(b.vals, R),
               "fused_mode1_xkv": fused.mode1_xkv_variant(*args["fused_mode1_xkv"][:2]),
               "fused_mode2_compact": fused.mode2_compact_fused_variant(b.vals, R),
               "fused_ykv": fused.ykv_fused_variant(b.vals, R),
               "ykv": ykv.ykv_variant(*args["ykv"]),
               "mode2_compact": mttkrp_mode2.mode2_compact_variant(Yc, b.col_mask),
               "mode3_reuse": "thread-per-entry"}
    table = kernels()
    stream = torch.cuda.Stream()
    rows = []

    def row(name, fn, plain_fn, lib_fn, nbytes, ops, source, launches, err, scale, extra):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": REPLACES[name.split("[")[0]], "launches": launches,
             "max_abs_err": err, "max_abs_plain": scale, "ms": time_ms(fn),
             "graph_ms": graph_ms(fn, stream), "plain_ms": time_ms(plain_fn, *extra),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": time_ms(lib_fn, *extra) if lib_fn else None,
             "host_ms": host_ms(fn)}
        r["share_of_bound"] = r["bound_ms"] / r["graph_ms"]
        rows.append(r)
        return r

    for name, a in args.items():
        wrapper, plain, source = table[name]
        route = "auto" if name in FUSED else "staged"
        r = row(f"{name}[core]", lambda: wrapper(*a), lambda: plain(*a), library[name],
                *work(name, K, S, C, R, b.vals.element_size()), source,
                core_launches[route][name], *errs[name], ())
        if name in variant:
            r["variant"] = variant[name]
        print(f"[core-time] {name} at the largest core bucket K={K} S={S} C={C} R={R} f32: "
              f"kernel {r['ms']:.4f} ms, in a graph {r['graph_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['share_of_bound']:.0%} of it in a "
              f"graph), plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, wrapper "
              f"host time {r['host_ms']:.4f} ms, variant {r.get('variant', 'one design')}; "
              f"max |kernel - plain| {r['max_abs_err']:.3e}", flush=True)

    # P1 at R = 18 on the range finder's Grams of the same original bucket
    omega = sketch.gaussian_sketch(0, bt.n_cols, S, torch.float32, b.vals.device)
    Y = sketch.power_iterate(orig, sketch.sketch_bucket(orig, omega), 1)
    G = Y.transpose(1, 2) @ Y
    del Y
    thin = int(((orig.row_counts < S) & (orig.subject_mask > 0)).sum())
    err, scale = p1_main_path_check(G, S, label=f"the range Grams of the largest CC bucket "
                                    f"({thin} thin subjects)", tag="[core-time]")
    r = row("gram_inv_sqrt[range]", lambda: polar.gram_inv_sqrt(G), lambda: p1_plain(G),
            lambda: p1_library(G), *p1_work(K, S, G.element_size()),
            "src/repro_torch/csrc/polar.cu", range_launches, err, scale, (5, 1))
    r["variant"] = polar.gram_inv_sqrt_variant(S)
    r["port_only"] = True
    print(f"[core-time] gram_inv_sqrt on the range Grams K={K} R={S} f32 ({r['variant']}): "
          f"kernel {r['ms']:.4f} ms, in a graph {r['graph_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['share_of_bound']:.1%} of it), plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms", flush=True)
    return rows


def phase4_times(bt, bt_sc, bcc_pair, state, per_kernel, errs, w_state):
    import torch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.procrustes import solve_q
    from repro_torch.kernels import (fused, mttkrp_mode1, mttkrp_mode2, mttkrp_mode3, polar,
                                     scoo, tridiag, ykv)
    from repro_torch.launch.kernel_ab import graph_ms

    b = max(bt.buckets, key=lambda x: x.vals.numel())
    H, V, W = state.H.contiguous(), state.V, state.W
    Vg = b.gather_v(V)
    Wb = W[b.subject_ids.long()] * b.subject_mask[:, None]
    XkV, B = fused.fused_procrustes_b(b.vals, Vg, Wb, H)
    Q = solve_q(B) * b.subject_mask[:, None, None]
    args = kernel_args(b, H, V, W, Q)
    check_kernels(args, errs)                     # at the main path's shapes too
    Yc = args["ykv"][0]
    library = cc_library(b, args, H, XkV, Wb)
    K, I, C = b.vals.shape
    R = H.shape[0]
    where = dict.fromkeys(args, f"K={K} I={I} C={C}")
    need = {name: work(name, K, I, C, R, b.vals.element_size()) for name in args}

    # rows 11 and 12 at the largest SCOO bucket, on the Q the staged route forms
    bs = max(bt_sc.buckets, key=lambda x: x.kb)
    Wbs = W[bs.subject_ids.long()] * bs.subject_mask[:, None]
    _, Bs = get_backend("staged").procrustes_b_bucket(bs, H, Wbs, V)
    sargs, scales = scoo_args(bs, V, solve_q(Bs) * bs.subject_mask[:, None, None])
    check_kernels(sargs, errs, scales)
    A, At = block_csr(bs), block_csr(bs, transpose=True)
    Vgs, Qs = sargs["scoo_xk_times_v"][3], sargs["scoo_project"][3]
    library["scoo_xk_times_v"] = lambda: torch.sparse.mm(A, Vgs.reshape(-1, R))
    library["scoo_project"] = lambda: torch.sparse.mm(At, Qs.reshape(-1, R))   # (Q^T X)^T
    # row 13 on the BCC cut
    cut, bcc = bcc_pair
    bargs = bcc_args(bcc, V)
    check_kernels(bargs, errs)
    Ac = cc_csr(cut, V.shape[0])
    library["gather_matmul"] = lambda: torch.sparse.mm(Ac, V)
    # the same function in one PyTorch call on the kernel's own operands
    # (the gather of V's blocks inside the timed call)
    bvals, bids, Vp = bargs["gather_matmul"]
    same_input = {"gather_matmul": lambda: torch.einsum(
        "kibl,kblr->kir", bvals, Vp.view(-1, 128, R)[bids.long()])}
    for name in SCOO:
        where[name] = (f"Kb={bs.kb} I={bs.i_pad} C={bs.c_pad} N={bs.n_pad} "
                       f"nnz={int(bs.nnz_counts.sum())}")
        need[name] = sparse_work(name, bs, R)
    where["gather_matmul"] = f"K={bcc.kb} I={bcc.i_pad} NB={bcc.n_blocks} L=128"
    need["gather_matmul"] = sparse_work("gather_matmul", bcc, R)
    args.update(sargs)
    args.update(bargs)
    # P1 on the main path's own Grams at the largest CC bucket
    G = B.transpose(1, 2) @ B
    p1_err, p1_scale = p1_main_path_check(G, R)
    e, sc = errs["gram_inv_sqrt"]
    errs["gram_inv_sqrt"] = (max(e, p1_err), max(sc, p1_scale))
    args["gram_inv_sqrt"] = (G,)
    library["gram_inv_sqrt"] = lambda: p1_library(G)
    where["gram_inv_sqrt"] = f"K={G.shape[0]} (the largest CC bucket's Grams)"
    need["gram_inv_sqrt"] = p1_work(G.shape[0], R, G.element_size())
    p1_by_rank = p1_paper_ranks(bt, b)
    # P2 at the W update of the main path's l1-smooth fit: its fitted W [K, R]
    # as Y, rho a device scalar, lam 0.1
    Yw = w_state.W.contiguous()
    p2_args = {"tridiag_solve": (Yw, torch.ones((), dtype=Yw.dtype, device=Yw.device), 0.1)}
    check_kernels(p2_args, errs)
    args.update(p2_args)
    library["tridiag_solve"] = None       # no PyTorch call solves a tridiagonal system
    where["tridiag_solve"] = f"N={Yw.shape[0]} (W's rows), lam 0.1"
    need["tridiag_solve"] = p2_work(*Yw.shape, Yw.element_size())

    rows = []
    for name, (wrapper, plain, source) in kernels().items():
        a = args[name]
        nbytes, ops = need[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (F64_FLOPS if b.vals.dtype == torch.float64 else F32_FLOPS) * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": per_kernel[name],
            "max_abs_err": errs[name][0],
            "max_abs_plain": errs[name][1],      # the scale max_abs_err reads against
            "ms": time_ms(lambda: wrapper(*a)),
            "plain_ms": time_ms(lambda: plain(*a)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(library[name]) if library[name] else None,
            "host_ms": host_ms(lambda: wrapper(*a)),
        })
        r = rows[-1]
        extra = ""
        if name == "fused_procrustes_b":
            r["variant"] = fused.procrustes_b_variant(b.vals, R)
        if name == "fused_mode1_xkv":
            r["variant"] = fused.mode1_xkv_variant(*a[:2])
        if name in ("fused_mode2_compact", "fused_ykv"):
            r["variant"] = (fused.mode2_compact_fused_variant if name == "fused_mode2_compact"
                            else fused.ykv_fused_variant)(b.vals, R)
        if name == "ykv":
            r["variant"] = ykv.ykv_variant(*a)
        if name == "scoo_xk_times_v":
            r["variant"] = scoo.scoo_xk_times_v_variant(*a[:5], row_ends=a[5])
        if name == "mode2_compact":
            r["variant"] = mttkrp_mode2.mode2_compact_variant(Yc, b.col_mask)
        if name == "mode3":
            r["variant"] = mttkrp_mode3.mode3_variant(*a[:2])
        if name == "mode3_reuse":
            r["variant"] = "thread-per-entry"      # its one design, on one wave of blocks
        if name == "scoo_project":
            r["variant"] = scoo.scoo_project_variant(
                *a[:5], cperm=a[5], col_ends=a[6])
        if name == "gram_inv_sqrt":
            r["variant"] = polar.gram_inv_sqrt_variant(R)
            r["port_only"] = True          # the reference's jnp.linalg.eigh, no Pallas kernel
            r["by_rank"] = p1_by_rank      # the paper's other ranks, on the same bucket
        if name == "tridiag_solve":
            r["port_only"] = True          # the reference's lax tridiagonal_solve, no Pallas kernel
            r["graph_ms"] = graph_ms(lambda: wrapper(*a), torch.cuda.Stream())
            # the kernels of one C call (one launch), counted in a captured graph
            n_k, n_alloc, n_seg = one_call(lambda: wrapper(*a))
            r["device_kernels_per_call"] = n_k
            r["allocations_per_call"] = {"caching_allocator": n_alloc, "device_segments": n_seg}
            extra = (f", in a graph {r['graph_ms']:.4f} ms, {n_k} device kernels a call, "
                     f"{n_alloc} allocation(s) a repeated call (the result), {n_seg} new "
                     f"device segment(s)")
            want_k = tridiag.device_kernels(a[0].shape[0])
            if n_k != want_k or n_alloc != 1 or n_seg != 0:
                fail(f"tridiag_solve: {n_k} device kernels, {n_alloc} allocations and {n_seg} "
                     f"new segments a call; want {want_k} (one launch), 1 (the result) and 0")
        if "variant" in r:
            extra = f", variant {r['variant']}"
        if name in same_input:
            r["library_same_input_ms"] = time_ms(same_input[name])
            extra = f", library on the same input {r['library_same_input_ms']:.4f} ms"
        print(f"[time] {name} at {where[name]} R={R} f32: kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes} B, {ops} ops), "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
              f"wrapper host time {r['host_ms']:.4f} ms{extra}", flush=True)
    # the two reductions across subjects: one device kernel a call, and on a
    # repeated call one allocation (the result), no new device memory and
    # the same workspace
    for r in rows:
        if r["name"] == "gram_inv_sqrt":     # one kernel, the result its one allocation
            n_k, n_alloc, n_seg = one_call(lambda: polar.gram_inv_sqrt(G))
            r["device_kernels_per_call"] = n_k
            print(f"[time] gram_inv_sqrt: {n_k} device kernel(s) a call, {n_alloc} "
                  f"allocation(s) a repeated call", flush=True)
            if n_k != 1 or n_alloc != 1:
                fail(f"gram_inv_sqrt: {n_k} device kernels and {n_alloc} allocations a call; "
                     f"want 1 and 1 (the result)")
        if r["name"] not in ("fused_mode1_xkv", "mode1_reuse"):
            continue
        wrapper, a = kernels()[r["name"]][0], args[r["name"]]
        ws = (fused if r["name"] == "fused_mode1_xkv" else mttkrp_mode1).WORKSPACES
        n_k, n_alloc, n_seg = one_call(lambda: wrapper(*a))
        held = dict(ws._ws)
        wrapper(*a)
        same_ws = ws._ws.keys() == held.keys() and all(ws._ws[k] is t for k, t in held.items())
        r["device_kernels_per_call"] = n_k
        r["allocations_per_call"] = {"caching_allocator": n_alloc, "device_segments": n_seg}
        print(f"[time] {r['name']}: {n_k} device kernel(s) a call, {n_alloc} allocation(s) "
              f"a repeated call (the result), {n_seg} new device segment(s), workspace "
              f"{'kept' if same_ws else 'replaced'}", flush=True)
        if n_k != 1 or n_alloc != 1 or n_seg != 0 or not same_ws:
            fail(f"{r['name']}: {n_k} device kernels, {n_alloc} allocations and {n_seg} new "
                 f"segments a call, workspace {'kept' if same_ws else 'replaced'}; want 1, "
                 f"1 (the result), 0 and kept")
    return rows


def phase5_profile(bt, bt_sc, iter_ms: dict, scan_ms: dict, con_ms: dict, cores,
                   served: dict) -> None:
    """Where one main-path iteration's time goes on the auto and the staged
    route over the CC buckets and on the staged and the scoo route over the
    SCOO buckets, and at bf16 on CC auto and SCOO staged (from the fit's
    half copy of the values), then in one replayed 10-iteration chunk of the scan engine
    on the CC auto, CC staged and SCOO staged routes, against an unprofiled
    replay of the same chunk just before it; ``iter_ms`` and ``scan_ms`` are
    the unprofiled times per iteration of phase 3. ``cores`` is CC auto's
    rsvd core data: one core iteration of the compressed path is profiled
    beside the others (``auto-cores``). ``served`` holds phase 3's auto
    8-slot stream service and payloads it has not seen: one more dispatch is
    profiled last."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Parafac2Options, als_step, engine, init_state

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    for route, data in (("auto", bt), ("staged", bt), ("staged-scoo", bt_sc),
                        ("scoo-scoo", bt_sc), ("auto bf16", bt), ("staged-scoo bf16", bt_sc),
                        ("auto-cores", cores)):
        prec = "bf16" if route.endswith("bf16") else "f32"
        opts = Parafac2Options(rank=5, backend=route.split("-")[0].split()[0], precision=prec)
        data = data.with_compute_values(prec)
        state = als_step(data, init_state(data, opts, seed=0), opts)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = als_step(data, state, opts)
            float(state.fit)                       # the host loop's one sync
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(OUT / f"als_step_trace_{route}.json"))
        events = prof.key_averages()
        # device kernels only: an aten op also reports the time of the kernels
        # it launched, which would count them twice
        kernels_ = [e for e in events if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in kernels_) / 1e3
        runs = [e.time_range for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if not runs or busy_ms <= 0:
            fail(f"the profiled {route} iteration ran nothing on the device")
        span_ms = (max(r.end for r in runs) - min(r.start for r in runs)) / 1e3
        it = iter_ms[route if prec == "f32" else route.replace(" bf16", "") + " bf16 host"]
        print(f"[profile] one {route} iteration: device busy {busy_ms:.3f} ms; against "
              f"the unprofiled {it:.3f} ms/iter of phase 3: busy {busy_ms / it:.1%}, "
              f"idle {1 - busy_ms / it:.1%}; against the trace's first-to-last kernel "
              f"span {span_ms:.3f} ms: busy {busy_ms / span_ms:.1%}; profiled wall "
              f"{wall_ms:.3f} ms (inflated by the profiler, not a denominator)")
        for e in sorted(kernels_, key=dev_us, reverse=True)[:12]:
            print(f"[profile] {route} device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                  f"{e.key[:90]}")
        own, mark = {}, "void (anonymous namespace)::"   # the port's kernels (csrc/*.cu)
        for e in kernels_:
            if e.key.startswith(mark):
                body = e.key[len(mark):].split("(")[0]
                ms_, n_ = own.get(body, (0.0, 0))
                own[body] = (ms_ + dev_us(e) / 1e3, n_ + e.count)
        print(f"[profile] {route} port kernels (device ms, launches): "
              + json.dumps({k: [round(v[0], 4), v[1]] for k, v in sorted(own.items())}))
        del data, state
        for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
            print(f"[profile] {route} host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<6d} {e.key[:90]}")

    # the constrained fits on CC auto: where an ADMM iteration's time goes
    for cname, specs in CONSTRAINED.items():
        opts = Parafac2Options(rank=5, backend="auto", constraints=specs)
        state = als_step(bt, init_state(bt, opts, seed=0), opts)       # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state = als_step(bt, state, opts)
            float(state.fit)
        kernels_ = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in kernels_) / 1e3
        mark = "void (anonymous namespace)::"      # csrc/tridiag.cu's one kernel
        p2 = [e for e in kernels_ if e.key.startswith(mark) and
              e.key[len(mark):].split("<")[0] == "tridiag_kernel"]
        p2_ms = sum(dev_us(e) for e in p2) / 1e3
        if busy_ms <= 0 or (specs["w"].startswith("smooth") and not p2):
            fail(f"the profiled CC auto {cname} iteration ran no P2 or nothing on the device")
        it = con_ms[f"{cname} auto host"]
        print(f"[profile] CC auto {cname} {specs}: device busy {busy_ms:.3f} ms an iteration; "
              f"against the unprofiled {it:.3f} ms/iter of phase 3: busy {busy_ms / it:.1%}; "
              f"P2 {p2_ms:.3f} ms in {sum(e.count for e in p2)} device kernels", flush=True)
        for e in sorted(kernels_, key=dev_us, reverse=True)[:8]:
            print(f"[profile] auto {cname} device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:90]}", flush=True)
        del state

    # CC auto at the paper's ranks past 5: where P1 stands in an iteration
    for R in P1_PAPER_RANKS:
        opts = Parafac2Options(rank=R, backend="auto")
        state = init_state(bt, opts, seed=0)
        for _ in range(2):                         # unprofiled; the second one timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = als_step(bt, state, opts)
            float(state.fit)
            it = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state = als_step(bt, state, opts)
            float(state.fit)
        kernels_ = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in kernels_) / 1e3
        p1 = [e for e in kernels_ if "jacobi_" in e.key]      # csrc/polar.cu's kernels
        p1_ms = sum(dev_us(e) for e in p1) / 1e3
        if busy_ms <= 0 or not p1:
            fail(f"the profiled CC auto iteration at R={R} ran no P1 on the device")
        print(f"[profile] CC auto at R={R}: device busy {busy_ms:.3f} ms an iteration "
              f"(an unprofiled iteration before it {it:.3f} ms); P1 {p1_ms:.3f} ms in "
              f"{sum(e.count for e in p1)} launches, {p1_ms / busy_ms:.1%} of the device time",
              flush=True)
        for e in sorted(kernels_, key=dev_us, reverse=True)[:6]:
            print(f"[profile] auto R={R} device {dev_us(e) / 1e3:9.3f} ms  "
                  f"{dev_us(e) / 1e3 / busy_ms:6.1%}  x{e.count:<4d} {e.key[:80]}", flush=True)
        del state

    for route, data in (("auto", bt), ("staged", bt), ("staged-scoo", bt_sc)):
        opts = scan_opts(route.split("-")[0], 10)
        chunk = engine.make_als_chunk(data, opts, 10, state=init_state(data, opts, seed=0))
        state, fits = chunk(init_state(data, opts, seed=0))
        fits.tolist()                              # one replay before the timed ones
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, fits = chunk(state)
        fits.tolist()
        it = (time.perf_counter() - t0) / 10 * 1e3  # this replay, unprofiled, an iteration
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, fits = chunk(state)
            fits.tolist()                          # the chunk's one read of the fits
        if route == "auto":
            prof.export_chrome_trace(str(OUT / "scan_chunk_trace_auto.json"))
        kernels_ = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in kernels_) / 1e3 / 10
        runs = [e.time_range for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if not runs or busy_ms <= 0:
            print(f"[profile] scan {route}: the profiler saw no kernel of the replayed chunk; "
                  f"device busy share not measured", flush=True)
            continue
        span_ms = (max(r.end for r in runs) - min(r.start for r in runs)) / 1e3 / 10
        print(f"[profile] one replayed 10-iteration {route} chunk (scan engine): device busy "
              f"{busy_ms:.3f} ms an iteration; against the same chunk's unprofiled replay "
              f"before it, {it:.3f} ms an iteration (phase 3: {scan_ms[f'{route} scan10']:.3f}): "
              f"busy {busy_ms / it:.1%}, idle {1 - busy_ms / it:.1%}; against the "
              f"first-to-last kernel span ({span_ms:.3f} ms an iteration): busy "
              f"{busy_ms / span_ms:.1%}", flush=True)
        for e in sorted(kernels_, key=dev_us, reverse=True)[:8]:
            print(f"[profile] scan {route} device {dev_us(e) / 1e3 / 10:9.3f} ms/iter  "
                  f"x{e.count:<6d} {e.key[:90]}")
        del chunk

    # one 8-slot dispatch of the stream service (CC batches on auto)
    svc = served["svc"]
    for p in served["payloads"]:
        svc.submit(p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.flush()                                # one dispatch, its one sync
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(OUT / "stream_dispatch_trace_auto.json"))
    events = prof.key_averages()
    kernels_ = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels_) / 1e3
    if busy_ms <= 0:
        fail("the profiled stream dispatch ran nothing on the device")
    lat = sorted(svc.batch_latencies)
    print(f"[profile] one 8-slot stream dispatch (auto, CC): device busy {busy_ms:.3f} ms in "
          f"{sum(e.count for e in kernels_)} kernels; profiled wall {wall_ms:.3f} ms "
          f"(inflated by the profiler); unprofiled dispatches' median "
          f"{lat[len(lat) // 2] * 1e3:.3f} ms: busy {busy_ms / (lat[len(lat) // 2] * 1e3):.1%}",
          flush=True)
    for e in sorted(kernels_, key=dev_us, reverse=True)[:10]:
        print(f"[profile] stream device {dev_us(e) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]:
        print(f"[profile] stream host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")


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
    bt, bt_sc, bcc_pair, state, per_kernel, iter_ms, hist, peaks, data = phase3_main_path(dev)
    scan_ms = phase3_engines(bt, bt_sc, hist, iter_ms, peaks)
    free_cached("the scan engine")
    half_errs, half_launches, half_ms = phase3_half(bt, bt_sc, state, hist, iter_ms, peaks)
    iter_ms.update(half_ms)
    free_cached("half precision")
    con = phase3_constrained(bt, bt_sc)
    free_cached("the constrained fits")
    per_kernel["tridiag_solve"] = con["p2_launches"]
    cmp = phase3_compress(bt, bt_sc, hist)
    iter_ms["auto-cores"] = cmp["ms"]["auto"]
    free_cached("the compressed fits")
    phase3_mesh(bt, bt_sc, state, data)
    free_cached("the mesh phase")
    served = phase3_stream(bt, state, data)
    del data
    free_cached("the stream service")
    phase3_supervisor(bt)
    free_cached("the supervised fits")
    rows = phase4_times(bt, bt_sc, bcc_pair, state, per_kernel, errs, con.pop("state"))
    rows += phase4_half(bt, bt_sc, state, half_launches, half_errs)
    rows += phase4_cores(bt, cmp["comp"], cmp["state"], cmp["launches"], cmp["range_launches"])
    phase5_profile(bt, bt_sc, iter_ms, scan_ms, con["ms"], cmp["comp"].data, served)
    free_cached("the profiles")
    phase3_lm(dev)
    phase3_lm_train()
    phase3_lm_mesh()
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    CHILDREN = {"--lm-full-width": lm_full_width_child, "--lm-train": lm_train_child,
                "--lm-mesh": lm_mesh_child}
    sys.exit(CHILDREN[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in CHILDREN else main())
