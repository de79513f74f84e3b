"""SPARTan MTTKRP on the CC bucketed format (``repro.core.spartan``).

All three modes work directly on the frontal slices Y_k (never forming the
R x J x K intermediate tensor), batched over the subjects of a bucket, and
exploit column sparsity through the CC gather. These are the plain torch
versions behind :class:`repro_torch.core.backend.TorchBackend`.

Shapes per bucket (Kb subjects, C kept columns padded, rank R):
  Yc  [Kb, R, C]   compressed slices  Y_k = Q_k^T X_k
  Vg  [Kb, C, R]   gathered V rows for kept columns
  Wb  [Kb, R]      W rows for this bucket's subjects
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import HALF_DTYPES, accum_dtype

__all__ = [
    "bmm_acc",
    "mode1_bucket",
    "mode2_bucket_compact",
    "mode2_scatter",
    "mode3_bucket",
]


def _f(x: torch.Tensor) -> torch.Tensor:
    """Promote to the accumulation dtype (``kernels.common.accum_dtype``)."""
    return x.to(accum_dtype(x))


def bmm_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` summed and returned in the accumulation dtype,
    the reference's ``preferred_element_type=accum_dtype``: two CUDA
    operands of one half dtype go to cuBLAS as they are, with a float32
    result (``out_dtype``; the half reductions are off,
    ``device.resolve_device``), so the slab is not widened in memory; any
    other pair is widened first (the CPU's bmm has no ``out_dtype``)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in HALF_DTYPES:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(_f(a), _f(b))


def mode1_bucket(Yc, Vg, Wb, subject_mask, *, YkV=None) -> torch.Tensor:
    """Partial M1 [R, R] = sum_k (Y_k V) * W(k,:) for one bucket. With
    ``YkV`` [Kb,R,R] given (the mode-1 reuse identity), the gather and
    product are skipped."""
    if YkV is None:
        YkV = bmm_acc(Yc, Vg)
    scaled = _f(YkV) * _f(Wb)[:, None, :]
    return torch.einsum("krl,k->rl", scaled, subject_mask.to(scaled.dtype))


def mode2_bucket_compact(Yc, H, Wb, col_mask, subject_mask) -> torch.Tensor:
    """Compact per-column results A [Kb, C, R] = (Y_k^T H) * W(k,:); rows of
    padded columns and subjects are 0."""
    A = torch.matmul(_f(Yc).transpose(1, 2), H)
    A = A * _f(Wb)[:, None, :]
    return A * (col_mask * subject_mask[:, None])[..., None]


def mode2_scatter(A: torch.Tensor, cols: torch.Tensor, J: int, *,
                  order: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Scatter-add compact results A [Kb, C, R] into M2 [J, R].

    Deterministic: the flat rows are gathered in column order (``order`` =
    ``irregular.scatter_order(cols, J)``, precomputed once per bucket) and
    summed per column as the difference of an f64 running sum at the column
    ends — the reference's sorted segment sum, with its f64 accumulator. No
    atomics, so two runs on a GPU give the same bits.
    """
    if order is None:
        from repro_torch.core.irregular import scatter_order
        order = scatter_order(cols, J)
    perm, ends = order
    R = A.shape[-1]
    g = A.reshape(-1, R)[perm].to(torch.float64)
    cs = torch.cat([g.new_zeros((1, R)), _running_sum(g)], 0)
    seg = cs[ends]                                             # [J, R]
    return torch.diff(seg, dim=0, prepend=g.new_zeros((1, R))).to(A.dtype)


def _running_sum(g: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive running sum of g [N, R] over its rows, in a fixed order:
    running sums inside blocks of ``block`` rows plus the running sum of the
    block totals before each block. One ``cumsum`` over all N rows runs each
    of the R columns as one sequential scan on CUDA (1.36 s per call at 7.4 M
    rows on an H100); the blocks give the scan N/block-fold parallelism."""
    N, R = g.shape
    nb = -(-N // block)
    x = torch.cat([g, g.new_zeros((nb * block - N, R))]).view(nb, block, R)
    x = torch.cumsum(x, 1)
    before = torch.cat([g.new_zeros((1, R)), torch.cumsum(x[:-1, -1], 0)], 0)
    return (x + before[:, None, :]).reshape(-1, R)[:N]


def mode3_bucket(Yc, Vg, H, subject_mask, *, YkV=None) -> torch.Tensor:
    """Per-subject rows of M3 for one bucket, coldot(H, Y_k V): [Kb, R]."""
    if YkV is None:
        YkV = bmm_acc(Yc, Vg)
    rows = torch.einsum("rl,krl->kl", H.to(accum_dtype(YkV)), _f(YkV))
    return rows * subject_mask[:, None]
