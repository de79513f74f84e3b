"""SPARTan mode-1 MTTKRP (``repro.kernels.mttkrp_mode1``), CUDA kernels.

``M1 = sum_k (Y_k V) * W(k,:)`` [R, R], a reduction across the subjects of
a bucket, in two forms:

* :func:`mode1` forms Y_k V from Yc and the gathered V rows;
* :func:`mode1_reuse` takes Y_k V cached ([K, R, R], the ``mode1_reuse``
  path: Y_k V = Q_k^T (X_k V) from the Procrustes step).

``subject_mask`` is folded into W(k,:), which masks a subject's whole
contribution. On CUDA tensors each launches its kernel of
``csrc/staged.cu`` (two-level, deterministic: two runs give the same bits)
or raises; on the CPU it runs its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import check_shapes, dtype_code, on_cpu
from repro_torch.kernels.common import accum_dtype, fold_subject_mask
from repro_torch.kernels.staged import LIB

__all__ = ["mode1", "mode1_reuse", "mode1_plain", "mode1_reuse_plain"]


def mode1_plain(Yc, Vg, Wb, subject_mask=None) -> torch.Tensor:
    return ref.mode1_ref(Yc, Vg, fold_subject_mask(Wb, subject_mask))


def mode1_reuse_plain(YkV, Wb, subject_mask=None) -> torch.Tensor:
    return ref.mode1_reuse_ref(YkV, fold_subject_mask(Wb, subject_mask))


def _partials(K: int, R: int, like: torch.Tensor):
    """The first level's [n, R, R] partials (one per block) and the [R, R]
    output, as the kernels of rows 6 and 7 want them."""
    n = LIB.lib().spartan_staged_partials(K)
    return (n, torch.empty((n, R, R), dtype=like.dtype, device=like.device),
            torch.empty((R, R), dtype=like.dtype, device=like.device))


def mode1(Yc: torch.Tensor, Vg: torch.Tensor, Wb: torch.Tensor,
          subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Yc [K,R,C], Vg [K,C,R], Wb [K,R] -> [R,R]. ``subject_mask`` [K]
    (1.0 = real subject) is folded into Wb."""
    K, R, C = Yc.shape
    check_shapes(Vg=(Vg, (K, C, R)), Wb=(Wb, (K, R)))
    if K == 0 or C == 0:
        return Yc.new_zeros((R, R), dtype=accum_dtype(Yc))
    if on_cpu(Yc, Vg, Wb):
        return mode1_plain(Yc, Vg, Wb, subject_mask)
    Wb = fold_subject_mask(Wb, subject_mask)
    code = dtype_code(Yc, Vg, Wb)
    n, partials, out = _partials(K, R, Yc)
    LIB.launch("mode1", "spartan_mode1", Yc.device, code, Yc.data_ptr(),
               Vg.data_ptr(), Wb.data_ptr(), partials.data_ptr(), out.data_ptr(),
               K, R, C, n)
    return out


def mode1_reuse(YkV: torch.Tensor, Wb: torch.Tensor,
                subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """YkV [K,R,R] (= Y_k V, cached), Wb [K,R] -> [R,R]: the Hadamard with
    W(k,:) and the subject reduction only."""
    K, R, _ = YkV.shape
    check_shapes(YkV=(YkV, (K, R, R)), Wb=(Wb, (K, R)))
    if K == 0:
        return YkV.new_zeros((R, R), dtype=accum_dtype(YkV))
    if on_cpu(YkV, Wb):
        return mode1_reuse_plain(YkV, Wb, subject_mask)
    Wb = fold_subject_mask(Wb, subject_mask)
    code = dtype_code(YkV, Wb)
    n, partials, out = _partials(K, R, YkV)
    LIB.launch("mode1_reuse", "spartan_mode1_reuse", YkV.device, code,
               YkV.data_ptr(), Wb.data_ptr(), partials.data_ptr(), out.data_ptr(),
               K, R, n)
    return out
