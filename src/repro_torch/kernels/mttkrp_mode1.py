"""SPARTan mode-1 MTTKRP (``repro.kernels.mttkrp_mode1``), CUDA kernels.

``M1 = sum_k (Y_k V) * W(k,:)`` [R, R], a reduction across the subjects of
a bucket, in two forms:

* :func:`mode1` forms Y_k V from Yc and the gathered V rows;
* :func:`mode1_reuse` takes Y_k V cached ([K, R, R], the ``mode1_reuse``
  path: Y_k V = Q_k^T (X_k V) from the Procrustes step).

``subject_mask`` masks a subject's whole contribution through W(k,:). On
CUDA tensors each launches its kernel of ``csrc/staged.cu`` once (two
levels in one launch, deterministic: two runs give the same bits; the
kernel multiplies W(k,:) by the mask itself, as torch folds it) on a
workspace kept per device, stream, accumulation dtype and R, or raises;
on the CPU it runs its plain version. A repeated call allocates only its
[R, R] result. At half precision :func:`mode1` takes Yc and Vg each in
float32 or one half dtype (Wb and the mask float32) and returns float32;
:func:`mode1_reuse` takes float32/float64 YkV.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import (Workspaces, check_shapes, dtype_code,
                                        dtype_codes, mask_operand, on_cpu)
from repro_torch.kernels.common import accum_dtype, fold_subject_mask
from repro_torch.kernels.staged import LIB

__all__ = ["mode1", "mode1_reuse", "mode1_plain", "mode1_reuse_plain", "WORKSPACES"]

WORKSPACES = Workspaces(LIB, "spartan_mode1_workspace")


def mode1_plain(Yc, Vg, Wb, subject_mask=None) -> torch.Tensor:
    return ref.mode1_ref(Yc, Vg, fold_subject_mask(Wb, subject_mask))


def mode1_reuse_plain(YkV, Wb, subject_mask=None) -> torch.Tensor:
    return ref.mode1_reuse_ref(YkV, fold_subject_mask(Wb, subject_mask))


def _launch(name: str, fn: str, inputs: tuple, Wb: torch.Tensor, mask: tuple,
            dims: tuple) -> torch.Tensor:
    """One launch of row 6 (``inputs`` Yc, Vg) or 7 (YkV) with Wb and
    ``mask`` (() for none: a null pointer)."""
    K, R = Wb.shape
    code = (dtype_codes(inputs, Wb, *mask, paired=False) if len(inputs) == 2
            else dtype_code(*inputs, Wb, *mask))
    out = torch.empty((R, R), dtype=Wb.dtype, device=Wb.device)
    WORKSPACES.launch(name, fn, Wb, code, K, R,
                      (*(t.data_ptr() for t in inputs), Wb.data_ptr(),
                       mask[0].data_ptr() if mask else None),
                      (out.data_ptr(), K, R, *dims))
    return out


def mode1(Yc: torch.Tensor, Vg: torch.Tensor, Wb: torch.Tensor,
          subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Yc [K,R,C], Vg [K,C,R], Wb [K,R] -> [R,R]. ``subject_mask`` [K]
    (1.0 = real subject) scales W(k,:)."""
    K, R, C = Yc.shape
    check_shapes(Vg=(Vg, (K, C, R)), Wb=(Wb, (K, R)))
    if K == 0 or C == 0:
        return Yc.new_zeros((R, R), dtype=accum_dtype(Yc))
    mask = mask_operand(subject_mask, Wb)
    if on_cpu(Yc, Vg, Wb, *mask):
        return mode1_plain(Yc, Vg, Wb, subject_mask)
    return _launch("mode1", "spartan_mode1_one_launch", (Yc, Vg), Wb, mask, (C,))


def mode1_reuse(YkV: torch.Tensor, Wb: torch.Tensor,
                subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """YkV [K,R,R] (= Y_k V, cached), Wb [K,R] -> [R,R]: the Hadamard with
    W(k,:) and the subject reduction only."""
    K, R, _ = YkV.shape
    check_shapes(YkV=(YkV, (K, R, R)), Wb=(Wb, (K, R)))
    if K == 0:
        return YkV.new_zeros((R, R), dtype=accum_dtype(YkV))
    mask = mask_operand(subject_mask, Wb)
    if on_cpu(YkV, Wb, *mask):
        return mode1_reuse_plain(YkV, Wb, subject_mask)
    return _launch("mode1_reuse", "spartan_mode1_reuse_one_launch", (YkV,), Wb, mask, ())
