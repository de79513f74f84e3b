"""SPARTan mode-2 MTTKRP, compact compute stage (``repro.kernels.
mttkrp_mode2``), a CUDA kernel.

``A[k] = (Y_k^T H) * W(k,:)`` [K, C, R] for the kept columns only; the
J-space scatter is :func:`repro_torch.core.spartan.mode2_scatter`.
``col_mask`` [K,C] zeroes padded columns and ``subject_mask`` [K] (folded
into W(k,:)) padded subjects, exactly: the sorted-segment scatter relies on
those zeros. On CUDA tensors :func:`mode2_compact` launches
``spartan_mode2_compact`` of ``csrc/staged.cu`` (or raises), whose variant
:func:`mode2_compact_variant` names; on the CPU it runs
:func:`mode2_compact_plain`. At half precision Yc may be bfloat16 or
float16 (H, Wb and the masks float32); the kernel reads it at 2 bytes and
returns A in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import RING_VARIANTS, check_shapes, dtype_codes, on_cpu
from repro_torch.kernels.common import accum_dtype, fold_subject_mask
from repro_torch.kernels.staged import LIB

__all__ = ["mode2_compact", "mode2_compact_plain", "mode2_compact_variant"]


def mode2_compact_plain(Yc, H, Wb, col_mask=None, subject_mask=None) -> torch.Tensor:
    A = ref.mode2_compact_ref(Yc, H, fold_subject_mask(Wb, subject_mask))
    return A if col_mask is None else A * col_mask[..., None].to(A.dtype)


def _mask_operand(Yc: torch.Tensor, col_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """col_mask as the kernel reads it: the accumulation dtype of Yc, ones
    when absent."""
    K, _, C = Yc.shape
    if col_mask is None:
        return torch.ones((K, C), dtype=accum_dtype(Yc), device=Yc.device)
    return col_mask.to(accum_dtype(Yc))


def mode2_compact(Yc: torch.Tensor, H: torch.Tensor, Wb: torch.Tensor,
                  col_mask: Optional[torch.Tensor] = None,
                  subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Yc [K,R,C], H [R,R], Wb [K,R] -> A [K,C,R]; rows of masked columns
    and subjects are 0."""
    K, R, C = Yc.shape
    check_shapes(H=(H, (R, R)), Wb=(Wb, (K, R)))
    if col_mask is not None:
        check_shapes(col_mask=(col_mask, (K, C)))
    if K == 0 or C == 0:
        return Yc.new_zeros((K, C, R), dtype=accum_dtype(Yc))
    if on_cpu(Yc, H, Wb):
        return mode2_compact_plain(Yc, H, Wb, col_mask, subject_mask)
    Wb = fold_subject_mask(Wb, subject_mask)
    cm = _mask_operand(Yc, col_mask)
    code = dtype_codes((Yc,), H, Wb, cm)
    out = torch.empty((K, C, R), dtype=accum_dtype(Yc), device=Yc.device)
    LIB.launch("mode2_compact", "spartan_mode2_compact", Yc.device, code,
               Yc.data_ptr(), H.data_ptr(), Wb.data_ptr(), cm.data_ptr(),
               out.data_ptr(), K, R, C)
    return out


def mode2_compact_variant(Yc: torch.Tensor, col_mask: Optional[torch.Tensor] = None) -> str:
    """Which variant of row 8's kernel :func:`mode2_compact` launches for a
    CUDA Yc [K,R,C] and its col_mask: ``ring`` (the main path's),
    ``ring-element-copies`` for rows of Yc that are not whole 16-byte runs
    or operands that do not start on a 16-byte boundary, or
    ``thread-per-entry`` for an R too wide for the ring's tile."""
    K, R, C = Yc.shape
    dtype = dtype_codes((Yc,))            # raises for a tensor off the card
    cm = _mask_operand(Yc, col_mask)
    aligned = Yc.data_ptr() % 16 == 0 and cm.data_ptr() % 16 == 0
    code = LIB.lib().spartan_mode2_compact_variant(dtype, C, R, int(aligned))
    if code < 0:
        raise ValueError(f"no mode2_compact variant for C={C}, R={R}")
    return RING_VARIANTS[code]
