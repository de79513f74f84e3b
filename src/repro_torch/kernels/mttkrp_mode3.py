"""SPARTan mode-3 MTTKRP (``repro.kernels.mttkrp_mode3``), CUDA kernels.

``M3(k,:) = coldot(H, Y_k V)``: ``out[k, l] = sum_r H[r, l] (Y_k V)[r, l]``
[K, R], one row per subject, in two forms mirroring mode 1: :func:`mode3`
forms Y_k V from Yc and the gathered V rows, :func:`mode3_reuse` takes it
cached. ``subject_mask`` zeroes the rows of padded subjects. On CUDA
tensors each launches its kernel of ``csrc/staged.cu`` (or raises), row
9's in the variant :func:`mode3_variant` names; on the CPU it runs its
plain version. Both kernels sum in one order, so on the card ``mode3(Yc,
Vg, H, m)`` equals ``mode3_reuse(ykv(Yc, Vg), H, m)`` bit for bit. At half
precision :func:`mode3` takes Yc and Vg each in float32 or one half dtype
(H and the mask float32) and returns float32; :func:`mode3_reuse` takes
float32/float64 YkV.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import (RING_VARIANTS, check_shapes, dtype_code,
                                        dtype_codes, mask_operand, on_cpu)
from repro_torch.kernels.common import accum_dtype
from repro_torch.kernels.staged import LIB

__all__ = ["mode3", "mode3_reuse", "mode3_plain", "mode3_reuse_plain", "mode3_variant"]


def _mask_rows(out: torch.Tensor, subject_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return out if subject_mask is None else out * subject_mask[:, None].to(out.dtype)


def mode3_plain(Yc, Vg, H, subject_mask=None) -> torch.Tensor:
    return _mask_rows(ref.mode3_ref(Yc, Vg, H), subject_mask)


def mode3_reuse_plain(YkV, H, subject_mask=None) -> torch.Tensor:
    return _mask_rows(ref.mode3_reuse_ref(YkV, H), subject_mask)


def mode3(Yc: torch.Tensor, Vg: torch.Tensor, H: torch.Tensor,
          subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Yc [K,R,C], Vg [K,C,R], H [R,R] -> [K,R]."""
    K, R, C = Yc.shape
    check_shapes(Vg=(Vg, (K, C, R)), H=(H, (R, R)))
    mask = mask_operand(subject_mask, Yc)
    if K == 0 or C == 0:
        return Yc.new_zeros((K, R), dtype=accum_dtype(Yc))
    if on_cpu(Yc, Vg, H, *mask):
        return mode3_plain(Yc, Vg, H, subject_mask)
    code = dtype_codes((Yc, Vg), H, *mask, paired=False)
    out = torch.empty((K, R), dtype=accum_dtype(Yc), device=Yc.device)
    LIB.launch("mode3", "spartan_mode3", Yc.device, code, Yc.data_ptr(), Vg.data_ptr(),
               H.data_ptr(), mask[0].data_ptr() if mask else None, out.data_ptr(), K, R, C)
    return out


def mode3_reuse(YkV: torch.Tensor, H: torch.Tensor,
                subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """YkV [K,R,R] (= Y_k V, cached), H [R,R] -> [K,R]: the coldot only."""
    K, R, _ = YkV.shape
    check_shapes(YkV=(YkV, (K, R, R)), H=(H, (R, R)))
    mask = mask_operand(subject_mask, YkV)
    if K == 0:
        return YkV.new_zeros((K, R), dtype=accum_dtype(YkV))
    if on_cpu(YkV, H, *mask):
        return mode3_reuse_plain(YkV, H, subject_mask)
    code = dtype_code(YkV, H, *mask)
    out = torch.empty((K, R), dtype=YkV.dtype, device=YkV.device)
    LIB.launch("mode3_reuse", "spartan_mode3_reuse", YkV.device, code, YkV.data_ptr(),
               H.data_ptr(), mask[0].data_ptr() if mask else None, out.data_ptr(), K, R)
    return out


def mode3_variant(Yc: torch.Tensor, Vg: torch.Tensor) -> str:
    """Which variant of row 9's kernel :func:`mode3` launches for a CUDA Yc
    [K,R,C] and Vg [K,C,R]: ``ring`` (row 5's ring with a coldot, the main
    path's), ``ring-element-copies`` for rows of Yc that are not whole
    16-byte runs or operands that do not start on a 16-byte boundary, or
    ``thread-per-entry`` for a subject too large for the ring's two
    shared-memory stages."""
    K, R, C = Yc.shape
    dtype = dtype_codes((Yc, Vg), paired=False)   # raises for a tensor off the card
    aligned = Yc.data_ptr() % 16 == 0 and Vg.data_ptr() % 16 == 0
    code = LIB.lib().spartan_mode3_variant(dtype, C, R, int(aligned))
    if code < 0:
        raise ValueError(f"no mode3 variant for C={C}, R={R}")
    return RING_VARIANTS[code]
