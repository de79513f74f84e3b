"""SPARTan mode-3 MTTKRP (``repro.kernels.mttkrp_mode3``), CUDA kernels.

``M3(k,:) = coldot(H, Y_k V)``: ``out[k, l] = sum_r H[r, l] (Y_k V)[r, l]``
[K, R], one row per subject, in two forms mirroring mode 1: :func:`mode3`
forms Y_k V from Yc and the gathered V rows, :func:`mode3_reuse` takes it
cached. ``subject_mask`` zeroes the rows of padded subjects. On CUDA
tensors each launches its kernel of ``csrc/staged.cu`` (or raises); on the
CPU it runs its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import check_shapes, dtype_code, on_cpu
from repro_torch.kernels.common import accum_dtype
from repro_torch.kernels.staged import LIB

__all__ = ["mode3", "mode3_reuse", "mode3_plain", "mode3_reuse_plain"]


def _mask_rows(out: torch.Tensor, subject_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return out if subject_mask is None else out * subject_mask[:, None].to(out.dtype)


def mode3_plain(Yc, Vg, H, subject_mask=None) -> torch.Tensor:
    return _mask_rows(ref.mode3_ref(Yc, Vg, H), subject_mask)


def mode3_reuse_plain(YkV, H, subject_mask=None) -> torch.Tensor:
    return _mask_rows(ref.mode3_reuse_ref(YkV, H), subject_mask)


def _mask_ptr(subject_mask: Optional[torch.Tensor], like: torch.Tensor):
    """The mask in the operands' dtype (kept alive by the caller) and its
    pointer, or (None, None) for no mask."""
    if subject_mask is None:
        return None, None
    m = subject_mask.to(like.dtype)
    dtype_code(like, m)
    return m, m.data_ptr()


def mode3(Yc: torch.Tensor, Vg: torch.Tensor, H: torch.Tensor,
          subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Yc [K,R,C], Vg [K,C,R], H [R,R] -> [K,R]."""
    K, R, C = Yc.shape
    check_shapes(Vg=(Vg, (K, C, R)), H=(H, (R, R)))
    if subject_mask is not None:
        check_shapes(subject_mask=(subject_mask, (K,)))
    if K == 0 or C == 0:
        return Yc.new_zeros((K, R), dtype=accum_dtype(Yc))
    if on_cpu(Yc, Vg, H):
        return mode3_plain(Yc, Vg, H, subject_mask)
    code = dtype_code(Yc, Vg, H)
    mask, mask_ptr = _mask_ptr(subject_mask, Yc)
    out = torch.empty((K, R), dtype=Yc.dtype, device=Yc.device)
    LIB.launch("mode3", "spartan_mode3", Yc.device, code, Yc.data_ptr(),
               Vg.data_ptr(), H.data_ptr(), mask_ptr, out.data_ptr(), K, R, C)
    return out


def mode3_reuse(YkV: torch.Tensor, H: torch.Tensor,
                subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """YkV [K,R,R] (= Y_k V, cached), H [R,R] -> [K,R]: the coldot only."""
    K, R, _ = YkV.shape
    check_shapes(YkV=(YkV, (K, R, R)), H=(H, (R, R)))
    if subject_mask is not None:
        check_shapes(subject_mask=(subject_mask, (K,)))
    if K == 0:
        return YkV.new_zeros((K, R), dtype=accum_dtype(YkV))
    if on_cpu(YkV, H):
        return mode3_reuse_plain(YkV, H, subject_mask)
    code = dtype_code(YkV, H)
    mask, mask_ptr = _mask_ptr(subject_mask, YkV)
    out = torch.empty((K, R), dtype=YkV.dtype, device=YkV.device)
    LIB.launch("mode3_reuse", "spartan_mode3_reuse", YkV.device, code,
               YkV.data_ptr(), H.data_ptr(), mask_ptr, out.data_ptr(), K, R)
    return out
