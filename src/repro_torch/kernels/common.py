"""Accumulation policy shared by the kernels and their plain versions."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["accum_dtype", "fold_subject_mask"]


def accum_dtype(x: Union[torch.Tensor, torch.dtype]) -> torch.dtype:
    """Accumulation dtype for a contraction over ``x``: f64 in -> f64,
    bf16/f16 in -> f32 (half-precision partial sums lose mass over the
    subject and column axes), f32 and non-floats pass through. Accepts a
    tensor or a dtype; the same policy as ``repro.kernels.common``."""
    dt = x.dtype if isinstance(x, torch.Tensor) else x
    if not dt.is_floating_point:
        return dt
    if torch.finfo(dt).bits < 32:
        return torch.float32
    return dt


def fold_subject_mask(Wb: torch.Tensor,
                      subject_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold ``subject_mask`` [K] into the W rows [K, R]: every mode scales a
    subject's whole contribution by W(k,:), so masking W masks the subject
    exactly."""
    if subject_mask is None:
        return Wb
    return Wb * subject_mask[:, None].to(Wb.dtype)
