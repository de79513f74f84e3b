"""Accumulation and compute-precision policy shared by the kernels and
their plain versions (``repro.kernels.common``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["accum_dtype", "compute_cast", "fold_subject_mask", "PRECISIONS",
           "PRECISION_DTYPES", "HALF_DTYPES"]

# compute-precision values (Parafac2Options.precision / --precision): "f32"
# streams the operands as they are; "bf16"/"f16" stage the streamed values
# half-width while every contraction still accumulates through accum_dtype
PRECISIONS = ("f32", "bf16", "f16")
PRECISION_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
HALF_DTYPES = tuple(PRECISION_DTYPES.values())


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


def compute_cast(x: Optional[torch.Tensor],
                 precision: Optional[str] = "f32") -> Optional[torch.Tensor]:
    """Stage a streamed operand at the compute precision: ``"f32"`` (or
    None) passes it through unchanged whatever its dtype, f64 included;
    ``"bf16"``/``"f16"`` cast a floating tensor half-width (pair with
    ``accum_dtype`` so that the products still accumulate in f32). None and
    non-floating tensors pass through; an unknown precision raises."""
    if x is None or precision == "f32" or precision is None:
        return x
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown compute precision {precision!r}; choose from {PRECISIONS}")
    if x.dtype.is_floating_point:
        return x.to(PRECISION_DTYPES[precision])
    return x


def fold_subject_mask(Wb: torch.Tensor,
                      subject_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold ``subject_mask`` [K] into the W rows [K, R]: every mode scales a
    subject's whole contribution by W(k,:), so masking W masks the subject
    exactly."""
    if subject_mask is None:
        return Wb
    return Wb * subject_mask[:, None].to(Wb.dtype)
