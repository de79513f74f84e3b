"""The shared Y_k V product (``repro.kernels.ykv``), a CUDA kernel.

``YkV[k] = Yc_k Vg_k`` [K, R, R] from the compressed slices and the gathered
V rows: the product that the mode-1 and mode-3 reuse paths and the fit
share. On CUDA tensors :func:`ykv` launches ``spartan_ykv`` of
``csrc/staged.cu`` (or raises), whose variant :func:`ykv_variant` names; on
the CPU it runs :func:`ykv_plain`. At half precision Yc and Vg are each
float32 or one half dtype (bfloat16, float16); the kernel reads the half
values at 2 bytes and returns YkV in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import RING_VARIANTS, check_shapes, dtype_codes, on_cpu
from repro_torch.kernels.common import accum_dtype
from repro_torch.kernels.staged import LIB

__all__ = ["ykv", "ykv_plain", "ykv_variant"]

ykv_plain = ref.ykv_ref


def ykv(Yc: torch.Tensor, Vg: torch.Tensor) -> torch.Tensor:
    """Yc [K,R,C], Vg [K,C,R] -> YkV [K,R,R] (accum_dtype accumulation)."""
    K, R, C = Yc.shape
    check_shapes(Vg=(Vg, (K, C, R)))
    if K == 0 or C == 0:
        return Yc.new_zeros((K, R, R), dtype=accum_dtype(Yc))
    if on_cpu(Yc, Vg):
        return ykv_plain(Yc, Vg)
    code = dtype_codes((Yc, Vg), paired=False)
    out = torch.empty((K, R, R), dtype=accum_dtype(Yc), device=Yc.device)
    LIB.launch("ykv", "spartan_ykv", Yc.device, code, Yc.data_ptr(),
               Vg.data_ptr(), out.data_ptr(), K, R, C)
    return out


def ykv_variant(Yc: torch.Tensor, Vg: torch.Tensor) -> str:
    """Which variant of row 5's kernel :func:`ykv` launches for a CUDA Yc
    [K,R,C] and Vg [K,C,R]: ``ring`` (the main path's),
    ``ring-element-copies`` for rows of Yc that are not whole 16-byte runs
    or operands that do not start on a 16-byte boundary, or
    ``thread-per-entry`` for a subject too large for the ring's two
    shared-memory stages."""
    K, R, C = Yc.shape
    dtype = dtype_codes((Yc, Vg), paired=False)   # raises for a tensor off the card
    aligned = Yc.data_ptr() % 16 == 0 and Vg.data_ptr() % 16 == 0
    code = LIB.lib().spartan_ykv_variant(dtype, C, R, int(aligned))
    if code < 0:
        raise ValueError(f"no ykv variant for C={C}, R={R}")
    return RING_VARIANTS[code]
