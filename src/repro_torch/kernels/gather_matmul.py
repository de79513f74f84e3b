"""BCC gather-matmul X_k V (``repro.kernels.gather_matmul``), a CUDA kernel.

The block-compressed-columns layout (:class:`repro_torch.core.irregular.
BlockBucket`) quantizes each subject's kept columns to 128-wide blocks of J:

  vals    [K, I, NB, L]  dense values per kept column block (L = 128)
  blk_ids i32[K, NB]     global block index into V (pad: 0, zero values)
  V       [J_pad, R]     factor matrix, J_pad % L == 0
  out     [K, I, R]      X_k V

On CUDA tensors :func:`gather_matmul` launches ``spartan_gather_matmul`` of
``csrc/gather_matmul.cu`` (or raises) and counts it in ``LAUNCHES``; on the
CPU it runs :func:`gather_matmul_plain` (``ref.gather_matmul_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import I as _I, P as _P
from repro_torch.kernels._launch import (KernelLib, check_index, check_shapes,
                                         dtype_code, on_cpu)
from repro_torch.kernels.common import accum_dtype

__all__ = ["KERNELS", "LAUNCHES", "LIB", "reset_launches", "gather_matmul",
           "gather_matmul_plain"]

KERNELS = ("gather_matmul",)
LIB = KernelLib("gather_matmul", KERNELS, {
    "spartan_gather_matmul": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
})
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches

gather_matmul_plain = ref.gather_matmul_ref


def gather_matmul(vals: torch.Tensor, blk_ids: torch.Tensor,
                  V: torch.Tensor) -> torch.Tensor:
    """vals [K,I,NB,L], blk_ids i32 [K,NB], V [J_pad,R] -> [K,I,R]
    (accum_dtype accumulation)."""
    K, I, NB, L = vals.shape
    J_pad, R = V.shape
    if J_pad % L:
        raise ValueError(f"V rows ({J_pad}) must be a multiple of the block width {L}")
    check_shapes(blk_ids=(blk_ids, (K, NB)))
    if K == 0 or I == 0 or NB == 0 or R == 0:
        return vals.new_zeros((K, I, R), dtype=accum_dtype(vals))
    if on_cpu(vals, blk_ids, V):
        return gather_matmul_plain(vals, blk_ids, V)
    code = dtype_code(vals, V)
    check_index(blk_ids=blk_ids)
    out = torch.empty((K, I, R), dtype=vals.dtype, device=vals.device)
    LIB.launch("gather_matmul", "spartan_gather_matmul", vals.device, code,
               vals.data_ptr(), blk_ids.data_ptr(), V.data_ptr(), out.data_ptr(),
               K, I, NB, L, R)
    return out
