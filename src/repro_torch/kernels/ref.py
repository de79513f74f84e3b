"""Plain torch oracles for the staged kernels (``repro.kernels.ref``).

Each function mirrors one reference kernel's interface. They are the plain
versions of the staged kernels (``ykv.py``, ``mttkrp_mode{1,2,3}.py``: the
CPU route, and what the CUDA kernels are held against); ``gather_matmul_ref``
is the plain version of the BCC kernel (``gather_matmul.py``).
Accumulation follows :func:`repro_torch.kernels.common.accum_dtype`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import accum_dtype

__all__ = [
    "ykv_ref",
    "mode1_ref",
    "mode1_reuse_ref",
    "mode2_compact_ref",
    "mode3_ref",
    "mode3_reuse_ref",
    "gather_matmul_ref",
]


def ykv_ref(Yc: torch.Tensor, Vg: torch.Tensor) -> torch.Tensor:
    """YkV[k] = Y_k V  ->  [K, R, R]. Yc [K, R, C]; Vg [K, C, R]."""
    acc = accum_dtype(Yc)
    return torch.bmm(Yc.to(acc), Vg.to(acc))


def mode1_ref(Yc: torch.Tensor, Vg: torch.Tensor, Wb: torch.Tensor) -> torch.Tensor:
    """sum_k (Y_k V) * W(k,:)  ->  [R, R]; padded subjects arrive zeroed."""
    return mode1_reuse_ref(ykv_ref(Yc, Vg), Wb)


def mode1_reuse_ref(YkV: torch.Tensor, Wb: torch.Tensor) -> torch.Tensor:
    """sum_k YkV_k * W(k,:) with YkV [K, R, R] precomputed -> [R, R]."""
    acc = accum_dtype(YkV)
    return torch.einsum("krl,kl->rl", YkV.to(acc), Wb.to(acc))


def mode2_compact_ref(Yc: torch.Tensor, H: torch.Tensor, Wb: torch.Tensor) -> torch.Tensor:
    """A[k] = (Y_k^T H) * W(k,:)  ->  [K, C, R]."""
    acc = accum_dtype(Yc)
    A = torch.matmul(Yc.to(acc).transpose(1, 2), H.to(acc))
    return A * Wb[:, None, :].to(acc)


def mode3_ref(Yc: torch.Tensor, Vg: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """M3 rows: out[k,:] = coldot(H, Y_k V)  ->  [K, R]."""
    return mode3_reuse_ref(ykv_ref(Yc, Vg), H)


def mode3_reuse_ref(YkV: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """out[k,:] = coldot(H, YkV_k) with YkV [K, R, R] precomputed -> [K, R]."""
    acc = accum_dtype(YkV)
    return torch.einsum("rl,krl->kl", H.to(acc), YkV.to(acc))


def gather_matmul_ref(vals: torch.Tensor, blk_ids: torch.Tensor,
                      V: torch.Tensor) -> torch.Tensor:
    """BCC X_k V: vals [K, I, NB, L], blk_ids [K, NB], V [J_pad, R] with
    J_pad % L == 0; padded blocks are zero-valued. Returns [K, I, R]."""
    L = vals.shape[-1]
    acc = accum_dtype(vals)
    Vg = V.reshape(-1, L, V.shape[1])[blk_ids.long()]        # [K, NB, L, R]
    return torch.einsum("kinl,knlr->kir", vals.to(acc), Vg.to(acc))
