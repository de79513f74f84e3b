"""Fused ALS stages on the CC format: four hand-written CUDA kernels.

The counterpart of ``repro.kernels.fused``. Each subject's kept-column slab
``vals[k]`` [I_pad, C_pad] is the only large operand; every product that
touches it in one stage is computed in one pass, and only the small results
([I,R] / [R,R] / [C,R]) reach device memory. Y_k is never materialised.
Four launches per bucket per ALS iteration is the floor, because the
eigendecomposition in ``solve_q`` and the H and V solves are global
synchronisation points:

  F1 ``fused_procrustes_b``  X_k V + B formation      (slab pass 1)
       --- eigh (solve_q) ---
  F2 ``fused_mode1_xkv``     Q^T XkV reduced to M1     ([I,R] operands)
       --- H solve ---
  F3 ``fused_mode2_compact`` projection + mode-2       (slab pass 2)
       --- V solve ---
  F4 ``fused_ykv``           projection + Y_k V        (slab pass 3)

Each wrapper takes its kernel's plain torch version only for tensors on the
CPU (the tests); for a CUDA tensor it launches the kernel from
``repro_torch/csrc/fused.cu`` or raises, and adds one to ``LAUNCHES[name]``
where it launches. Kernels accumulate per ``accum_dtype`` and take float32
and float64 at any R, I and C (operands too large for a block's shared
memory are staged in chunks). At half precision F1 and F4 take the slab
and Vg in one half dtype (bfloat16 or float16), F3 a half slab, every
other operand float32; they read the half values at 2 bytes, sum in
float32 and return float32, as the reference's kernels do; F2 reads no
slab and takes float32/float64. The plain versions widen the half
operands with ``accum_dtype`` and compute in float32, the same function.
F1, F3 and F4 stream the slab through cp.async rings; F1 and F4 on a half
slab (R <= 8) form X_k Vg_k on the tensor cores. Each launcher picks a variant
by shape and type; ``procrustes_b_variant``, ``mode1_xkv_variant``,
``mode2_compact_fused_variant`` and ``ykv_fused_variant`` report it for
CUDA operands. The kernel library is built at first use.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._launch import I as _I, P as _P
from repro_torch.kernels._launch import (KernelLib, Workspaces, check_shapes, dtype_code,
                                        dtype_codes, mask_operand, on_cpu)
from repro_torch.kernels.common import accum_dtype, fold_subject_mask

__all__ = [
    "LAUNCHES",
    "KERNELS",
    "LIB",
    "fused_procrustes_b",
    "fused_mode1_xkv",
    "fused_mode2_compact",
    "fused_ykv",
    "procrustes_b_plain",
    "mode1_xkv_plain",
    "mode2_compact_plain",
    "ykv_plain",
    "procrustes_b_variant",
    "mode1_xkv_variant",
    "mode2_compact_fused_variant",
    "ykv_fused_variant",
    "F1_VARIANTS",
    "F2_VARIANTS",
    "F3_VARIANTS",
    "F4_VARIANTS",
    "WORKSPACES",
    "reset_launches",
]

KERNELS = ("fused_procrustes_b", "fused_mode1_xkv", "fused_mode2_compact",
           "fused_ykv")
LIB = KernelLib("fused", KERNELS, {
    "spartan_fused_procrustes_b": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "spartan_fused_mode1_xkv_one_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "spartan_fused_mode2_compact": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "spartan_fused_ykv": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "spartan_fused_mode1_workspace": [_I, _I, _I],
    "spartan_fused_procrustes_b_variant": [_I, _I, _I, _I, _I],
    "spartan_fused_mode1_xkv_variant": [_I, _I, _I, _I],
    "spartan_fused_mode2_compact_variant": [_I, _I, _I, _I, _I],
    "spartan_fused_ykv_variant": [_I, _I, _I, _I, _I],
})
# the codes of spartan_fused_procrustes_b_variant, ..._mode1_xkv_variant,
# ..._mode2_compact_variant and ..._ykv_variant
F1_VARIANTS = ("ring", "ring-element-copies", "row-warp", "row-warp-chunked",
               "row-warp-wide", "row-warp-wide-chunked", "ring-mma", "ring-mma-element-copies")
F2_VARIANTS = ("ring", "ring-element-copies", "chunked")
F3_VARIANTS = ("ring", "ring-element-copies", "thread-per-column", "thread-per-column-chunked",
               "thread-per-column-wide", "thread-per-column-wide-chunked")
F4_VARIANTS = F1_VARIANTS
# F2's workspace (partials and ticket counter), per device, stream, dtype and R
WORKSPACES = Workspaces(LIB, "spartan_fused_mode1_workspace")
# kernel launches per wrapper; plain-version calls on the CPU are not counted
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches


# ---------------------------------------------------------------------------
# plain versions: the same function in torch (CPU tests; the check on the card)
# ---------------------------------------------------------------------------

def procrustes_b_plain(vals, Vg, Wb, H) -> Tuple[torch.Tensor, torch.Tensor]:
    acc = accum_dtype(vals)
    XkV = torch.bmm(vals.to(acc), Vg.to(acc))
    B = torch.matmul(XkV * Wb.to(acc)[:, None, :], H.to(acc).T)
    return XkV, B


def mode1_xkv_plain(Q, XkV, Wb, subject_mask=None) -> torch.Tensor:
    acc = accum_dtype(Q)
    Wb = fold_subject_mask(Wb, subject_mask)
    YkV = torch.bmm(Q.to(acc).transpose(1, 2), XkV.to(acc))
    return (YkV * Wb.to(acc)[:, None, :]).sum(dim=0)


def mode2_compact_plain(vals, Q, H, Wb, col_mask) -> torch.Tensor:
    acc = accum_dtype(vals)
    ycT = torch.bmm(vals.to(acc).transpose(1, 2), Q.to(acc))        # [K, C, R]
    A = torch.matmul(ycT, H.to(acc))
    return A * Wb.to(acc)[:, None, :] * col_mask.to(acc)[:, :, None]


def ykv_plain(vals, Q, Vg) -> torch.Tensor:
    acc = accum_dtype(vals)
    XkV = torch.bmm(vals.to(acc), Vg.to(acc))
    return torch.bmm(Q.to(acc).transpose(1, 2), XkV)


# ---------------------------------------------------------------------------
# the four stages
# ---------------------------------------------------------------------------

def fused_procrustes_b(vals, Vg, Wb, H) -> Tuple[torch.Tensor, torch.Tensor]:
    """vals [K,I,C], Vg [K,C,R], Wb [K,R], H [R,R] -> (XkV [K,I,R],
    B [K,I,R]) with B_k = (X_k V * w_k) H^T."""
    K, I, C = vals.shape
    R = Vg.shape[-1]
    check_shapes(Vg=(Vg, (K, C, R)), Wb=(Wb, (K, R)), H=(H, (R, R)))
    if K == 0:
        z = vals.new_zeros((0, I, R), dtype=accum_dtype(vals))
        return z, z.clone()
    if on_cpu(vals, Vg, Wb, H):
        return procrustes_b_plain(vals, Vg, Wb, H)
    code = dtype_codes((vals, Vg), Wb, H)
    XkV = torch.empty((K, I, R), dtype=accum_dtype(vals), device=vals.device)
    B = torch.empty_like(XkV)
    LIB.launch("fused_procrustes_b", "spartan_fused_procrustes_b", vals.device,
                code, vals.data_ptr(), Vg.data_ptr(), Wb.data_ptr(), H.data_ptr(),
                XkV.data_ptr(), B.data_ptr(), K, I, C, R)
    return XkV, B


def _slab_variant(fn: str, table: tuple, label: str, vals: torch.Tensor, R: int) -> str:
    """The variant ``fn`` (a C variant query) reports for a CUDA slab
    ``vals`` [K,I,C] at rank R; raises for a slab off the card."""
    K, I, C = vals.shape
    dtype = dtype_codes((vals,))       # raises for a tensor off the card
    code = getattr(LIB.lib(), fn)(dtype, I, C, R, int(vals.data_ptr() % 16 == 0))
    if code < 0:
        raise ValueError(f"no {label} variant for I={I}, C={C}, R={R}")
    return table[code]


def procrustes_b_variant(vals: torch.Tensor, R: int) -> str:
    """Which variant of F1's kernel :func:`fused_procrustes_b` launches for a
    CUDA slab ``vals`` [K,I,C] (with Vg of its dtype) at rank R:
    ``ring-mma`` (a half slab at R <= 8: X_k Vg_k on the tensor cores) or
    ``ring`` (FMA: float32/float64, the main path's, and a half slab past
    R = 8), each ``...-element-copies`` for a slab whose rows are not whole
    16-byte runs, or ``row-warp*`` for R > 64 or a subject too large for
    the rings."""
    return _slab_variant("spartan_fused_procrustes_b_variant", F1_VARIANTS, "F1", vals, R)


def fused_mode1_xkv(Q, XkV, Wb, subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q [K,I,R], XkV [K,I,R], Wb [K,R] -> partial M1 [R,R] = sum_k
    (Q_k^T X_k V) * w_k, the mode-1 reuse identity Y_k V = Q_k^T (X_k V)
    reduced in the same launch. ``subject_mask`` [K] scales W(k,:) (in the
    kernel, the product torch forms when it folds the mask into Wb). A
    repeated call allocates only its [R,R] result."""
    K, I, R = Q.shape
    check_shapes(XkV=(XkV, (K, I, R)), Wb=(Wb, (K, R)))
    if K == 0:
        return Q.new_zeros((R, R), dtype=accum_dtype(Q))
    mask = mask_operand(subject_mask, Wb)
    if on_cpu(Q, XkV, Wb, *mask):
        return mode1_xkv_plain(Q, XkV, Wb, subject_mask)
    code = dtype_code(Q, XkV, Wb, *mask)
    out = torch.empty((R, R), dtype=Q.dtype, device=Q.device)
    WORKSPACES.launch("fused_mode1_xkv", "spartan_fused_mode1_xkv_one_launch", Q, code, K, R,
                      (Q.data_ptr(), XkV.data_ptr(), Wb.data_ptr(),
                       mask[0].data_ptr() if mask else None),
                      (out.data_ptr(), K, I, R))
    return out


def mode1_xkv_variant(Q: torch.Tensor, XkV: torch.Tensor) -> str:
    """Which variant of F2's kernel :func:`fused_mode1_xkv` launches for CUDA
    operands Q, XkV [K,I,R]: ``ring`` (the main path's), ``ring-element-copies``
    where a subject's [I,R] tile is not whole 16-byte runs or an operand does
    not start on a 16-byte boundary, or ``chunked`` for R*R > 128 or a
    subject too large for the ring."""
    K, I, R = Q.shape
    dtype = dtype_code(Q, XkV)         # raises for a tensor off the card
    aligned = Q.data_ptr() % 16 == 0 and XkV.data_ptr() % 16 == 0
    code = LIB.lib().spartan_fused_mode1_xkv_variant(dtype, I, R, int(aligned))
    if code < 0:
        raise ValueError(f"no F2 variant for I={I}, R={R}")
    return F2_VARIANTS[code]


def fused_mode2_compact(vals, Q, H, Wb, col_mask) -> torch.Tensor:
    """vals [K,I,C], Q [K,I,R], H [R,R], Wb [K,R] (mask folded in),
    col_mask [K,C] -> A [K,C,R] = (Y_k^T H) * W(k,:) * col_mask, with
    Y_k = Q_k^T X_k formed column by column and never stored."""
    K, I, C = vals.shape
    R = Q.shape[-1]
    check_shapes(Q=(Q, (K, I, R)), H=(H, (R, R)), Wb=(Wb, (K, R)),
                 col_mask=(col_mask, (K, C)))
    if K == 0:
        return vals.new_zeros((0, C, R), dtype=accum_dtype(vals))
    if on_cpu(vals, Q, H, Wb, col_mask):
        return mode2_compact_plain(vals, Q, H, Wb, col_mask)
    code = dtype_codes((vals,), Q, H, Wb, col_mask)
    out = torch.empty((K, C, R), dtype=accum_dtype(vals), device=vals.device)
    LIB.launch("fused_mode2_compact", "spartan_fused_mode2_compact", vals.device,
                code, vals.data_ptr(), Q.data_ptr(), H.data_ptr(), Wb.data_ptr(),
                col_mask.data_ptr(), out.data_ptr(), K, I, C, R)
    return out


def mode2_compact_fused_variant(vals: torch.Tensor, R: int) -> str:
    """Which variant of F3's kernel :func:`fused_mode2_compact` launches for
    a CUDA slab ``vals`` [K,I,C] (float32, float64 or half) at rank R:
    ``ring`` (the main path's), ``ring-element-copies`` for a slab whose
    rows are not whole 16-byte runs, or ``thread-per-column*`` for R > 64,
    a subject too large for the ring or one of fewer than 32 rows."""
    return _slab_variant("spartan_fused_mode2_compact_variant", F3_VARIANTS, "F3", vals, R)


def ykv_fused_variant(vals: torch.Tensor, R: int) -> str:
    """Which variant of F4's kernel :func:`fused_ykv` launches for a CUDA
    slab ``vals`` [K,I,C] (with Vg of its dtype) at rank R: ``ring-mma``
    (a half slab at R <= 8: X_k Vg_k on the tensor cores) or ``ring`` (FMA,
    float32/float64, and a half slab past R = 8; at least 32 rows a
    subject), each ``...-element-copies`` for a slab whose rows are not
    whole 16-byte runs, else ``row-warp*``."""
    return _slab_variant("spartan_fused_ykv_variant", F4_VARIANTS, "F4", vals, R)


def fused_ykv(vals, Q, Vg) -> torch.Tensor:
    """vals [K,I,C], Q [K,I,R], Vg [K,C,R] -> G [K,R,R] = Q_k^T X_k V, the
    shared mode-3 / fit product."""
    K, I, C = vals.shape
    R = Q.shape[-1]
    check_shapes(Q=(Q, (K, I, R)), Vg=(Vg, (K, C, R)))
    if K == 0:
        return vals.new_zeros((0, R, R), dtype=accum_dtype(vals))
    if on_cpu(vals, Q, Vg):
        return ykv_plain(vals, Q, Vg)
    code = dtype_codes((vals, Vg), Q)
    out = torch.empty((K, R, R), dtype=accum_dtype(vals), device=vals.device)
    LIB.launch("fused_ykv", "spartan_fused_ykv", vals.device,
                code, vals.data_ptr(), Q.data_ptr(), Vg.data_ptr(), out.data_ptr(),
                K, I, C, R)
    return out
