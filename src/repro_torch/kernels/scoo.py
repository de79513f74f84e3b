"""O(nnz) SCOO contractions (``repro.kernels.scoo``): the plain torch
segment sums and two CUDA kernels.

The SCOO format (:class:`repro_torch.core.irregular.SparseBucket`) stores
each subject's slice as sorted flat COO triplets padded to N_pad:

  vals  f[Kb, N]   nonzero values (pad entries 0)
  rows  i32[Kb, N] local row into the I_pad row space (pad: 0)
  lcols i32[Kb, N] local kept-column slot into the C_pad column space (pad: 0)

Every contraction is a gather plus a segment sum, O(nnz * R):

  xk_times_v   (X_k V)[i,:]   = sum_{n: rows[n]=i}  vals[n] * Vg[lcols[n], :]
  project      (Q^T X_k)[:,c] = sum_{n: lcols[n]=c} vals[n] * Q[rows[n], :]
  ykv          (Y_k V)[r,l]   = sum_n vals[n] * Q[rows[n], r] * Vg[lcols[n], l]
  mode2        A[c,:]         = sum_{n: lcols[n]=c} vals[n] * (Q H)[rows[n], :]

The plain versions follow the reference: with the segment ends computed at
``bucketize`` (``row_ends``; ``cperm``/``col_ends`` for the column-sorted
view) a segment sum is a running sum read at the ends and differenced, with
no scatter; without them a scatter-add (the order-independent oracle). The
running sum runs along the last axis of a [Kb, R, N] view, one short scan
per (subject, column) (a scan over the middle axis of [Kb, N, R] gets one
thread per column from torch's CUDA scan). ``torch.gather`` takes int64
indices, so each plain call casts the int32 index arrays it reads: 8 bytes
per triplet and index array read (rows, lcols, cperm) plus 8 per segment
end, allocated and dropped per call.

Two of them are CUDA kernels on a GPU (``csrc/scoo.cu``), the counterparts
of the reference's Pallas ``xk_times_v_pallas`` and ``project_pallas``:
:func:`scoo_xk_times_v` and :func:`scoo_project`. Each sums its segments
directly (one owner per output entry), so it needs the ends, and a CUDA
call without them raises; :func:`scoo_xk_times_v_variant` and
:func:`scoo_project_variant` name the variant a launch takes. On CPU
tensors they run the plain versions.
Accumulation follows ``accum_dtype``.

At half precision (bfloat16 or float16 ``vals``) the plain helpers follow
the reference's: :func:`xk_times_v` and :func:`project` round their f32
sums back to ``vals.dtype``, :func:`ykv_scoo` and
:func:`mode2_compact_scoo` widen with ``accum_dtype`` and return f32. The
two kernels, like the reference's Pallas kernels, return the f32 sums
(row 11 with vals and Vg half, row 12 with vals half and Q float32), and
so do their CPU paths; a caller that wants the reference's rounding (the
staged route) rounds after the call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._launch import I as _I, P as _P
from repro_torch.kernels._launch import (RING_VARIANTS, KernelLib, check_index,
                                         check_shapes, dtype_codes, on_cpu)
from repro_torch.kernels.common import accum_dtype

__all__ = [
    "KERNELS", "LAUNCHES", "LIB", "reset_launches",
    "segment_sum_sorted", "xk_times_v", "project", "xk_times_v_plain", "project_plain",
    "ykv_scoo", "mode1_scoo",
    "mode2_compact_scoo", "mode3_scoo", "scoo_xk_times_v", "scoo_project",
    "scoo_xk_times_v_variant", "scoo_project_variant",
]

KERNELS = ("scoo_xk_times_v", "scoo_project")
LIB = KernelLib("scoo", KERNELS, {
    "spartan_scoo_xk_times_v": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spartan_scoo_xk_times_v_variant": [_I, _I, _I, _I, _I, _I],
    "spartan_scoo_project": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spartan_scoo_project_variant": [_I, _I, _I, _I, _I, _I],
})
# kernel launches per wrapper; plain-version calls on the CPU are not counted
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches


# ---------------------------------------------------------------------------
# plain torch: sorted-boundary segment sums, scatter-add oracle
# ---------------------------------------------------------------------------

def _gather_n(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: M [Kb, S, R], idx i32 [Kb, N] -> [Kb, N, R]."""
    return torch.gather(M, 1, idx.long()[..., None].expand(-1, -1, M.shape[-1]))


def _segsum_t(contrib_t: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """contrib_t [Kb, R, N] sorted by segment along N, ends i32 [Kb, S]
    -> [Kb, R, S]: the running sum along N read at the ends, differenced."""
    Kb, R, _ = contrib_t.shape
    csum = torch.cumsum(contrib_t, 2)
    csum = torch.cat([csum.new_zeros((Kb, R, 1)), csum], 2)
    e = torch.gather(csum, 2, ends.long()[:, None, :].expand(-1, R, -1))
    return torch.diff(e, dim=2, prepend=e.new_zeros((Kb, R, 1)))


def segment_sum_sorted(contrib: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Segment sum of sorted contributions by prefix-sum differencing.

    contrib [Kb, N, R] sorted by destination segment; ends i32 [Kb, S] with
    ``ends[k, s]`` one past segment s's last entry (monotone, all <= the
    true nnz, so trailing pads land in no segment) -> [Kb, S, R], contiguous
    (the CUDA kernels downstream take no strided operand)."""
    return _segsum_t(contrib.transpose(1, 2), ends).transpose(1, 2).contiguous()


def _segsum(contrib, idx, ends, n_out: int) -> torch.Tensor:
    """Boundary path when ``ends`` is given, scatter-add oracle otherwise."""
    if ends is not None:
        return segment_sum_sorted(contrib, ends)
    Kb, _, R = contrib.shape
    out = contrib.new_zeros((Kb, n_out, R))
    return out.scatter_add_(1, idx.long()[..., None].expand(-1, -1, R), contrib)


def xk_times_v_plain(vals, rows, lcols, Vg, i_pad: int,
                     row_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 11's plain version: :func:`xk_times_v` in the accumulation dtype,
    without its rounding to ``vals.dtype`` (the two differ below f32 only)."""
    acc = accum_dtype(vals)
    contrib = _gather_n(Vg.to(acc), lcols) * vals.to(acc)[..., None]
    return _segsum(contrib, rows, row_ends, i_pad)


def xk_times_v(vals, rows, lcols, Vg, i_pad: int, *,
               row_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """X_k V from SCOO triplets: vals [Kb,N], rows/lcols i32 [Kb,N], Vg
    [Kb,C,R] (V rows of the kept columns, masked) -> [Kb, I_pad, R] in
    ``vals.dtype``. ``row_ends`` (i32 [Kb, I_pad]) selects the sorted path."""
    return xk_times_v_plain(vals, rows, lcols, Vg, i_pad, row_ends).to(vals.dtype)


def project_plain(vals, rows, lcols, Q, c_pad: int, cperm: Optional[torch.Tensor] = None,
                  col_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row 12's plain version: :func:`project` in the accumulation dtype,
    without its rounding to ``vals.dtype`` (the two differ below f32 only)."""
    acc = accum_dtype(vals)
    if cperm is not None and col_ends is not None:
        p = cperm.long()
        vals_c = torch.gather(vals, 1, p).to(acc)
        qg = _gather_n(Q.to(acc), torch.gather(rows, 1, p))
        return _segsum_t((qg * vals_c[..., None]).transpose(1, 2), col_ends)
    contrib = _gather_n(Q.to(acc), rows) * vals.to(acc)[..., None]
    return _segsum(contrib, lcols, None, c_pad).transpose(1, 2).contiguous()


def project(vals, rows, lcols, Q, c_pad: int, *,
            cperm: Optional[torch.Tensor] = None,
            col_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y_k = Q_k^T X_k from SCOO triplets -> [Kb, R, C_pad] in
    ``vals.dtype``, CC's compact Yc layout. ``cperm``/``col_ends`` (the
    column-sorted view) select the sorted path."""
    return project_plain(vals, rows, lcols, Q, c_pad, cperm, col_ends).to(vals.dtype)


def ykv_scoo(vals, rows, lcols, Q, Vg) -> torch.Tensor:
    """Y_k V [Kb, R, R] from the triplets, Yc never formed:
    sum_n vals[n] * Q[rows[n], :] (x) Vg[lcols[n], :]."""
    acc = accum_dtype(vals)
    qg = _gather_n(Q.to(acc), rows) * vals.to(acc)[..., None]     # [Kb, N, R]
    return torch.bmm(qg.transpose(1, 2), _gather_n(Vg.to(acc), lcols))


def mode1_scoo(vals, rows, lcols, Q, Vg, Wb, subject_mask) -> torch.Tensor:
    """Partial M1 [R, R]: the ykv outer-product sum, Hadamard with W(k,:),
    reduced over real subjects (as ``spartan.mode1_bucket``)."""
    YkV = ykv_scoo(vals, rows, lcols, Q, Vg)
    scaled = YkV * Wb.to(YkV.dtype)[:, None, :]
    return torch.einsum("krl,k->rl", scaled, subject_mask.to(YkV.dtype))


def mode2_compact_scoo(vals, rows, lcols, Q, H, Wb, col_mask, subject_mask, *,
                       cperm: Optional[torch.Tensor] = None,
                       col_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compact mode-2 A [Kb, C, R]: A[k,c,:] = (Y_k(:,c)^T H) * W(k,:), the
    segment sum over kept columns of vals[n] * (Q_k H)[rows[n], :], with
    ``spartan.mode2_bucket_compact``'s masking. ``cperm``/``col_ends``
    select the sorted path."""
    acc = accum_dtype(vals)
    QH = torch.matmul(Q.to(acc), H.to(acc))
    c_pad = col_mask.shape[-1]
    if cperm is not None and col_ends is not None:
        p = cperm.long()
        g = _gather_n(QH, torch.gather(rows, 1, p)) * torch.gather(vals, 1, p).to(acc)[..., None]
        A = segment_sum_sorted(g, col_ends)
    else:
        g = _gather_n(QH, rows) * vals.to(acc)[..., None]
        A = _segsum(g, lcols, None, c_pad)
    A = A * Wb.to(acc)[:, None, :]
    return A * (col_mask * subject_mask[:, None]).to(acc)[..., None]


def mode3_scoo(vals, rows, lcols, Q, Vg, H, subject_mask) -> torch.Tensor:
    """Per-subject M3 rows [Kb, R]: coldot(H, Y_k V) with Y_k V from the
    triplets (as ``spartan.mode3_bucket``)."""
    YkV = ykv_scoo(vals, rows, lcols, Q, Vg)
    out = torch.einsum("rl,krl->kl", H.to(YkV.dtype), YkV)
    return out * subject_mask.to(YkV.dtype)[:, None]


# ---------------------------------------------------------------------------
# the CUDA kernels (rows 11 and 12 of PERF.md's kernel table)
# ---------------------------------------------------------------------------

def scoo_xk_times_v(vals: torch.Tensor, rows: torch.Tensor, lcols: torch.Tensor,
                    Vg: torch.Tensor, i_pad: int, *,
                    row_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """X_k V [Kb, I_pad, R] from the triplets (vals [Kb,N], rows/lcols i32
    [Kb,N], Vg [Kb,C,R], row_ends i32 [Kb,I_pad]); the counterpart of
    ``xk_times_v_pallas``, in the accumulation dtype (float32 for half vals
    and Vg). On CUDA tensors it launches ``spartan_scoo_xk_times_v`` (or
    raises, also without ``row_ends``); on the CPU it runs
    :func:`xk_times_v_plain`."""
    Kb, N = vals.shape
    _, C, R = Vg.shape
    check_shapes(rows=(rows, (Kb, N)), lcols=(lcols, (Kb, N)), Vg=(Vg, (Kb, C, R)))
    if row_ends is not None:
        check_shapes(row_ends=(row_ends, (Kb, i_pad)))
    if Kb == 0 or i_pad == 0:
        return vals.new_zeros((Kb, i_pad, R), dtype=accum_dtype(vals))
    if on_cpu(vals, rows, lcols, Vg, *([] if row_ends is None else [row_ends])):
        return xk_times_v_plain(vals, rows, lcols, Vg, i_pad, row_ends)
    if row_ends is None:
        raise ValueError("scoo_xk_times_v on CUDA sums each row's segment: pass row_ends")
    code = dtype_codes((vals, Vg))
    check_index(lcols=lcols, row_ends=row_ends)
    out = torch.empty((Kb, i_pad, R), dtype=accum_dtype(vals), device=vals.device)
    LIB.launch("scoo_xk_times_v", "spartan_scoo_xk_times_v", vals.device, code,
               vals.data_ptr(), lcols.data_ptr(), Vg.data_ptr(), row_ends.data_ptr(),
               out.data_ptr(), Kb, N, i_pad, C, R)
    return out


def scoo_xk_times_v_variant(vals: torch.Tensor, rows: torch.Tensor, lcols: torch.Tensor,
                            Vg: torch.Tensor, i_pad: int, *, row_ends: torch.Tensor) -> str:
    """Which variant of row 11's kernel :func:`scoo_xk_times_v` launches for
    these CUDA operands: ``ring`` (the main path's), ``ring-element-copies``
    for operands whose runs are not whole 16-byte packs or do not start on a
    16-byte boundary, or ``thread-per-entry`` for subjects too large for the
    ring's shared-memory stages."""
    Kb, N = vals.shape
    _, C, R = Vg.shape
    dtype = dtype_codes((vals, Vg))       # raises for a tensor off the card
    aligned = all(t.data_ptr() % 16 == 0 for t in (vals, lcols, Vg, row_ends))
    code = LIB.lib().spartan_scoo_xk_times_v_variant(dtype, N, i_pad, C, R, int(aligned))
    if code < 0:
        raise ValueError(f"no scoo_xk_times_v variant for N={N}, I={i_pad}, C={C}, R={R}")
    return RING_VARIANTS[code]


def scoo_project(vals: torch.Tensor, rows: torch.Tensor, lcols: torch.Tensor,
                 Q: torch.Tensor, c_pad: int, *,
                 cperm: Optional[torch.Tensor] = None,
                 col_ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y_k = Q_k^T X_k [Kb, R, C_pad] from the triplets and Q [Kb,I,R]
    (cperm i32 [Kb,N], col_ends i32 [Kb,C_pad]); the counterpart of
    ``project_pallas``, in the accumulation dtype (float32 for half vals,
    with Q float32). Empty column segments (padded columns and subjects)
    are exact zeros. On CUDA tensors it launches ``spartan_scoo_project``
    (or raises, also without ``cperm``/``col_ends``); on the CPU it runs
    :func:`project_plain`."""
    Kb, N = vals.shape
    _, I, R = Q.shape
    check_shapes(rows=(rows, (Kb, N)), lcols=(lcols, (Kb, N)), Q=(Q, (Kb, I, R)))
    if cperm is not None:
        check_shapes(cperm=(cperm, (Kb, N)))
    if col_ends is not None:
        check_shapes(col_ends=(col_ends, (Kb, c_pad)))
    if Kb == 0 or c_pad == 0:
        return vals.new_zeros((Kb, R, c_pad), dtype=accum_dtype(vals))
    index = [t for t in (cperm, col_ends) if t is not None]
    if on_cpu(vals, rows, lcols, Q, *index):
        return project_plain(vals, rows, lcols, Q, c_pad, cperm, col_ends)
    if cperm is None or col_ends is None:
        raise ValueError("scoo_project on CUDA sums each column's segment: "
                         "pass cperm and col_ends")
    code = dtype_codes((vals,), Q)
    check_index(rows=rows, cperm=cperm, col_ends=col_ends)
    out = torch.empty((Kb, R, c_pad), dtype=accum_dtype(vals), device=vals.device)
    LIB.launch("scoo_project", "spartan_scoo_project", vals.device, code,
               vals.data_ptr(), rows.data_ptr(), cperm.data_ptr(), Q.data_ptr(),
               col_ends.data_ptr(), out.data_ptr(), Kb, N, I, c_pad, R)
    return out


def scoo_project_variant(vals: torch.Tensor, rows: torch.Tensor, lcols: torch.Tensor,
                         Q: torch.Tensor, c_pad: int, *, cperm: torch.Tensor,
                         col_ends: torch.Tensor) -> str:
    """Which variant of row 12's kernel :func:`scoo_project` launches for
    these CUDA operands: ``ring`` (the main path's), ``ring-element-copies``
    for operands whose runs are not whole 16-byte packs or do not start on a
    16-byte boundary, or ``thread-per-entry`` for subjects too large for the
    ring's two shared-memory stages."""
    Kb, N = vals.shape
    _, I, R = Q.shape
    dtype = dtype_codes((vals,), Q)       # raises for a tensor off the card
    aligned = all(t.data_ptr() % 16 == 0 for t in (vals, rows, cperm, Q, col_ends))
    code = LIB.lib().spartan_scoo_project_variant(dtype, N, I, c_pad, R, int(aligned))
    if code < 0:
        raise ValueError(f"no scoo_project variant for N={N}, I={I}, C={c_pad}, R={R}")
    return RING_VARIANTS[code]
