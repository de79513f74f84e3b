"""Device-side irregular-tensor format (CC), as torch tensors on a device.

**CC (compressed columns)**: each subject slice X_k (I_k x J) is stored dense
over its nonzero columns, ``vals[k] in R^{I_pad x C_pad}``, with the global
column ids ``cols[k] in {0..J-1}^{C_pad}``. Every identity of the paper
becomes a gather of V rows plus a small dense product. Cost per iteration:
O(Kb * I_pad * C_pad * R) whatever the true nonzero count.

The counterpart of ``repro.core.irregular``. Only the CC format is ported;
``bucketize(format="scoo"|"auto")`` raises ``NotImplementedError`` naming
ROADMAP Queue A item 10. Buckets are staged in numpy and uploaded once.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.bucketing import BucketPlan, plan_buckets, route_formats
from repro_torch.sparse.coo import IrregularCOO

__all__ = ["Bucket", "Bucketed", "bucketize", "scatter_order", "FORMATS"]

FORMATS = ("cc", "scoo", "auto")  # bucketize(format=...) choices


def scatter_order(cols: torch.Tensor, J: int,
                  col_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted-segment layout of the flat kept-column ids ``cols`` [Kb, C]:
    ``perm`` lists the flat entries in column order (stable), ``ends[j]`` is
    the end of column j's run in that order. ``spartan.mode2_scatter`` turns
    it into a deterministic segment sum (no atomics). With ``col_mask``,
    padding entries are left out: their compact mode-2 rows are exact zeros,
    so the sums are the same with a tenth of the rows at CHOA's geometry."""
    flat = cols.reshape(-1).to(torch.int64)
    idx = torch.arange(flat.numel(), device=cols.device)
    if col_mask is not None:
        idx = idx[col_mask.reshape(-1) > 0]
    perm = idx[torch.sort(flat[idx], stable=True).indices]
    ends = torch.searchsorted(flat[perm],
                              torch.arange(1, J + 1, device=cols.device))
    return perm, ends


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fixed-shape bucket of subjects in CC format.

    vals:         f[Kb, I_pad, C_pad]  dense values over kept columns
    cols:         i32[Kb, C_pad]       global column id per kept column (pad: 0)
    col_mask:     f[Kb, C_pad]         1.0 real kept column, 0.0 padding
    subject_ids:  i32[Kb]              global subject index (row into W)
    subject_mask: f[Kb]                1.0 real subject, 0.0 padding subject
    row_counts:   i32[Kb]              true I_k (padded rows are 0)
    n_real:       the number of real subjects; they fill slots [0, n_real)
    col_perm, col_ends: the column sort of ``cols`` (:func:`scatter_order`),
                  computed once at ``bucketize`` for the mode-2 scatter
    """

    vals: torch.Tensor
    cols: torch.Tensor
    col_mask: torch.Tensor
    subject_ids: torch.Tensor
    subject_mask: torch.Tensor
    row_counts: torch.Tensor
    n_real: int
    col_perm: torch.Tensor
    col_ends: torch.Tensor

    @property
    def kb(self) -> int:
        return self.vals.shape[0]

    @property
    def i_pad(self) -> int:
        return self.vals.shape[1]

    @property
    def c_pad(self) -> int:
        return self.vals.shape[2]

    def nbytes(self) -> int:
        """Device bytes this bucket holds."""
        return sum(t.numel() * t.element_size() for t in (
            self.vals, self.cols, self.col_mask, self.subject_ids,
            self.subject_mask, self.row_counts, self.col_perm, self.col_ends))

    # -- core contractions (batched over Kb) --------------------------------
    def gather_v(self, V: torch.Tensor) -> torch.Tensor:
        """V rows for this bucket's kept columns: [Kb, C_pad, R] (pad rows 0)."""
        return V[self.cols.long()] * self.col_mask[..., None]

    def xk_times_v(self, V: torch.Tensor,
                   Vg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """X_k V for every subject: [Kb, I_pad, R]; only the V rows of kept
        columns take part."""
        if Vg is None:
            Vg = self.gather_v(V)
        return torch.bmm(self.vals, Vg)

    def project(self, Q: torch.Tensor) -> torch.Tensor:
        """Y_k = Q_k^T X_k in CC format: [Kb, R, C_pad]; shares ``cols``."""
        return torch.bmm(Q.transpose(1, 2), self.vals)

    def sq_norms(self) -> torch.Tensor:
        """Per-subject ||X_k||_F^2 [Kb] (padding slots give 0)."""
        return (self.vals * self.vals).sum(dim=(1, 2))


@dataclasses.dataclass(frozen=True)
class Bucketed:
    """A bucketed irregular tensor: fixed-shape buckets + global metadata."""

    buckets: List[Bucket]
    n_subjects: int          # K (true count, before subject padding)
    n_cols: int              # J
    norm_sq: float           # ||X||_F^2 over all subjects (for the fit)

    @property
    def device(self) -> torch.device:
        return self.buckets[0].vals.device


def _pad_to(n: int, align: int) -> int:
    return max(align, ((n + align - 1) // align) * align)


def _staging_dtype(dtype: torch.dtype) -> np.dtype:
    """Host staging dtype: f64 only when f64 is requested; every other float
    stages in f32 and is cast once at upload."""
    return np.dtype(np.float64) if dtype == torch.float64 else np.dtype(np.float32)


def bucketize(
    data: IrregularCOO,
    *,
    max_buckets: int = 4,
    row_align: int = 8,
    col_align: int = 128,
    subject_align: int = 1,
    nnz_align: int = 8,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    plan: Optional[BucketPlan] = None,
    format: str = "cc",
) -> Bucketed:
    """Host conversion IrregularCOO -> Bucketed CC tensors on ``device``
    (a GPU by default: raises without one unless ``device="cpu"``).

    Staged in numpy and uploaded to ``device`` once per array. ``plan``
    defaults to :func:`plan_buckets` with the reference's arguments, so both
    packages build the same buckets. ``subject_align`` pads each bucket's
    subject count to a multiple; padding subjects sit at the tail.
    """
    if format not in FORMATS:
        raise ValueError(f"unknown format {format!r}; choose from {FORMATS}")
    rc, cc, nnzc = data.row_counts(), data.col_counts(), data.nnz_counts()
    if plan is None:
        plan = plan_buckets(rc, cc, max_buckets=max_buckets, row_align=row_align,
                            col_align=col_align, nnz_counts=nnzc,
                            nnz_align=nnz_align, sort_by="area")
    route_formats(plan, nnzc, format=format)      # raises for the SCOO formats
    device = resolve_device(device)
    stage = _staging_dtype(dtype)
    J = data.n_cols
    buckets: List[Bucket] = []
    for (i_pad, c_pad), members in zip(plan.shapes, plan.members):
        kb = _pad_to(len(members), subject_align)
        vals = np.zeros((kb, i_pad, c_pad), dtype=stage)
        cols = np.zeros((kb, c_pad), dtype=np.int32)
        cmask = np.zeros((kb, c_pad), dtype=stage)
        sids = np.zeros((kb,), dtype=np.int32)
        smask = np.zeros((kb,), dtype=stage)
        rows_n = np.zeros((kb,), dtype=np.int32)
        for slot, k in enumerate(members):
            s = data.subjects[k]
            kept = s.nonzero_cols()
            # kept is sorted and unique, so its searchsorted index is the
            # local column (the reference's remap dict, vectorised)
            vals[slot, s.rows, np.searchsorted(kept, s.cols)] = s.vals
            cols[slot, : kept.size] = kept
            cmask[slot, : kept.size] = 1.0
            sids[slot] = k
            smask[slot] = 1.0
            rows_n[slot] = s.n_rows

        def up(a, dt=None):
            return torch.from_numpy(a).to(device=device, dtype=dt)

        cols_t = up(cols)
        perm, ends = scatter_order(cols_t, J, up(cmask))
        buckets.append(Bucket(
            vals=up(vals, dtype), cols=cols_t, col_mask=up(cmask, dtype),
            subject_ids=up(sids), subject_mask=up(smask, dtype),
            row_counts=up(rows_n), n_real=len(members),
            col_perm=perm, col_ends=ends))
    return Bucketed(buckets=buckets, n_subjects=data.n_subjects, n_cols=J,
                    norm_sq=data.frobenius_sq())
