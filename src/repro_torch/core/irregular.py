"""Device-side irregular-tensor formats, as torch tensors on a device.

The counterpart of ``repro.core.irregular``. Three formats:

* **CC (compressed columns)**: each subject slice X_k (I_k x J) is stored
  dense over its nonzero columns, ``vals[k] in R^{I_pad x C_pad}``, with the
  global column ids ``cols[k] in {0..J-1}^{C_pad}``. Every identity of the
  paper becomes a gather of V rows plus a small dense product. Cost per
  iteration: O(Kb * I_pad * C_pad * R) whatever the true nonzero count.
* **SCOO (sorted flat COO)**: each subject's nonzeros as flat triplets
  ``vals[k] in R^{N_pad}`` with local ``rows``/``lcols``, sorted row-major
  and padded to the bucket's N_pad, plus the row and column segment
  pointers (``row_ends``; ``cperm``/``col_ends``) computed on the host. The
  kept-column metadata is CC's, so ``project`` lands in CC's compact Yc
  layout. Every contraction is a gather plus a segment sum in O(nnz * R)
  (:mod:`repro_torch.kernels.scoo`).
* **BCC (block-compressed columns)**: CC with the columns quantized to
  ``LANE``-wide blocks of J, the layout of the gather-matmul kernel
  (:mod:`repro_torch.kernels.gather_matmul`); :func:`to_block_bucket`
  converts a CC bucket.

``bucketize(format=...)`` picks per bucket: ``"cc"``/``"scoo"`` force one
format, ``"auto"`` routes each bucket by its density through
:func:`repro_torch.sparse.bucketing.route_formats`, so a :class:`Bucketed`
may mix :class:`Bucket` and :class:`SparseBucket`. Buckets are staged in
numpy, byte for byte as the reference stages them, and uploaded once; the
index arrays stay int32.

``bucketize(shard=(index, count))`` builds one rank's shard for the mesh
engine: every bucket's padded subject axis splits into ``count`` contiguous
chunks, and only chunk ``index`` is staged and uploaded, so no rank holds
another rank's subjects on its device. A shard keeps the global
``n_subjects``, ``n_cols`` and ``norm_sq`` and the global ``subject_ids``;
its real subjects fill the first ``n_real`` slots of each of its buckets.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, scoo
from repro_torch.kernels.common import compute_cast
from repro_torch.sparse.bucketing import (SCOO_DENSITY_THRESHOLD, BucketPlan,
                                          plan_buckets, route_formats)
from repro_torch.sparse.coo import IrregularCOO

__all__ = ["Bucket", "SparseBucket", "BlockBucket", "Bucketed", "bucketize",
           "bucket_format", "cc_bucket_like", "check_shardable", "scatter_order",
           "to_block_bucket", "FORMATS", "LANE"]

LANE = 128  # BCC column-block width (the reference's TPU lane width)

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


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _scatter_cols_to_dense(b, compact: torch.Tensor, J: int) -> torch.Tensor:
    """Expand a compact matrix [Kb, *, C_pad] to dense [Kb, *, J] (tests)."""
    Kb, mid, _ = compact.shape
    out = compact.new_zeros((Kb, mid, J))
    idx = b.cols.long()[:, None, :].expand(-1, mid, -1)
    return out.scatter_add_(2, idx, compact * b.col_mask[:, None, :])


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
    scatter_perm, scatter_ends: the column sort of ``cols``
                  (:func:`scatter_order`), computed once at ``bucketize``
                  for the mode-2 scatter
    vals_half:    ``vals`` at a half compute precision (bf16/f16), made once
                  for a fit by :meth:`Bucketed.with_compute_values`; None
                  otherwise
    """

    vals: torch.Tensor
    cols: torch.Tensor
    col_mask: torch.Tensor
    subject_ids: torch.Tensor
    subject_mask: torch.Tensor
    row_counts: torch.Tensor
    n_real: int
    scatter_perm: torch.Tensor
    scatter_ends: torch.Tensor
    vals_half: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False,
                                                          compare=False)

    format = "cc"  # class tag, not a field (see bucket_format)

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
        return _nbytes(self.vals, self.cols, self.col_mask, self.subject_ids,
                       self.subject_mask, self.row_counts, self.scatter_perm,
                       self.scatter_ends)

    # -- core contractions (batched over Kb) --------------------------------
    def gather_v(self, V: torch.Tensor) -> torch.Tensor:
        """V rows for this bucket's kept columns: [Kb, C_pad, R] in V's dtype
        (pad rows 0)."""
        return V[self.cols.long()] * self.col_mask[..., None].to(V.dtype)

    def xk_times_v(self, V: torch.Tensor,
                   Vg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """X_k V for every subject: [Kb, I_pad, R]; only the V rows of kept
        columns take part."""
        if Vg is None:
            Vg = self.gather_v(V)
        return torch.bmm(self.vals, Vg)

    def xk_times_v_bcc(self, bcc: "BlockBucket", V: torch.Tensor) -> torch.Tensor:
        """X_k V through the BCC gather-matmul kernel (its plain version on
        the CPU); V is zero-padded to a multiple of ``LANE`` rows."""
        J, R = V.shape
        J_pad = -(-J // LANE) * LANE
        if J_pad != J:
            V = torch.cat([V, V.new_zeros((J_pad - J, R))])
        return ops.gather_matmul(bcc.vals, bcc.blk_ids, V.contiguous()).to(self.vals.dtype)

    def project(self, Q: torch.Tensor) -> torch.Tensor:
        """Y_k = Q_k^T X_k in CC format: [Kb, R, C_pad]; shares ``cols``."""
        return torch.bmm(Q.transpose(1, 2), self.vals)

    def sq_norms(self) -> torch.Tensor:
        """Per-subject ||X_k||_F^2 [Kb] (padding slots give 0)."""
        return (self.vals * self.vals).sum(dim=(1, 2))

    def scatter_cols_to_dense(self, compact: torch.Tensor, J: int) -> torch.Tensor:
        """Expand a CC matrix [Kb, *, C_pad] back to dense [Kb, *, J] (tests)."""
        return _scatter_cols_to_dense(self, compact, J)


@dataclasses.dataclass(frozen=True)
class SparseBucket:
    """One fixed-shape bucket of subjects in SCOO (sorted flat COO) format.

    vals:         f[Kb, N_pad]     nonzero values, row-major sorted per
                                   subject (pad entries 0)
    rows:         i32[Kb, N_pad]   local row in the I_pad row space (pad: 0)
    lcols:        i32[Kb, N_pad]   local kept-column slot in [0, C_pad)
    row_ends:     i32[Kb, I_pad]   one past row i's last triplet
    cperm:        i32[Kb, N_pad]   the column-sorted order (pads stay at the tail)
    col_ends:     i32[Kb, C_pad]   one past column c's last entry of that order
    cols, col_mask, subject_ids, subject_mask, row_counts: as :class:`Bucket`
    nnz_counts:   i32[Kb]          true nnz_k (pad subjects 0)
    n_rows_pad:   I_pad, the row space Q and X_k V use
    n_real, scatter_perm, scatter_ends, vals_half: as :class:`Bucket`

    Every subject owns one N_pad segment, so ``nnz_offsets`` is
    ``arange(Kb) * N_pad``. Pad triplets carry 0 and lie past every end, so
    they vanish from every segment sum.
    """

    vals: torch.Tensor
    rows: torch.Tensor
    lcols: torch.Tensor
    row_ends: torch.Tensor
    cperm: torch.Tensor
    col_ends: torch.Tensor
    cols: torch.Tensor
    col_mask: torch.Tensor
    subject_ids: torch.Tensor
    subject_mask: torch.Tensor
    row_counts: torch.Tensor
    nnz_counts: torch.Tensor
    n_rows_pad: int
    n_real: int
    scatter_perm: torch.Tensor
    scatter_ends: torch.Tensor
    vals_half: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False,
                                                          compare=False)

    format = "scoo"

    @property
    def kb(self) -> int:
        return self.vals.shape[0]

    @property
    def i_pad(self) -> int:
        return self.n_rows_pad

    @property
    def c_pad(self) -> int:
        return self.cols.shape[1]

    @property
    def n_pad(self) -> int:
        return self.vals.shape[1]

    @property
    def nnz_offsets(self) -> torch.Tensor:
        """Per-subject start offset into the flattened nnz axis."""
        return torch.arange(self.kb, dtype=torch.int32, device=self.vals.device) * self.n_pad

    def nbytes(self) -> int:
        """Device bytes this bucket holds."""
        return _nbytes(self.vals, self.rows, self.lcols, self.row_ends, self.cperm,
                       self.col_ends, self.cols, self.col_mask, self.subject_ids,
                       self.subject_mask, self.row_counts, self.nnz_counts,
                       self.scatter_perm, self.scatter_ends)

    # -- core contractions (batched over Kb, O(nnz * R)) ---------------------
    def gather_v(self, V: torch.Tensor) -> torch.Tensor:
        """V rows for this bucket's kept columns: [Kb, C_pad, R] in V's dtype
        (pad rows 0)."""
        return V[self.cols.long()] * self.col_mask[..., None].to(V.dtype)

    def xk_times_v(self, V: torch.Tensor,
                   Vg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """X_k V [Kb, I_pad, R]: gather from Vg, sorted segment sum over
        rows (the plain torch math on any device)."""
        if Vg is None:
            Vg = self.gather_v(V)
        return scoo.xk_times_v(self.vals, self.rows, self.lcols, Vg, self.i_pad,
                               row_ends=self.row_ends)

    def project(self, Q: torch.Tensor) -> torch.Tensor:
        """Y_k = Q_k^T X_k [Kb, R, C_pad] in CC's compact layout: gather
        from Q, sorted segment sum over kept columns."""
        return scoo.project(self.vals, self.rows, self.lcols, Q, self.c_pad,
                            cperm=self.cperm, col_ends=self.col_ends)

    def sq_norms(self) -> torch.Tensor:
        """Per-subject ||X_k||_F^2 [Kb]; pad triplets are 0."""
        return (self.vals * self.vals).sum(dim=1)

    def dense_vals(self) -> torch.Tensor:
        """The CC vals rectangle [Kb, I_pad, C_pad] (tests)."""
        Kb, N = self.vals.shape
        out = self.vals.new_zeros((Kb, self.i_pad * self.c_pad))
        flat = self.rows.long() * self.c_pad + self.lcols.long()
        return out.scatter_add_(1, flat, self.vals).view(Kb, self.i_pad, self.c_pad)

    def scatter_cols_to_dense(self, compact: torch.Tensor, J: int) -> torch.Tensor:
        """Expand a compact matrix [Kb, *, C_pad] to dense [Kb, *, J] (tests)."""
        return _scatter_cols_to_dense(self, compact, J)


AnyBucket = Union[Bucket, SparseBucket]


def bucket_format(b) -> str:
    """Device-format tag of a bucket: "cc" | "scoo"."""
    return getattr(b, "format", "cc")


def cc_bucket_like(b: AnyBucket, vals: torch.Tensor,
                   row_counts: Optional[torch.Tensor] = None) -> Bucket:
    """A CC :class:`Bucket` holding ``vals`` [Kb, I', C_pad] under ``b``'s
    column and subject metadata (``b`` CC or SCOO: both carry ``cols``,
    ``col_mask``, the subject fields, ``n_real`` and the scatter order). The
    row space I' may differ from ``b.i_pad``: this is how the compression
    stage (:mod:`repro_torch.core.compress`) wraps the small cores
    ``G_k = P_k^T X_k`` as a bucket the engines iterate on."""
    if vals.shape[0] != b.kb or vals.shape[2] != b.c_pad:
        raise ValueError(
            f"vals shape {tuple(vals.shape)} does not match bucket metadata "
            f"(Kb={b.kb}, C_pad={b.c_pad})")
    return Bucket(
        vals=vals, cols=b.cols, col_mask=b.col_mask, subject_ids=b.subject_ids,
        subject_mask=b.subject_mask,
        row_counts=b.row_counts if row_counts is None else row_counts,
        n_real=b.n_real, scatter_perm=b.scatter_perm, scatter_ends=b.scatter_ends)


@dataclasses.dataclass(frozen=True)
class Bucketed:
    """A bucketed irregular tensor: fixed-shape buckets + global metadata."""

    buckets: List[AnyBucket]
    n_subjects: int          # K (true count, before subject padding)
    n_cols: int              # J
    norm_sq: float           # ||X||_F^2 over all subjects (for the fit)
    # (index, count): this is chunk `index` of `count` of every bucket's
    # subjects (the mesh engine's shard of one rank); (0, 1) for whole data
    shard: Tuple[int, int] = (0, 1)
    # norm_sq as a device scalar per dtype, made at first use
    _norm_sq_t: Dict[torch.dtype, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.buckets[0].cols.device

    def with_compute_values(self, precision: Optional[str]) -> "Bucketed":
        """This data with each bucket's values also held at the compute
        precision: ``vals_half = compute_cast(vals, precision)``, made once
        here so that a fit's stages read the half values instead of casting
        the slab at every stage call. ``norm_sq`` stays the f32 host value.
        At ``"f32"`` (or None) it is this data itself: nothing is copied."""
        if precision in (None, "f32"):
            return self
        half = [dataclasses.replace(b, vals_half=compute_cast(b.vals, precision))
                for b in self.buckets]
        return Bucketed(buckets=half, n_subjects=self.n_subjects, n_cols=self.n_cols,
                        norm_sq=self.norm_sq, shard=self.shard)

    def norm_sq_tensor(self, dtype: torch.dtype) -> torch.Tensor:
        """``norm_sq`` as a scalar of ``dtype`` on the data's device, copied
        there once: the fit reads it every iteration without a host copy,
        which a CUDA graph could not capture."""
        t = self._norm_sq_t.get(dtype)
        if t is None:
            t = self._norm_sq_t[dtype] = torch.tensor(self.norm_sq, dtype=dtype,
                                                      device=self.device)
        return t


def _pad_to(n: int, align: int) -> int:
    return max(align, ((n + align - 1) // align) * align)


def check_shardable(i: int, kb: int, n_shards: int) -> None:
    """Raise the reference's error unless bucket ``i``'s padded subject
    count ``kb`` divides into ``n_shards`` contiguous chunks."""
    if kb % n_shards:
        raise ValueError(
            f"engine='mesh' needs every bucket's subject count to divide "
            f"the {n_shards} subject shards, but bucket {i} has Kb={kb}; "
            f"re-bucketize with bucketize(subject_align={n_shards})")


def _staging_dtype(dtype: torch.dtype) -> np.dtype:
    """Host staging dtype: f64 only when f64 is requested; every other float
    stages in f32 and is cast once at upload."""
    return np.dtype(np.float64) if dtype == torch.float64 else np.dtype(np.float32)


def _running_counts(slot: np.ndarray, idx: np.ndarray, n: int, width: int) -> np.ndarray:
    """[n, width]: per slot, the number of entries with idx <= i (the
    reference's ``searchsorted(sorted idx, arange(width), side="right")``)."""
    ok = idx < width
    counts = np.bincount(slot[ok] * width + idx[ok], minlength=n * width)
    return np.cumsum(counts.reshape(n, width), axis=1)


def _stage_scoo(data: IrregularCOO, members: np.ndarray, kb: int, i_pad: int,
                c_pad: int, n_pad: int, stage: np.dtype) -> dict:
    """The SCOO host arrays of one bucket, for all its subjects at once.

    The reference's per-subject loop sorts each subject's triplets
    row-major (``lexsort((lcol, row))``) and its column view by
    ``lexsort((row, lcol))``. One stable sort of all the bucket's triplets
    on a combined (slot, row, lcol) key, and one on (slot, lcol, row), give
    every subject the same order, ties included (a stable sort on bounded
    keys is a lexsort, an order of magnitude faster in numpy); the segment
    ends are running counts of rows and columns."""
    subs = [data.subjects[k] for k in members]
    n = len(subs)
    nz = np.asarray([s.nnz for s in subs], dtype=np.int64)
    over = np.nonzero(nz > n_pad)[0]
    if over.size:
        k = int(members[over[0]])
        raise ValueError(f"subject {k} has {int(nz[over[0]])} nonzeros > bucket "
                         f"N_pad {n_pad} (stale plan?)")
    J = data.n_cols
    slot = np.repeat(np.arange(n, dtype=np.int64), nz)
    start = np.cumsum(nz) - nz
    cat = (lambda f, dt: np.concatenate([getattr(s, f) for s in subs]).astype(dt)
           if n else np.zeros(0, dt))
    rows, cols, vals = cat("rows", np.int64), cat("cols", np.int64), cat("vals", np.float64)
    key = slot * J + cols
    ukey = np.unique(key)                          # per slot: its sorted kept columns
    kslot = ukey // J
    first = np.searchsorted(kslot, np.arange(n))
    lcol = np.searchsorted(ukey, key) - first[slot]
    nr, nc = int(rows.max(initial=0)) + 1, int(lcol.max(initial=0)) + 1
    order = np.argsort((slot * nr + rows) * nc + lcol, kind="stable")   # row-major
    rr, lc = rows[order], lcol[order]
    pos = np.arange(order.size) - start[slot]      # slot[order] == slot
    out = dict(
        vals=np.zeros((kb, n_pad), dtype=stage),
        rows=np.zeros((kb, n_pad), dtype=np.int32),
        lcols=np.zeros((kb, n_pad), dtype=np.int32),
        cperm=np.tile(np.arange(n_pad, dtype=np.int32), (kb, 1)),
        row_ends=np.zeros((kb, i_pad), dtype=np.int32),
        col_ends=np.zeros((kb, c_pad), dtype=np.int32),
        cols=np.zeros((kb, c_pad), dtype=np.int32),
        cmask=np.zeros((kb, c_pad), dtype=stage),
        nnz=np.zeros((kb,), dtype=np.int32),
    )
    out["vals"][slot, pos] = vals[order]
    out["rows"][slot, pos] = rr
    out["lcols"][slot, pos] = lc
    corder = np.argsort((slot * nc + lc) * nr + rr, kind="stable")      # column-major
    out["cperm"][slot, pos] = corder - start[slot]
    out["row_ends"][:n] = _running_counts(slot, rr, n, i_pad)
    out["col_ends"][:n] = _running_counts(slot, lc, n, c_pad)
    kpos = np.arange(ukey.size) - first[kslot]
    out["cols"][kslot, kpos] = ukey % J
    out["cmask"][kslot, kpos] = 1.0
    out["nnz"][:n] = nz
    return out


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
    formats: Optional[Sequence[str]] = None,
    density_threshold: float = SCOO_DENSITY_THRESHOLD,
    shard: Tuple[int, int] = (0, 1),
) -> Bucketed:
    """Host conversion IrregularCOO -> Bucketed tensors on ``device`` (a GPU
    by default: raises without one unless ``device="cpu"``).

    ``format`` picks the per-bucket layout: ``"cc"``, ``"scoo"`` (the plan
    then sorts subjects by nnz and pads N_pad) or ``"auto"`` (each bucket by
    its density, below ``density_threshold`` -> SCOO); ``formats`` overrides
    the routing with one entry per bucket of ``plan``. ``plan`` defaults to
    :func:`plan_buckets` with the reference's arguments, so both packages
    build the same buckets. ``subject_align`` pads each bucket's subject
    count to a multiple; padding subjects sit at the tail. ``nnz_align``
    rounds the SCOO buckets' N_pad.

    ``shard=(index, count)`` stages and uploads only chunk ``index`` of
    ``count`` contiguous chunks of every bucket's padded subjects (a mesh
    rank's shard; each padded Kb must divide by ``count``, as
    ``subject_align=count`` makes it). Each chunk is staged on its own, so
    its bytes are those of a bucket of its subjects: the same rows, in
    their own allocations.
    """
    if format not in FORMATS:
        raise ValueError(f"unknown format {format!r}; choose from {FORMATS}")
    rc, cc, nnzc = data.row_counts(), data.col_counts(), data.nnz_counts()
    if plan is None:
        plan = plan_buckets(rc, cc, max_buckets=max_buckets, row_align=row_align,
                            col_align=col_align, nnz_counts=nnzc, nnz_align=nnz_align,
                            sort_by="nnz" if format == "scoo" else "area")
    if formats is None:
        formats = route_formats(plan, nnzc, format=format,
                                density_threshold=density_threshold)
    if len(formats) != plan.n_buckets:
        raise ValueError(f"formats has {len(formats)} entries for {plan.n_buckets} buckets")
    index, count = shard
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} is not in [0, {count})")
    device = resolve_device(device)
    stage = _staging_dtype(dtype)
    J = data.n_cols

    def up(a, dt=None):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    buckets: List[AnyBucket] = []
    for bi, ((i_pad, c_pad), members) in enumerate(zip(plan.shapes, plan.members)):
        kb = _pad_to(len(members), subject_align)
        whole = members                     # a shard takes its N_pad from the bucket
        if count > 1:
            check_shardable(bi, kb, count)
            kb //= count
            members = members[index * kb:(index + 1) * kb]
        sids = np.zeros((kb,), dtype=np.int32)
        smask = np.zeros((kb,), dtype=stage)
        rows_n = np.zeros((kb,), dtype=np.int32)
        sids[: len(members)] = members
        smask[: len(members)] = 1.0
        rows_n[: len(members)] = rc[members]
        if formats[bi] == "scoo":
            if plan.nnz_pads is not None:
                n_pad = plan.nnz_pads[bi]
            else:
                n_pad = _pad_to(int(max((nnzc[k] for k in whole), default=1)), nnz_align)
            s = _stage_scoo(data, members, kb, i_pad, c_pad, n_pad, stage)
            cols_t, cmask_t = up(s["cols"]), up(s["cmask"], dtype)
            perm, ends = scatter_order(cols_t, J, cmask_t)
            buckets.append(SparseBucket(
                vals=up(s["vals"], dtype), rows=up(s["rows"]), lcols=up(s["lcols"]),
                row_ends=up(s["row_ends"]), cperm=up(s["cperm"]),
                col_ends=up(s["col_ends"]), cols=cols_t, col_mask=cmask_t,
                subject_ids=up(sids), subject_mask=up(smask, dtype),
                row_counts=up(rows_n), nnz_counts=up(s["nnz"]), n_rows_pad=i_pad,
                n_real=len(members), scatter_perm=perm, scatter_ends=ends))
            continue
        if formats[bi] != "cc":
            raise ValueError(f"unknown bucket format {formats[bi]!r}")
        vals = np.zeros((kb, i_pad, c_pad), dtype=stage)
        cols = np.zeros((kb, c_pad), dtype=np.int32)
        cmask = np.zeros((kb, c_pad), dtype=stage)
        for slot, k in enumerate(members):
            s = data.subjects[k]
            kept = s.nonzero_cols()
            # kept is sorted and unique, so its searchsorted index is the
            # local column (the reference's remap dict, vectorised)
            vals[slot, s.rows, np.searchsorted(kept, s.cols)] = s.vals
            cols[slot, : kept.size] = kept
            cmask[slot, : kept.size] = 1.0
        cols_t = up(cols)
        perm, ends = scatter_order(cols_t, J, up(cmask))
        buckets.append(Bucket(
            vals=up(vals, dtype), cols=cols_t, col_mask=up(cmask, dtype),
            subject_ids=up(sids), subject_mask=up(smask, dtype),
            row_counts=up(rows_n), n_real=len(members),
            scatter_perm=perm, scatter_ends=ends))
    return Bucketed(buckets=buckets, n_subjects=data.n_subjects, n_cols=J,
                    norm_sq=data.frobenius_sq(), shard=(index, count))


# ---------------------------------------------------------------------------
# BCC: block-compressed columns (the gather-matmul kernel's layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockBucket:
    """BCC layout: columns quantized to LANE-wide blocks of J.

    vals:     f[Kb, I_pad, NB, LANE]  dense values per kept column block
    blk_ids:  i32[Kb, NB]             global block index (j // LANE) (pad: 0)
    blk_mask: f[Kb, NB]               1.0 for real blocks
    """

    vals: torch.Tensor
    blk_ids: torch.Tensor
    blk_mask: torch.Tensor
    subject_ids: torch.Tensor
    subject_mask: torch.Tensor

    @property
    def kb(self) -> int:
        return self.vals.shape[0]

    @property
    def i_pad(self) -> int:
        return self.vals.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.vals.shape[2]


def to_block_bucket(b: Bucket, J: int, *, max_blocks: Optional[int] = None,
                    allow_truncate: bool = False) -> BlockBucket:
    """Host-side CC -> BCC conversion (column ids quantized to LANE blocks),
    on the bucket's device.

    ``max_blocks`` caps the per-subject block count; the column blocks past
    the cap (the highest block ids) DROP their nonzeros. That is data loss,
    so by default it raises ``ValueError`` with the dropped-nonzero count;
    with ``allow_truncate=True`` a ``UserWarning`` with the same count is
    emitted instead.
    """
    vals = b.vals.cpu().numpy()
    cols = b.cols.cpu().numpy()
    cmask = b.col_mask.cpu().numpy() > 0
    kb, i_pad, _ = vals.shape
    blocks = [np.unique(cols[k][cmask[k]] // LANE) for k in range(kb)]
    nb = max(1, max((blk.size for blk in blocks), default=1))
    if max_blocks is not None:
        nb = min(nb, max_blocks)
    out_vals = np.zeros((kb, i_pad, nb, LANE), dtype=vals.dtype)
    blk_ids = np.zeros((kb, nb), dtype=np.int32)
    blk_mask = np.zeros((kb, nb), dtype=vals.dtype)
    dropped_nnz = 0
    for k in range(kb):
        kept = blocks[k][:nb]
        blk_ids[k, : kept.size] = kept
        blk_mask[k, : kept.size] = 1.0
        ci = np.nonzero(cmask[k])[0]
        gcol = cols[k, ci].astype(np.int64)
        # kept is the sorted prefix of the subject's blocks: a column of a
        # block past the cap sorts past its end
        slot = np.searchsorted(kept, gcol // LANE)
        ok = slot < kept.size
        dropped_nnz += int(np.count_nonzero(vals[k][:, ci[~ok]]))
        out_vals[k][:, slot[ok], gcol[ok] % LANE] = vals[k][:, ci[ok]]
    if dropped_nnz:
        msg = (f"to_block_bucket(max_blocks={max_blocks}) truncated "
               f"{dropped_nnz} nonzeros (column-blocks beyond the cap); "
               f"raise max_blocks or pass allow_truncate=True to accept "
               f"the data loss")
        if not allow_truncate:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning, stacklevel=2)
    dev = b.vals.device
    return BlockBucket(
        vals=torch.from_numpy(out_vals).to(dev), blk_ids=torch.from_numpy(blk_ids).to(dev),
        blk_mask=torch.from_numpy(blk_mask).to(dev),
        subject_ids=b.subject_ids, subject_mask=b.subject_mask)
