"""Size-bucketing planner: ragged subjects -> a few fixed-shape buckets.

Subjects vary in row count I_k, nonzero-column count c_k and nonzero count
nnz_k; they are grouped into buckets whose padded geometry bounds padding
waste while keeping the number of distinct shapes small. Pad targets are
rounded up to multiples of ``row_align`` / ``col_align``.

``col_align=128`` is kept as the default so that this planner builds exactly
the plan of ``repro.sparse.bucketing`` (where 128 is the TPU lane quantum);
whether Hopper wants another default is an open question (ROADMAP).

Two padding currencies, one per device format (``repro_torch.core.
irregular``): the CC format densifies each slice over its kept columns, so a
bucket costs ``Kb * I_pad * C_pad`` cells whatever its nonzero count
(``padding_waste``); the SCOO format stores flat per-subject triplets padded
to the bucket's ``N_pad`` (``nnz_pads``; plan with ``sort_by="nnz"``).
:func:`route_formats` turns each bucket's density (true nonzeros over the
densified CC cell count) into its "cc"/"scoo" decision, and
:func:`route_compress` each bucket's padded rows into the rsvd stage's
compress-or-pass-through decision (``repro_torch.core.compress``).

For the mesh engine (``repro_torch.core.engine``, ``engine="mesh"``) every
bucket's subject axis splits into contiguous chunks, one a rank;
:meth:`BucketPlan.balance_for_shards` orders each bucket's members so that
the chunks carry near-equal nonzero counts, and :meth:`BucketPlan.shard_nnz`
and :meth:`BucketPlan.shard_imbalance` report the balance. They build the
reference's plans exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["BucketPlan", "fixed_plan", "plan_buckets", "route_compress", "route_formats",
           "SCOO_DENSITY_THRESHOLD"]

# Density below which the SCOO format takes a bucket under format="auto"
# (the reference's threshold: one SCOO nonzero costs about three stored
# entries and two gathers per contraction against one dense CC cell).
SCOO_DENSITY_THRESHOLD = 0.25


def _shard_capacities(n_members: int, n_shards: int) -> List[int]:
    """Real-subject slots per shard under ``bucketize``'s layout: the bucket
    pads Kb up to a multiple of ``n_shards`` with padding slots at the tail,
    and shard s owns the contiguous slots [s*cs, (s+1)*cs). Every shard
    before the padding holds ``cs`` real subjects; the shard where the
    padding starts holds fewer, and any after it none."""
    cs = -(-n_members // n_shards)            # ceil: padded Kb / n_shards
    return [max(0, min(cs, n_members - s * cs)) for s in range(n_shards)]


def _round_up(x: int, align: int) -> int:
    return max(align, ((int(x) + align - 1) // align) * align)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Assignment of subject indices to padded-shape buckets."""

    shapes: List[tuple]          # [(I_pad, C_pad)] per bucket
    members: List[np.ndarray]    # [int32 arrays of subject ids] per bucket
    # padded nonzero count N_pad per bucket (SCOO layout); None when the
    # plan was built without nnz_counts
    nnz_pads: Optional[List[int]] = None

    @property
    def n_buckets(self) -> int:
        return len(self.shapes)

    def padding_waste(self, row_counts: Sequence[int], col_counts: Sequence[int]) -> float:
        """Fraction of padded cells that are padding (the CC format's cost)."""
        used = 0
        total = 0
        for (ip, cp), mem in zip(self.shapes, self.members):
            for k in mem:
                used += int(row_counts[k]) * int(col_counts[k])
                total += ip * cp
        return 1.0 - used / max(total, 1)

    def bucket_nnz(self, nnz_counts: Sequence[int]) -> List[int]:
        """True nonzero count per bucket."""
        nz = np.asarray(nnz_counts, dtype=np.int64)
        return [int(nz[mem].sum()) for mem in self.members]

    def bucket_densities(self, nnz_counts: Sequence[int]) -> List[float]:
        """Per-bucket density: true nonzeros over the densified CC cell count
        ``n_members * I_pad * C_pad``."""
        return [
            nnz / max(len(mem) * ip * cp, 1)
            for (ip, cp), mem, nnz in zip(
                self.shapes, self.members, self.bucket_nnz(nnz_counts))
        ]

    def nnz_waste(self, nnz_counts: Sequence[int]) -> float:
        """Fraction of padded SCOO entries that are padding (needs a plan
        built with ``nnz_counts``, so that ``nnz_pads`` is set)."""
        if self.nnz_pads is None:
            raise ValueError("plan has no nnz_pads; pass nnz_counts to "
                             "plan_buckets to plan the SCOO layout")
        used = sum(self.bucket_nnz(nnz_counts))
        total = sum(npad * len(mem) for npad, mem in zip(self.nnz_pads, self.members))
        return 1.0 - used / max(total, 1)

    def balance_for_shards(self, nnz_counts: Sequence[int],
                           n_shards: int) -> "BucketPlan":
        """Reorder every bucket's members so that its ``n_shards`` contiguous
        subject chunks carry near-equal nonzero counts, not equal subject
        counts: the quantile planner sorts members by size, which would put
        every heavy subject on the last shards.

        Capacity-constrained greedy LPT: subjects by nnz descending (stable,
        so equal counts keep member order), each to the least-loaded shard
        with a free slot (ties to the lowest index); the capacities are
        :func:`_shard_capacities`', so the shard holding the tail padding
        gets the fewest slots. Shapes and pad targets are untouched: only the
        order within each bucket moves."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards == 1:
            return self
        nz = np.asarray(nnz_counts, dtype=np.int64)
        new_members = []
        for mem in self.members:
            caps = _shard_capacities(len(mem), n_shards)
            loads = [0] * n_shards
            bins: List[list] = [[] for _ in range(n_shards)]
            for k in mem[np.argsort(-nz[mem], kind="stable")]:
                s = min((s for s in range(n_shards) if len(bins[s]) < caps[s]),
                        key=lambda s: (loads[s], s))
                bins[s].append(k)
                loads[s] += int(nz[k])
            new_members.append(
                np.concatenate([np.asarray(b, dtype=np.int32) for b in bins if b])
                if len(mem) else mem)
        return dataclasses.replace(self, members=new_members)

    def shard_nnz(self, nnz_counts: Sequence[int], n_shards: int) -> List[List[int]]:
        """Per bucket, the true nonzero count of each shard's contiguous
        chunk (tail padding): the balance :meth:`balance_for_shards`
        optimizes."""
        nz = np.asarray(nnz_counts, dtype=np.int64)
        out = []
        for mem in self.members:
            loads, lo = [], 0
            for c in _shard_capacities(len(mem), n_shards):
                loads.append(int(nz[mem[lo:lo + c]].sum()))
                lo += c
            out.append(loads)
        return out

    def shard_imbalance(self, nnz_counts: Sequence[int], n_shards: int) -> float:
        """max / mean of the shards' nonzero counts over all buckets together
        (1.0 = balanced; the straggler factor an unbalanced plan pays)."""
        per_bucket = self.shard_nnz(nnz_counts, n_shards)
        totals = [sum(b[s] for b in per_bucket) for s in range(n_shards)]
        mean = sum(totals) / max(len(totals), 1)
        return max(totals) / mean if mean > 0 else 1.0

    def stats(self, row_counts: Sequence[int], col_counts: Sequence[int],
              nnz_counts: Sequence[int],
              formats: Optional[Sequence[str]] = None) -> List[dict]:
        """Per-bucket records (shape, members, nnz, density, chosen format) —
        what ``decompose --json`` reports."""
        out = []
        nnzs = self.bucket_nnz(nnz_counts)
        dens = self.bucket_densities(nnz_counts)
        for i, ((ip, cp), mem) in enumerate(zip(self.shapes, self.members)):
            rec = {
                "i_pad": ip, "c_pad": cp, "n_subjects": len(mem),
                "nnz": nnzs[i], "density": dens[i],
            }
            if self.nnz_pads is not None:
                rec["nnz_pad"] = self.nnz_pads[i]
            if formats is not None:
                rec["format"] = formats[i]
            out.append(rec)
        return out


def plan_buckets(
    row_counts: Sequence[int],
    col_counts: Sequence[int],
    *,
    max_buckets: int = 4,
    row_align: int = 8,
    col_align: int = 128,
    nnz_counts: Optional[Sequence[int]] = None,
    nnz_align: int = 8,
    sort_by: str = "area",
) -> BucketPlan:
    """Greedy quantile bucketing on (I_k, c_k[, nnz_k]).

    Sort subjects by padded cost (``"area"`` = I_k * c_k, or ``"nnz"``) and
    split them into ``max_buckets`` contiguous groups of roughly equal count;
    each bucket pads to its member maximum, and buckets that end up with one
    shape merge. With ``nnz_counts`` every bucket also gets its pad target
    ``N_pad = round_up(max member nnz, nnz_align)`` in ``plan.nnz_pads``.
    """
    rc = np.asarray(row_counts, dtype=np.int64)
    cc = np.asarray(col_counts, dtype=np.int64)
    if rc.shape != cc.shape or rc.ndim != 1 or rc.size == 0:
        raise ValueError("row_counts/col_counts must be equal-length 1-D, non-empty")
    nz = None
    if nnz_counts is not None:
        nz = np.asarray(nnz_counts, dtype=np.int64)
        if nz.shape != rc.shape:
            raise ValueError("nnz_counts must match row_counts in length")
    if sort_by == "area":
        key = rc * cc
    elif sort_by == "nnz":
        if nz is None:
            raise ValueError("sort_by='nnz' needs nnz_counts")
        key = nz
    else:
        raise ValueError(f"unknown sort_by {sort_by!r}; choose 'area' or 'nnz'")
    order = np.argsort(key, kind="stable")
    splits = np.array_split(order, int(min(max_buckets, rc.size)))
    merged: dict = {}
    for grp in splits:
        if grp.size == 0:
            continue
        shape = (_round_up(int(rc[grp].max()), row_align),
                 _round_up(int(cc[grp].max()), col_align))
        grp = grp.astype(np.int32)
        merged[shape] = np.concatenate([merged[shape], grp]) if shape in merged else grp
    shapes = list(merged.keys())
    members = [merged[s] for s in shapes]
    nnz_pads = None
    if nz is not None:
        nnz_pads = [_round_up(int(nz[mem].max()), nnz_align) for mem in members]
    return BucketPlan(shapes=shapes, members=members, nnz_pads=nnz_pads)


def fixed_plan(n_subjects: int, i_pad: int, c_pad: int, *,
               nnz_pad: Optional[int] = None) -> BucketPlan:
    """A one-bucket plan with an explicit padded geometry: members
    ``0..n_subjects-1`` in one ``(I_pad, C_pad[, N_pad])`` rectangle.
    ``bucketize`` raises if a subject has more nonzeros than ``nnz_pad``;
    row and column overflow are the caller's to check."""
    if n_subjects < 1 or i_pad < 1 or c_pad < 1:
        raise ValueError("fixed_plan needs n_subjects, i_pad, c_pad >= 1")
    return BucketPlan(
        shapes=[(int(i_pad), int(c_pad))],
        members=[np.arange(n_subjects, dtype=np.int32)],
        nnz_pads=None if nnz_pad is None else [int(nnz_pad)],
    )


def route_formats(plan: BucketPlan, nnz_counts: Sequence[int], *,
                  format: str = "auto",
                  density_threshold: float = SCOO_DENSITY_THRESHOLD) -> List[str]:
    """Per-bucket device format for ``bucketize``: ``"cc"`` and ``"scoo"``
    force every bucket; ``"auto"`` sends a bucket whose density is below
    ``density_threshold`` to SCOO and the others to CC."""
    if format in ("cc", "scoo"):
        return [format] * plan.n_buckets
    if format != "auto":
        raise ValueError(f"unknown format {format!r}; choose from 'cc', 'scoo', 'auto'")
    return ["scoo" if d < density_threshold else "cc"
            for d in plan.bucket_densities(nnz_counts)]


def route_compress(shapes, sketch_dim: int) -> List[bool]:
    """Per-bucket decision of the rsvd preprocessing stage
    (:mod:`repro_torch.core.compress`): compress a bucket only when its
    padded row space exceeds the sketch width; otherwise its core would be
    as large as the data and the pass pure overhead.

    ``shapes`` is a list of ``(i_pad, c_pad)`` pairs (``BucketPlan.shapes``
    or the buckets' padded shapes) or a :class:`BucketPlan`; one bool per
    bucket."""
    if isinstance(shapes, BucketPlan):
        shapes = shapes.shapes
    if sketch_dim < 1:
        raise ValueError(f"sketch_dim must be >= 1, got {sketch_dim}")
    return [int(ip) > int(sketch_dim) for ip, _ in shapes]
