"""Streaming incremental PARAFAC2 service (``repro.launch.stream``), on a GPU
by default.

Every fit elsewhere is a batch job over a frozen dataset; the paper's target
workload (EHR phenotyping over a growing population) is append-only: new
subjects arrive, existing subjects accrue observations. A
:class:`StreamService` warm-starts from a fitted ``(H, V, W)`` and serves
*append* requests with the factor matrices fixed: each new or touched
subject needs only its own Procrustes basis ``Q_k`` and W row, both
independent across subjects, so requests batch into one padded dispatch
(:func:`repro_torch.core.parafac2.update_subjects` through
:func:`repro_torch.core.engine.make_subject_update`):

    request queue -> padded subject batch (pinned geometry,
    ``repro_torch.sparse.bucketing.fixed_plan``) -> one dispatch on the
    device -> per-request W rows + residuals + latency stats.

H and V live on the device; W and the per-subject residual ledger on the
host, as numpy arrays. ``stream_fit`` is the exact fit of the union dataset
at the current factors (old subjects' residuals do not change while H and V
are fixed); ``drift`` is how far it has fallen below the fit at the last
(re)fit, and past ``drift_threshold`` the service refits over the union
through ``opts.engine``, from the current factors (``refit="warm"``) or from
the seeded init (``refit="cold"``, bit for bit a batch fit over the same
data). ``repro_torch.checkpoint`` persists the service's state.

``smooth_lam > 0`` anchors a touched subject's streamed W row to its
previous row by ``lam * ||w - w_prev||^2`` (tPARAFAC2), folded into the
row's normal equations, so it composes with any W constraint.

CLI:

  PYTHONPATH=src python -m repro_torch.launch.stream --dataset choa \\
      --scale 0.25 --rank 5 --warm-iters 20 --warm-frac 0.6 \\
      --batch-slots 8 --limit 4096 [--device cpu] [--json out.json]

``--appends FILE.jsonl`` replays append payloads from a file (one JSON
object per line: ``rows``/``cols``/``vals`` [+ ``n_rows``, + ``subject``
for accrual onto an existing id]); malformed payloads fail fast with
``ValueError``. ``--json`` writes the latency / throughput / drift summary
with the reference's keys (``platform`` is the torch device type).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import Parafac2Options, bucketize, fit, update_subjects
from repro_torch.core import parafac2 as p2
from repro_torch.core.constraints import (available as available_constraints,
                                          constraint_summary, parse_constraint_arg)
from repro_torch.core.engine import make_subject_update
from repro_torch.core.irregular import Bucketed
from repro_torch.device import resolve_device
from repro_torch.launch.summary import resolved_options, run_summary
from repro_torch.sparse import (IrregularCOO, SubjectCOO, fixed_plan, plan_buckets,
                                route_formats)
from repro_torch.sparse.bucketing import SCOO_DENSITY_THRESHOLD

__all__ = ["AppendResult", "StreamService", "synthetic_stream", "validate_payload",
           "main"]


def _ceil_to(x: int, align: int) -> int:
    return max(align, ((int(x) + align - 1) // align) * align)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


# ---------------------------------------------------------------------------
# append payloads
# ---------------------------------------------------------------------------

def validate_payload(payload: Any, n_cols: int,
                     n_known: int) -> Tuple[Optional[int], SubjectCOO]:
    """Fail-fast validation of one append payload.

    A payload is a mapping with equal-length ``rows``/``cols``/``vals``
    observation triplets (local row ids within the appended block), an
    optional ``n_rows`` (defaults to ``max(rows) + 1``), and an optional
    ``subject`` id: present, the block accrues onto that existing subject;
    absent, it is a new subject. Returns ``(subject_id_or_None, block)``;
    raises ``ValueError`` naming the first problem found.
    """
    if not isinstance(payload, dict):
        raise ValueError(f"append payload must be a mapping, got "
                         f"{type(payload).__name__}")
    for key in ("rows", "cols", "vals"):
        if key not in payload:
            raise ValueError(f"append payload missing required key {key!r}")
    try:
        rows = np.asarray(payload["rows"], dtype=np.int64)
        cols = np.asarray(payload["cols"], dtype=np.int64)
        vals = np.asarray(payload["vals"], dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise ValueError(f"append payload triplets not numeric: {e}") from None
    if not (rows.ndim == cols.ndim == vals.ndim == 1):
        raise ValueError("append payload rows/cols/vals must be 1-D lists")
    if not (rows.size == cols.size == vals.size):
        raise ValueError(
            f"append payload triplet lengths differ: rows={rows.size} "
            f"cols={cols.size} vals={vals.size}")
    if rows.size == 0:
        raise ValueError("append payload has no observations")
    if rows.min() < 0:
        raise ValueError("append payload has negative row indices")
    if cols.min() < 0 or cols.max() >= n_cols:
        raise ValueError(
            f"append payload column ids must be in [0, {n_cols}), got "
            f"[{cols.min()}, {cols.max()}]")
    if not np.all(np.isfinite(vals)):
        raise ValueError("append payload values must be finite")
    n_rows = payload.get("n_rows", int(rows.max()) + 1)
    if not isinstance(n_rows, (int, np.integer)) or n_rows < int(rows.max()) + 1:
        raise ValueError(
            f"append payload n_rows={n_rows!r} inconsistent with max row "
            f"index {int(rows.max())}")
    sid = payload.get("subject")
    if sid is not None:
        if not isinstance(sid, (int, np.integer)):
            raise ValueError(f"append payload subject id must be an int, "
                             f"got {sid!r}")
        if not 0 <= sid < n_known:
            raise ValueError(
                f"append payload subject id {sid} unknown "
                f"(service knows {n_known} subjects)")
    block = SubjectCOO(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                       vals=vals, n_rows=int(n_rows), n_cols=n_cols)
    return (None if sid is None else int(sid)), block


def _merge_block(base: SubjectCOO, block: SubjectCOO) -> SubjectCOO:
    """Accrue an observation block onto an existing slice: block rows are
    local to the block, appended after the existing observation rows."""
    off = base.n_rows
    return SubjectCOO(
        rows=np.concatenate([base.rows, block.rows + off]).astype(np.int32),
        cols=np.concatenate([base.cols, block.cols]).astype(np.int32),
        vals=np.concatenate([base.vals, block.vals]),
        n_rows=base.n_rows + block.n_rows,
        n_cols=base.n_cols)


@dataclasses.dataclass(frozen=True)
class AppendResult:
    """Per-request serving result (one element of a flushed batch)."""

    request_id: int
    subject_id: int
    is_new: bool
    latency_s: float     # wall time of the batch this request rode in
    batch_size: int      # real requests in that batch (before padding)
    resid: float         # ||X_k - Q_k H S_k V^T||_F^2 at the returned row
    w_row: np.ndarray    # the subject's updated W row [R]


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

# a served model answers from one process; refits across ranks need a design
# of their own
MESH_WAITS = ("the stream service answers from one process: its refits under "
              "engine='mesh' wait for their own design (ROADMAP A6, what is left); "
              "use 'host' or 'scan'")


class StreamService:
    """Batched incremental PARAFAC2 serving over a warm-started model.

    Build it by :meth:`warm_start` (fit the initial population) or
    :meth:`from_checkpoint` (restore a saved service state). ``submit``
    queues validated requests; ``flush`` drains the queue in padded
    ``batch_slots``-sized dispatches; ``append`` is submit + flush for one
    request. Drift-triggered refits happen inside ``flush``. ``device`` is
    where H, V and the request batches live (a GPU unless ``"cpu"``).
    ``stage_latencies`` holds each dispatch's host staging seconds (merge,
    plan, bucketize and upload), a part of its ``batch_latencies``;
    ``adopt_latencies`` each ``_adopt`` pass's seconds over the union.
    """

    def __init__(self, subjects: Sequence[SubjectCOO], n_cols: int,
                 opts: Parafac2Options, H, V, W, *,
                 batch_slots: int = 8,
                 drift_threshold: float = 0.05,
                 refit: str = "warm",
                 refit_iters: int = 50,
                 refit_tol: float = 1e-7,
                 smooth_lam: float = 0.0,
                 inner_iters: int = 2,
                 format: str = "auto",
                 max_buckets: int = 4,
                 row_align: int = 8,
                 col_align: int = 8,
                 nnz_align: int = 32,
                 seed: int = 0,
                 device="cuda"):
        if opts.engine == "mesh":
            raise NotImplementedError(MESH_WAITS)
        if opts.w_layout != "global":
            raise ValueError("StreamService needs w_layout='global' (streamed "
                             "W rows are indexed by global subject id)")
        if refit not in ("warm", "cold"):
            raise ValueError(f"refit must be 'warm' or 'cold', got {refit!r}")
        if format not in ("cc", "scoo", "auto"):
            raise ValueError(f"unknown stream format {format!r}")
        if batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        self.opts = opts
        self.device = resolve_device(device)
        self.n_cols = int(n_cols)
        self.subjects: List[SubjectCOO] = list(subjects)
        self.H = torch.as_tensor(H, dtype=opts.dtype).to(self.device)
        self.V = torch.as_tensor(V, dtype=opts.dtype).to(self.device)
        self.W = np.asarray(W, dtype=_np_dtype(opts.dtype))
        self.batch_slots = int(batch_slots)
        self.drift_threshold = float(drift_threshold)
        self.refit_mode = refit
        self.refit_iters = int(refit_iters)
        self.refit_tol = float(refit_tol)
        self.smooth_lam = float(smooth_lam)
        self.inner_iters = int(inner_iters)
        self.fmt = format
        self.max_buckets = int(max_buckets)
        self.row_align = int(row_align)
        self.col_align = int(col_align)
        self.nnz_align = int(nnz_align)
        self.seed = int(seed)

        # per-subject residual/norm ledger: stream_fit stays the exact union
        # fit because H/V are fixed between refits
        self._sub_norm = np.asarray(
            [float(np.sum(np.square(s.vals, dtype=np.float64))) for s in self.subjects],
            dtype=np.float64)
        self._sub_resid = np.zeros(len(self.subjects), dtype=np.float64)
        self.baseline_fit = float("nan")

        # sticky padded batch geometry (grows monotonically; each distinct
        # (geometry, format, slots) is one pinned dispatch shape)
        self._i_pad = self.row_align
        self._c_pad = self.col_align
        self._n_pad = self.nnz_align
        self._geometries: set = set()

        self._update = make_subject_update(opts, smooth_lam=self.smooth_lam,
                                           inner_iters=self.inner_iters)

        self._queue: List[Tuple[int, Optional[int], SubjectCOO]] = []
        self._next_request = 0
        self.latencies: List[float] = []
        self.batch_latencies: List[float] = []
        self.stage_latencies: List[float] = []
        self.adopt_latencies: List[float] = []
        self.n_appends = 0
        self.n_batches = 0
        self.n_new = 0
        self.n_touched = 0
        self.refit_at: List[int] = []
        self.drift_max = 0.0

    # -- constructors --------------------------------------------------------

    @classmethod
    def _blank(cls, data: IrregularCOO, opts: Parafac2Options, **kw) -> "StreamService":
        return cls(data.subjects, data.n_cols, opts, H=torch.eye(opts.rank),
                   V=torch.zeros((data.n_cols, opts.rank)),
                   W=np.ones((data.n_subjects, opts.rank)), **kw)

    @classmethod
    def warm_start(cls, data: IrregularCOO, opts: Parafac2Options, *,
                   iters: int = 50, tol: float = 1e-7, seed: int = 0,
                   verbose: bool = False, **kw) -> Tuple["StreamService", dict]:
        """Fit the initial population in batch, then serve appends on top.
        Returns ``(service, warm_info)`` with the warm fit's stats."""
        svc = cls._blank(data, opts, seed=seed, **kw)
        t0 = time.perf_counter()
        bt = svc._bucketize_union(svc.union_data())
        state, hist = fit(bt, opts, max_iters=iters, tol=tol, seed=seed, verbose=verbose)
        svc._adopt(bt, state.H, state.V, state.W)
        info = {"fit": float(hist[-1]), "iters": len(hist),
                "seconds": time.perf_counter() - t0,
                "n_subjects": data.n_subjects, "baseline_fit": svc.baseline_fit}
        return svc, info

    @classmethod
    def from_checkpoint(cls, directory: str, data: IrregularCOO,
                        opts: Parafac2Options, **kw) -> "StreamService":
        """Restore a saved service state (H/V/W and the residual ledger) over
        the matching union dataset: the resume path of a service process
        that died mid-stream."""
        svc = cls._blank(data, opts, **kw)
        tree, _, extra = ckpt.restore(directory, svc._tree())
        if int(extra.get("n_subjects", data.n_subjects)) != data.n_subjects:
            raise ValueError(
                f"checkpoint was written with {extra.get('n_subjects')} "
                f"subjects but the supplied union dataset has "
                f"{data.n_subjects}")
        svc.H, svc.V, svc.W = tree["H"], tree["V"], tree["W"]
        svc._sub_norm, svc._sub_resid = tree["sub_norm"], tree["sub_resid"]
        svc.baseline_fit = float(extra.get("baseline_fit", float("nan")))
        svc.n_appends = int(extra.get("n_appends", 0))
        svc._i_pad = int(extra.get("i_pad", svc._i_pad))
        svc._c_pad = int(extra.get("c_pad", svc._c_pad))
        svc._n_pad = int(extra.get("n_pad", svc._n_pad))
        return svc

    def _tree(self) -> dict:
        """The checkpointed state, under the reference's keys."""
        return {"H": self.H, "V": self.V, "W": self.W, "sub_norm": self._sub_norm,
                "sub_resid": self._sub_resid}

    def save(self, directory: str) -> str:
        """Persist the state through ``repro_torch.checkpoint`` (atomic,
        step-stamped by the append count)."""
        return ckpt.save(directory, self.n_appends, self._tree(), extra={
            "baseline_fit": self.baseline_fit,
            "n_subjects": len(self.subjects),
            "n_appends": self.n_appends,
            # the sticky batch geometry: restoring it makes the resumed
            # service dispatch the uninterrupted one's batches bit for bit
            "i_pad": self._i_pad, "c_pad": self._c_pad, "n_pad": self._n_pad,
        })

    # -- model/fit bookkeeping ----------------------------------------------

    def union_data(self) -> IrregularCOO:
        """The accumulated dataset: warm subjects + every streamed append."""
        return IrregularCOO(subjects=list(self.subjects), n_cols=self.n_cols)

    def _bucketize_union(self, data: IrregularCOO) -> Bucketed:
        """The batch path's bucketization for warm fits and refits: what
        ``launch/decompose.py`` builds for the same data and format, which
        makes a cold refit a batch fit bit for bit."""
        rc, ccnt, nnzc = data.row_counts(), data.col_counts(), data.nnz_counts()
        plan = plan_buckets(rc, ccnt, max_buckets=self.max_buckets, nnz_counts=nnzc,
                            sort_by="nnz" if self.fmt == "scoo" else "area")
        fmts = route_formats(plan, nnzc, format=self.fmt)
        return bucketize(data, dtype=self.opts.dtype, device=self.device, plan=plan,
                         formats=fmts)

    def _adopt(self, bt: Bucketed, H, V, W) -> None:
        """Install new factors and rebuild the residual ledger: one
        ``update_subjects`` pass over the whole union re-solves every
        subject's (Q_k, w_k) at the new factors."""
        t0 = time.perf_counter()
        self.H = torch.as_tensor(H, dtype=self.opts.dtype).to(self.device)
        self.V = torch.as_tensor(V, dtype=self.opts.dtype).to(self.device)
        w0 = torch.as_tensor(W, dtype=self.opts.dtype).to(self.device)
        W_new, resid = update_subjects(bt, self.H, self.V, self.opts, w_init=w0,
                                       inner_iters=1)
        self.W = W_new.cpu().numpy().copy()   # a writable host copy (rows change)
        self._sub_resid = np.maximum(resid.cpu().numpy().astype(np.float64), 0.0)
        self.baseline_fit = self.stream_fit
        self.adopt_latencies.append(time.perf_counter() - t0)

    @property
    def stream_fit(self) -> float:
        """Exact fit of the union dataset at the current factors (each
        subject at its last-solved ``(Q_k, w_k)``)."""
        total = float(self._sub_norm.sum())
        if total <= 0.0:
            return 1.0
        resid = max(float(self._sub_resid.sum()), 0.0)
        return 1.0 - float(np.sqrt(resid / total))

    @property
    def drift(self) -> float:
        """How far the streamed model has fallen below the last (re)fit."""
        return max(0.0, self.baseline_fit - self.stream_fit)

    def refit(self, *, mode: Optional[str] = None) -> dict:
        """Full ALS refit over the union dataset through ``opts.engine``:
        ``mode="warm"`` from the current ``(H, V, W)``, ``mode="cold"`` from
        the seeded init, bit for bit a batch ``fit`` over the same data."""
        mode = self.refit_mode if mode is None else mode
        t0 = time.perf_counter()
        bt = self._bucketize_union(self.union_data())
        state0 = None
        if mode == "warm":
            state0 = dataclasses.replace(
                p2.init_state(bt, self.opts, self.seed), H=self.H, V=self.V,
                W=torch.as_tensor(self.W, dtype=self.opts.dtype).to(self.device))
        state, hist = fit(bt, self.opts, max_iters=self.refit_iters, tol=self.refit_tol,
                          seed=self.seed, state=state0)
        self._adopt(bt, state.H, state.V, state.W)
        self.refit_at.append(self.n_appends)
        return {"mode": mode, "iters": len(hist), "fit": float(hist[-1]),
                "baseline_fit": self.baseline_fit,
                "seconds": time.perf_counter() - t0,
                "n_subjects": len(self.subjects)}

    # -- the serving loop ----------------------------------------------------

    def submit(self, payload: dict) -> int:
        """Validate (fail fast) and queue one append request; returns its
        request id. Nothing reaches the device until ``flush``."""
        sid, block = validate_payload(payload, self.n_cols, len(self.subjects))
        rid = self._next_request
        self._next_request += 1
        self._queue.append((rid, sid, block))
        return rid

    def append(self, payload: dict) -> AppendResult:
        """submit + flush for a single request (the one-at-a-time API)."""
        self.submit(payload)
        return self.flush()[-1]

    def flush(self) -> List[AppendResult]:
        """Drain the queue in ``batch_slots``-sized padded dispatches; runs
        the drift check (and any triggered refit) after each batch."""
        results: List[AppendResult] = []
        while self._queue:
            chunk, self._queue = (self._queue[: self.batch_slots],
                                  self._queue[self.batch_slots:])
            results.extend(self._dispatch(chunk))
            self.drift_max = max(self.drift_max, self.drift)
            if self.drift > self.drift_threshold:
                self.refit()
        return results

    def _batch_geometry(self, slices: Sequence[SubjectCOO]) -> Tuple[int, int, int]:
        """Grow the sticky padded geometry to cover this batch."""
        need_i = max(s.n_rows for s in slices)
        need_c = max(s.nonzero_cols().size for s in slices)
        need_n = max(max(s.nnz, 1) for s in slices)
        self._i_pad = max(self._i_pad, _ceil_to(need_i, self.row_align))
        self._c_pad = max(self._c_pad, _ceil_to(need_c, self.col_align))
        self._n_pad = max(self._n_pad, _ceil_to(need_n, self.nnz_align))
        return self._i_pad, self._c_pad, self._n_pad

    def _batch_format(self, slices: Sequence[SubjectCOO], i_pad: int, c_pad: int) -> str:
        if self.fmt in ("cc", "scoo"):
            return self.fmt
        dens = sum(s.nnz for s in slices) / max(len(slices) * i_pad * c_pad, 1)
        return "scoo" if dens < SCOO_DENSITY_THRESHOLD else "cc"

    def _dispatch(self, chunk: Sequence[Tuple[int, Optional[int], SubjectCOO]]
                  ) -> List[AppendResult]:
        """One padded batch: stage on the host -> update on the device ->
        commit on the host."""
        t0 = time.perf_counter()
        R = self.opts.rank
        merged: List[SubjectCOO] = []
        metas: List[Tuple[int, Optional[int], bool]] = []
        for rid, sid, block in chunk:
            if sid is None:
                merged.append(block)
                metas.append((rid, None, True))
            else:
                merged.append(_merge_block(self.subjects[sid], block))
                metas.append((rid, sid, False))

        i_pad, c_pad, n_pad = self._batch_geometry(merged)
        fmt = self._batch_format(merged, i_pad, c_pad)
        # subject_align pads every batch to a multiple of batch_slots, so a
        # short final batch keeps the full batch's shapes
        self._geometries.add((i_pad, c_pad, n_pad, fmt,
                              _ceil_to(len(merged), self.batch_slots)))
        plan = fixed_plan(len(merged), i_pad, c_pad,
                          nnz_pad=n_pad if fmt == "scoo" else None)
        batch = bucketize(IrregularCOO(subjects=merged, n_cols=self.n_cols), plan=plan,
                          formats=[fmt], subject_align=self.batch_slots,
                          dtype=self.opts.dtype, device=self.device)
        batch = Bucketed(buckets=batch.buckets, n_subjects=self.batch_slots,
                         n_cols=self.n_cols, norm_sq=0.0)

        np_dt = _np_dtype(self.opts.dtype)
        w_init = np.ones((self.batch_slots, R), np_dt)
        w_prev = np.zeros((self.batch_slots, R), np_dt)
        pmask = np.zeros((self.batch_slots,), np_dt)
        for slot, (_, sid, is_new) in enumerate(metas):
            if not is_new:
                w_init[slot] = self.W[sid]
                w_prev[slot] = self.W[sid]
                pmask[slot] = 1.0

        def up(a):
            return torch.from_numpy(a).to(self.device)

        w_init, w_prev, pmask = up(w_init), up(w_prev), up(pmask)
        t_staged = time.perf_counter()
        W_rows, resid = self._update(batch, self.H, self.V, w_init, w_prev, pmask)
        W_rows = W_rows.cpu().numpy()          # the dispatch's one device sync
        resid = resid.cpu().numpy()
        latency = time.perf_counter() - t0

        # commit the host state per request
        out: List[AppendResult] = []
        for slot, ((rid, sid, is_new), slice_) in enumerate(zip(metas, merged)):
            norm = float(np.sum(np.square(slice_.vals, dtype=np.float64)))
            r = max(float(resid[slot]), 0.0)
            if is_new:
                sid = len(self.subjects)
                self.subjects.append(slice_)
                self.W = np.vstack([self.W, W_rows[slot][None]])
                self._sub_norm = np.append(self._sub_norm, norm)
                self._sub_resid = np.append(self._sub_resid, r)
                self.n_new += 1
            else:
                self.subjects[sid] = slice_
                self.W[sid] = W_rows[slot]
                self._sub_norm[sid] = norm
                self._sub_resid[sid] = r
                self.n_touched += 1
            self.n_appends += 1
            self.latencies.append(latency)
            out.append(AppendResult(
                request_id=rid, subject_id=sid, is_new=is_new, latency_s=latency,
                batch_size=len(chunk), resid=r, w_row=W_rows[slot].copy()))
        self.batch_latencies.append(latency)
        self.stage_latencies.append(t_staged - t0)
        self.n_batches += 1
        return out

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        """Machine-readable serving stats (the ``--json`` payload's core)."""
        lat = np.asarray(self.latencies, dtype=np.float64)
        lat_ms: Dict[str, float] = {}
        if lat.size:
            lat_ms = {"p50": float(np.percentile(lat, 50) * 1e3),
                      "p99": float(np.percentile(lat, 99) * 1e3),
                      "mean": float(lat.mean() * 1e3),
                      "max": float(lat.max() * 1e3)}
        # every request's latency is its batch's wall time, so throughput
        # divides by the sum over batches, not over requests
        busy = float(np.sum(self.batch_latencies))
        subjects_per_s = (self.n_appends / busy) if busy > 0 else 0.0
        return {
            "appends": self.n_appends, "batches": self.n_batches,
            "new": self.n_new, "touched": self.n_touched,
            "batch_slots": self.batch_slots,
            "latency_ms": lat_ms,
            "subjects_per_s": subjects_per_s,
            "stream_fit": self.stream_fit,
            "baseline_fit": self.baseline_fit,
            "drift": self.drift, "drift_max": self.drift_max,
            "drift_threshold": self.drift_threshold,
            "refits": len(self.refit_at), "refit_at": list(self.refit_at),
            "compiled_geometries": len(self._geometries),
            "n_subjects": len(self.subjects),
            "format": self.fmt, "smooth_lam": self.smooth_lam,
            "inner_iters": self.inner_iters,
        }


# ---------------------------------------------------------------------------
# synthetic stream construction (the command line, tests)
# ---------------------------------------------------------------------------

def synthetic_stream(data: IrregularCOO, *, warm_frac: float = 0.6,
                     touch_frac: float = 0.2, holdout_frac: float = 0.4,
                     seed: int = 0) -> Tuple[IrregularCOO, List[dict]]:
    """Split a dataset into a warm population + an append stream.

    The first ``warm_frac`` of subjects form the warm population; the rest
    arrive as new-subject payloads. A ``touch_frac`` share of warm subjects
    hold out their last ``holdout_frac`` observation rows, which arrive
    later as accrual payloads onto the existing id, so the union of the
    warm data and the replayed payloads is exactly the original dataset.
    The reference's numpy draws, so its payloads for a seed are these.
    """
    K = data.n_subjects
    n_warm = min(K, max(1, int(round(K * warm_frac))))
    rng = np.random.default_rng(seed)
    warm: List[SubjectCOO] = []
    payloads: List[dict] = []
    for i, s in enumerate(data.subjects[:n_warm]):
        split = max(1, int(round(s.n_rows * (1.0 - holdout_frac))))
        held = s.rows >= split
        if (s.n_rows >= 4 and rng.random() < touch_frac
                and held.any() and (~held).any()):
            warm.append(SubjectCOO(
                rows=s.rows[~held], cols=s.cols[~held], vals=s.vals[~held],
                n_rows=split, n_cols=s.n_cols))
            payloads.append({
                "subject": i,
                "rows": (s.rows[held] - split).tolist(),
                "cols": s.cols[held].tolist(),
                "vals": s.vals[held].tolist(),
                "n_rows": s.n_rows - split,
            })
        else:
            warm.append(s)
    for s in data.subjects[n_warm:]:
        payloads.append({"rows": s.rows.tolist(), "cols": s.cols.tolist(),
                         "vals": s.vals.tolist(), "n_rows": s.n_rows})
    order = rng.permutation(len(payloads))
    return (IrregularCOO(subjects=warm, n_cols=data.n_cols),
            [payloads[i] for i in order])


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def main(argv=None) -> dict:
    from repro_torch.launch.decompose import load_dataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="synthetic",
                    choices=["choa", "movielens", "synthetic"])
    ap.add_argument("--scale", type=float, default=0.003)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--warm-iters", type=int, default=20,
                    help="batch ALS iterations for the warm-start fit")
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--warm-frac", type=float, default=0.6,
                    help="fraction of subjects in the warm population")
    ap.add_argument("--touch-frac", type=float, default=0.2,
                    help="fraction of warm subjects that later accrue "
                         "held-out observations")
    ap.add_argument("--appends", default="", metavar="FILE.jsonl",
                    help="replay append payloads from this JSONL file "
                         "instead of the synthetic stream (fail-fast on "
                         "malformed payloads)")
    ap.add_argument("--limit", type=int, default=0,
                    help="stream at most this many appends (0 = all)")
    ap.add_argument("--batch-slots", type=int, default=8,
                    help="requests per padded dispatch (the serving batch)")
    ap.add_argument("--drift-threshold", type=float, default=0.05,
                    help="fit drift that triggers a full refit")
    ap.add_argument("--refit", default="warm", choices=["warm", "cold"],
                    help="refit start: warm (current factors) or cold "
                         "(seeded init, bit for bit a batch fit)")
    ap.add_argument("--refit-iters", type=int, default=50)
    ap.add_argument("--smooth", type=float, default=0.0, metavar="LAM",
                    help="tPARAFAC2 temporal anchor on touched subjects' "
                         "streamed W rows: lam * ||w - w_prev||^2")
    ap.add_argument("--inner-iters", type=int, default=2,
                    help="Q <-> w alternations per streamed subject")
    ap.add_argument("--constraint", default="", metavar="SPECS",
                    help="per-mode factor constraints (as in decompose); "
                         f"registered: {', '.join(available_constraints())}")
    ap.add_argument("--backend", default="auto",
                    choices=["torch", "scoo", "fused", "staged", "auto"])
    ap.add_argument("--format", default="auto", choices=["cc", "scoo", "auto"])
    ap.add_argument("--engine", default="host", choices=["host", "scan", "mesh"],
                    help="engine for the warm fit and refits (mesh raises: the "
                         "service answers from one process)")
    ap.add_argument("--check-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="",
                    help="save the final service state here (the checkpoint layout)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the machine-readable latency/throughput/"
                         "drift summary to PATH")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    specs = parse_constraint_arg(args.constraint) if args.constraint else {
        "v": "nonneg", "w": "nonneg"}
    device = resolve_device(args.device)
    opts = Parafac2Options(rank=args.rank, constraints=specs, backend=args.backend,
                           engine=args.engine, check_every=args.check_every)

    data = load_dataset(args.dataset, args.scale, args.seed)
    warm, payloads = synthetic_stream(data, warm_frac=args.warm_frac,
                                      touch_frac=args.touch_frac, seed=args.seed)
    if args.appends:
        with open(args.appends) as f:
            payloads = []
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    payloads.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ValueError(f"{args.appends}:{ln}: not valid JSON: {e}") from None
    if args.limit:
        payloads = payloads[: args.limit]

    print(f"[stream] warm population K={warm.n_subjects} J={warm.n_cols} "
          f"nnz={warm.nnz}; {len(payloads)} appends queued")
    print(f"[constraints] {constraint_summary(specs)}")
    svc, warm_info = StreamService.warm_start(
        warm, opts, iters=args.warm_iters, tol=args.tol, seed=args.seed,
        batch_slots=args.batch_slots, drift_threshold=args.drift_threshold,
        refit=args.refit, refit_iters=args.refit_iters, smooth_lam=args.smooth,
        inner_iters=args.inner_iters, format=args.format, device=device)
    print(f"[warm] fit={warm_info['fit']:.4f} in {warm_info['iters']} iters "
          f"({warm_info['seconds']:.1f}s)")

    t0 = time.perf_counter()
    for payload in payloads:
        svc.submit(payload)   # fail-fast validation happens here
        if len(svc._queue) >= args.batch_slots:
            svc.flush()
    svc.flush()
    stream_s = time.perf_counter() - t0

    st = svc.stats()
    st["subjects_per_s_wall"] = st["appends"] / stream_s if stream_s > 0 else 0.0
    if st["latency_ms"]:
        print(f"[stream] {st['appends']} appends in {st['batches']} batches "
              f"({stream_s:.2f}s wall): p50={st['latency_ms']['p50']:.1f}ms "
              f"p99={st['latency_ms']['p99']:.1f}ms "
              f"{st['subjects_per_s_wall']:.1f} subjects/s")
    print(f"[drift] stream_fit={st['stream_fit']:.4f} "
          f"baseline={st['baseline_fit']:.4f} drift={st['drift']:.4f} "
          f"(max {st['drift_max']:.4f}, threshold {st['drift_threshold']}) "
          f"refits={st['refits']} at {st['refit_at']}")
    if args.ckpt_dir:
        path = svc.save(args.ckpt_dir)
        print(f"[ckpt] saved service state to {path}")

    summary = run_summary(
        "stream",
        resolved_options(opts, format=args.format, tol=args.tol, seed=args.seed,
                         warm_frac=args.warm_frac, batch_slots=args.batch_slots,
                         drift_threshold=args.drift_threshold, refit=args.refit,
                         smooth_lam=args.smooth),
        dataset=args.dataset, scale=args.scale, rank=args.rank,
        engine=args.engine, backend=args.backend,
        constraints=constraint_summary(specs),
        warm=warm_info,
        stream_seconds=stream_s,
        platform=device.type,
        **st,
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[json] wrote {args.json}")
    return summary


if __name__ == "__main__":
    main()
