"""MTTKRP compute backends for the SPARTan ALS step (``repro.core.backend``).

The ALS algebra (``core/parafac2.py``) asks an :class:`MttkrpBackend` for
the per-bucket stages and never touches a kernel itself. Five backend
names:

``torch``
    The plain torch math of :mod:`repro_torch.core.spartan`: five streaming
    stage launches per bucket per iteration (procrustes_b, project, mode1,
    mode2, ykv). SCOO buckets form X_k V and the compact Yc by the plain
    segment sums of :mod:`repro_torch.kernels.scoo`. The counterpart of the
    reference's ``jnp``.
``scoo``
    The O(nnz) route (:class:`SparseBackend`): on SCOO buckets every stage
    contracts the triplets directly (the plain torch versions of
    :mod:`repro_torch.kernels.scoo`; the reference has no kernel for them)
    and Yc is never built (``project_bucket`` carries Q). CC buckets go to
    ``torch``.
``fused``
    The four fused stages of :mod:`repro_torch.kernels.fused` on CC
    buckets: on CUDA the hand-written kernels, on the CPU their plain
    versions; Yc is never built. SCOO buckets take the ``scoo`` route in
    every stage but ``mode1_xkv_bucket``, whose dense Q and X_k V go to F2
    as in the reference.
``staged``
    The counterpart of the reference's ``pallas``: the torch route's bucket
    stages, with the array-level contractions (``ykv``, ``mode1``,
    ``mode2_compact``, ``mode3``) through the six staged kernels of
    :mod:`repro_torch.kernels.ops`. On CC buckets X_k V and the projection
    stay ``torch.bmm``, as the reference leaves them to XLA; on SCOO buckets
    they are the two SCOO kernels (``scoo_xk_times_v``, ``scoo_project``),
    whose Yc the staged kernels then take unchanged.
``auto``
    Resolved once from the data's device: ``fused`` on CUDA, at any R and
    C (the reference's R % 8 / C % 128 gate is the TPU's tiling and does
    not apply; operands the kernels do not take raise there), ``torch`` on
    the CPU.

The bucket-level stages (``procrustes_b_bucket`` / ``project_bucket`` /
``mode1_xkv_bucket`` / ``ykv_bucket`` / ``mode{1,2,3}_bucket``) are what
``als_step`` calls. :func:`dispatch_tally` counts the streaming stage calls
per bucket, with the reference's stage names on every route.

Compute precision (``precision``, the reference's): at ``"bf16"``/``"f16"``
each route stages the large streamed operands half-width where the
reference's backend does (``_pc``: the slab, Vg and, on the dense route,
Q and the projected Yc), while every contraction accumulates in f32
(``accum_dtype``); products of two half values are exact in f32, so only
the casts lose bits. The slab's half copy is the bucket's ``vals_half``
when a fit made it (:meth:`Bucketed.with_compute_values`), else a cast.
On CUDA the half operands go to the kernels at half width, and the torch
route's products (no kernel in the reference either) to cuBLAS with an
f32 result (``spartan.bmm_acc``). ``"f32"`` is the unconfigured backend,
bit for bit.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import spartan
from repro_torch.core.irregular import SparseBucket
from repro_torch.kernels import fused, ops, scoo
from repro_torch.kernels.common import (PRECISION_DTYPES, PRECISIONS, compute_cast,
                                        fold_subject_mask)

__all__ = [
    "MttkrpBackend",
    "TorchBackend",
    "SparseBackend",
    "FusedBackend",
    "StagedBackend",
    "BACKENDS",
    "get_backend",
    "dispatch_tally",
]

_TALLY: Optional[collections.Counter] = None


@contextlib.contextmanager
def dispatch_tally():
    """Count the per-bucket stage calls that stream I- or C-sized operands
    (the slab, XkV/Q, or Yc). Stages that touch only [Kb,R,R] tiles
    (mode-1/mode-3 from a cached YkV) are not counted::

        with dispatch_tally() as t:
            als_step(data, state, opts)
        per_bucket = sum(t.values()) / len(data.buckets)

    The torch and staged routes count 5 per bucket per iteration
    (procrustes_b, project, mode1, mode2, ykv); the fused route counts 4,
    and so does the scoo route on SCOO buckets (neither projects).
    """
    global _TALLY
    prev, _TALLY = _TALLY, collections.Counter()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def _tick(stage: str) -> None:
    if _TALLY is not None:
        _TALLY[stage] += 1


class MttkrpBackend:
    """The SPARTan MTTKRP contractions, per bucket, in the torch math of
    :mod:`repro_torch.core.spartan`; subclasses replace bucket stages.

    Per-bucket shapes (Kb subjects, C kept columns padded, rank R):
    Yc [Kb, R, C] compressed slices; Vg [Kb, C, R] gathered V rows;
    Wb [Kb, R] W rows; masks 1.0 = real, 0.0 = padding.

    ``precision`` ("f32" default) below f32 stages the streamed operands
    half-width (:meth:`_pc`) while accumulating in f32; "f32" keeps every
    path bit for bit the unconfigured backend's.
    """

    name: str = "?"

    def __init__(self, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown compute precision {precision!r}; "
                             f"choose from {PRECISIONS}")
        self.precision = precision

    def _pc(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A streamed operand at the compute precision (the identity at
        "f32")."""
        return compute_cast(x, self.precision)

    @staticmethod
    def shard_subjects(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The identity. The reference constrains every Kb-leading stage
        input and output onto the "subjects" mesh axis here, so that XLA
        splits it over the devices; in the port each mesh rank already holds
        only its own subjects (``bucketize(shard=...)``), so there is
        nothing to split, and the stages call it at the one site of
        ``parafac2._procrustes_project`` only."""
        return x

    def _vals(self, b) -> torch.Tensor:
        """The bucket's values at the compute precision: its ``vals_half``
        where a fit made them at this precision, else ``_pc(b.vals)``."""
        if self.precision == "f32":
            return b.vals
        half = b.vals_half
        if half is not None and half.dtype == PRECISION_DTYPES[self.precision]:
            return half
        return self._pc(b.vals)

    def _vg(self, b, V) -> torch.Tensor:
        """The bucket's V rows at the compute precision: ``gather_v`` of V
        cast, the reference's ``_pc(gather_v(V))`` value for value (the
        column mask is 0 or 1) without an f32 Vg in between."""
        return b.gather_v(self._pc(V))

    # -- shared stages ------------------------------------------------------
    def ykv(self, Yc: torch.Tensor, Vg: torch.Tensor) -> torch.Tensor:
        """Y_k V [Kb, R, R], shared by the mode-3 reuse path and the fit."""
        return spartan.bmm_acc(Yc, Vg)

    mode2_scatter = staticmethod(spartan.mode2_scatter)

    # -- bucket-level stages (the als_step contract) ------------------------
    def xkv_bucket(self, b, V, Vg=None) -> torch.Tensor:
        """X_k V [Kb, I_pad, R], the Procrustes-step input (half slab and Vg
        below f32 on CC buckets, f32 sums)."""
        if self.precision != "f32" and not isinstance(b, SparseBucket):
            Vg = b.gather_v(V) if Vg is None else Vg
            return spartan.bmm_acc(self._vals(b), self._pc(Vg))
        return b.xk_times_v(V, Vg)

    def procrustes_b_bucket(self, b, H, Wb, V, Vg=None):
        """(XkV [Kb,I,R], B [Kb,I,R]) with B_k = (X_k V * w_k) H^T, the
        Procrustes input."""
        _tick("procrustes_b")
        XkV = self.xkv_bucket(b, V, Vg)
        B = torch.matmul(XkV * Wb[:, None, :], H.T)
        return XkV, B

    def mode1_xkv_bucket(self, b, Q, XkV, Wb) -> torch.Tensor:
        """Partial M1 [R,R] via the mode-1 reuse identity
        Y_k V = Q_k^T (X_k V)."""
        _tick("mode1")
        YkV = torch.bmm(Q.transpose(1, 2), spartan._f(XkV))
        return self.mode1(None, None, Wb, b.subject_mask, YkV=YkV)

    def sketch_bucket(self, b, Omega: torch.Tensor,
                      Og: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Y_k = X_k Ω [Kb, I_pad, S], the randomized range finder's sketch
        (:mod:`repro_torch.core.compress`): the contraction of
        ``xkv_bucket`` with a wider right factor, on every route a
        ``torch.bmm`` on CC buckets and the plain segment sum on SCOO
        buckets (never densified), as the reference's einsum."""
        from repro_torch.kernels import sketch as _sketch

        return _sketch.sketch_bucket(b, Omega, Og)

    def project_bucket(self, b, Q):
        """The projected representation the later stages consume: the
        compact Yc [Kb, R, C] on the torch route (a segment sum on SCOO
        buckets); below f32 on CC buckets from half Q and slab, rounded to
        half."""
        _tick("project")
        if self.precision != "f32" and not isinstance(b, SparseBucket):
            return self._pc(spartan.bmm_acc(self._pc(Q).transpose(1, 2), self._vals(b)))
        return b.project(Q)

    def ykv_bucket(self, b, proj, V) -> torch.Tensor:
        """Y_k V [Kb, R, R] for factor ``V`` (the W update and the fit)."""
        _tick("ykv")
        return self.ykv(proj, self._vg(b, V))

    def mode1_bucket(self, b, proj, Wb, V=None, *, YkV=None) -> torch.Tensor:
        if YkV is None:
            _tick("mode1")
        Vg = None if YkV is not None else self._vg(b, V)
        return self.mode1(proj, Vg, Wb, b.subject_mask, YkV=YkV)

    def mode2_bucket(self, b, proj, H, Wb) -> torch.Tensor:
        _tick("mode2")
        return self.mode2_compact(proj, H, Wb, b.col_mask, b.subject_mask)

    def mode3_bucket(self, b, proj, H, V=None, *, YkV=None) -> torch.Tensor:
        if YkV is None:
            _tick("mode3")
        Vg = None if YkV is not None else self._vg(b, V)
        return self.mode3(proj, Vg, H, b.subject_mask, YkV=YkV)

    # -- per-bucket contractions --------------------------------------------
    def mode1(self, Yc, Vg, Wb, subject_mask, *, YkV=None) -> torch.Tensor:
        """Partial M1 [R, R] = sum_k (Y_k V) * W(k,:)."""
        return spartan.mode1_bucket(Yc, Vg, Wb, subject_mask, YkV=YkV)

    def mode2_compact(self, Yc, H, Wb, col_mask, subject_mask) -> torch.Tensor:
        """Compact A [Kb, C, R] = (Y_k^T H) * W(k,:); masked rows are 0."""
        return spartan.mode2_bucket_compact(Yc, H, Wb, col_mask, subject_mask)

    def mode3(self, Yc, Vg, H, subject_mask, *, YkV=None) -> torch.Tensor:
        """Per-subject M3 rows [Kb, R] = coldot(H, Y_k V)."""
        return spartan.mode3_bucket(Yc, Vg, H, subject_mask, YkV=YkV)

    # -- whole-tensor helpers (one call a mode over every bucket's Yc) -------
    # The ALS step does not call them: it goes bucket by bucket through the
    # stages above. On the staged backend they reach row 6 (mode1), row 8
    # (mode2_compact) and row 9 (mode3).
    def mttkrp_mode1(self, buckets, Ycs, V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """M1 [R, R] over all buckets, with W global [K, R]."""
        return sum(self.mode1(Yc, b.gather_v(V), W[b.subject_ids.long()], b.subject_mask)
                   for b, Yc in zip(buckets, Ycs))

    def mttkrp_mode2(self, buckets, Ycs, H: torch.Tensor, W: torch.Tensor,
                     J: int) -> torch.Tensor:
        """M2 [J, R]: the compact stage per bucket, then the shared
        deterministic scatter."""
        M2 = H.new_zeros((J, H.shape[0]))
        for b, Yc in zip(buckets, Ycs):
            A = self.mode2_compact(Yc, H, W[b.subject_ids.long()], b.col_mask,
                                   b.subject_mask)
            M2 = M2 + self.mode2_scatter(A, b.cols, J,
                                         order=(b.scatter_perm, b.scatter_ends)).to(M2.dtype)
        return M2

    def mttkrp_mode3(self, buckets, Ycs, V: torch.Tensor, H: torch.Tensor,
                     K: int) -> torch.Tensor:
        """M3 [K, R]: per-subject rows put at their global subject ids by a
        row assignment (each subject lies in one bucket, its real subjects
        in the first ``n_real`` slots): no atomics, deterministic."""
        M3 = H.new_zeros((K, H.shape[0]))
        for b, Yc in zip(buckets, Ycs):
            rows = self.mode3(Yc, b.gather_v(V), H, b.subject_mask)
            M3[b.subject_ids[: b.n_real].long()] = rows[: b.n_real].to(M3.dtype)
        return M3


class TorchBackend(MttkrpBackend):
    """The :mod:`repro_torch.core.spartan` math (the reference's ``jnp``)."""

    name = "torch"


class SparseBackend(TorchBackend):
    """The O(nnz) SCOO route (the reference's ``SparseBackend``).

    On SCOO buckets Yc is never built: ``project_bucket`` carries Q and the
    ykv / mode-1 / mode-2 / mode-3 stages contract the triplets directly
    (the plain torch versions of :mod:`repro_torch.kernels.scoo`, on any
    device; X_k V is the bucket's own segment sum). CC buckets, and the
    array-level contractions, take the torch route.
    """

    name = "scoo"

    def _ykv_native(self, b, Q, V):
        return scoo.ykv_scoo(self._vals(b), b.rows, b.lcols, Q, self._vg(b, V))

    def project_bucket(self, b, Q):
        if not isinstance(b, SparseBucket):
            return super().project_bucket(b, Q)
        return Q

    def ykv_bucket(self, b, proj, V):
        if not isinstance(b, SparseBucket):
            return super().ykv_bucket(b, proj, V)
        _tick("ykv")
        return self._ykv_native(b, proj, V)

    def mode1_bucket(self, b, proj, Wb, V=None, *, YkV=None):
        if not isinstance(b, SparseBucket):
            return super().mode1_bucket(b, proj, Wb, V, YkV=YkV)
        if YkV is None:
            _tick("mode1")
            YkV = self._ykv_native(b, proj, V)
        return self.mode1(None, None, Wb, b.subject_mask, YkV=YkV)

    def mode2_bucket(self, b, proj, H, Wb):
        if not isinstance(b, SparseBucket):
            return super().mode2_bucket(b, proj, H, Wb)
        _tick("mode2")
        return scoo.mode2_compact_scoo(self._vals(b), b.rows, b.lcols, proj, H, Wb,
                                       b.col_mask, b.subject_mask,
                                       cperm=b.cperm, col_ends=b.col_ends)

    def mode3_bucket(self, b, proj, H, V=None, *, YkV=None):
        if not isinstance(b, SparseBucket):
            return super().mode3_bucket(b, proj, H, V, YkV=YkV)
        if YkV is None:
            _tick("mode3")
            YkV = self._ykv_native(b, proj, V)
        return self.mode3(None, None, H, b.subject_mask, YkV=YkV)


class FusedBackend(SparseBackend):
    """The four fused stages of :mod:`repro_torch.kernels.fused`.

    ``project_bucket`` carries Q itself, so Y_k is never built; the
    array-level contractions (an explicit Yc in hand) are the torch math.
    The kernel wrappers take [R,R] operands contiguous, so H is made so
    here (a transposed solve result is a view). SCOO buckets take the
    ``scoo`` route (the parent class) in every stage where the reference's
    ``FusedBackend`` sends them there; ``mode1_xkv_bucket`` takes dense Q
    and X_k V of either format and stays F2.
    """

    name = "fused"

    def procrustes_b_bucket(self, b, H, Wb, V, Vg=None):
        if isinstance(b, SparseBucket):
            return super().procrustes_b_bucket(b, H, Wb, V, Vg)
        _tick("procrustes_b")
        Vg = b.gather_v(V) if Vg is None else Vg
        return fused.fused_procrustes_b(self._vals(b), self._pc(Vg), Wb, H.contiguous())

    def project_bucket(self, b, Q):
        return Q

    def mode1_xkv_bucket(self, b, Q, XkV, Wb):
        _tick("mode1")
        return fused.fused_mode1_xkv(Q, XkV, Wb, b.subject_mask)

    def ykv_bucket(self, b, proj, V):
        if isinstance(b, SparseBucket):
            return super().ykv_bucket(b, proj, V)
        _tick("ykv")
        return fused.fused_ykv(self._vals(b), proj, self._vg(b, V))

    def mode1_bucket(self, b, proj, Wb, V=None, *, YkV=None):
        if isinstance(b, SparseBucket):
            return super().mode1_bucket(b, proj, Wb, V, YkV=YkV)
        if YkV is None:
            YkV = self.ykv_bucket(b, proj, V)
        return self.mode1(None, None, Wb, b.subject_mask, YkV=YkV)

    def mode2_bucket(self, b, proj, H, Wb):
        if isinstance(b, SparseBucket):
            return super().mode2_bucket(b, proj, H, Wb)
        _tick("mode2")
        return fused.fused_mode2_compact(
            self._vals(b), proj, H.contiguous(), fold_subject_mask(Wb, b.subject_mask),
            b.col_mask)

    def mode3_bucket(self, b, proj, H, V=None, *, YkV=None):
        if isinstance(b, SparseBucket):
            return super().mode3_bucket(b, proj, H, V, YkV=YkV)
        if YkV is None:
            YkV = self.ykv_bucket(b, proj, V)
        return self.mode3(None, None, H, b.subject_mask, YkV=YkV)


class StagedBackend(TorchBackend):
    """The staged kernels of :mod:`repro_torch.kernels.ops` (the reference's
    ``PallasBackend``): the array-level contractions are replaced, and every
    bucket stage is the torch route's, which hands them an explicit Yc. On
    SCOO buckets X_k V and Yc come from the two SCOO kernels
    (``xkv_bucket``, ``project_bucket``). Unlike the reference, f64
    operands stay f64 (its demotion to f32 is a limit of the TPU compiler,
    not of the card). H is made contiguous here (a transposed solve result
    is a view). Below f32 the two SCOO kernels take the half values (and
    half Vg) and return f32 sums, which this route rounds to half, as the
    reference's ``use_pallas`` wrappers round theirs."""

    name = "staged"

    def xkv_bucket(self, b, V, Vg=None):
        if not isinstance(b, SparseBucket):
            return super().xkv_bucket(b, V, Vg)
        Vg = b.gather_v(V) if Vg is None else Vg
        vals = self._vals(b)
        return scoo.scoo_xk_times_v(vals, b.rows, b.lcols, self._pc(Vg), b.i_pad,
                                    row_ends=b.row_ends).to(vals.dtype)

    def project_bucket(self, b, Q):
        if not isinstance(b, SparseBucket):
            return super().project_bucket(b, Q)
        _tick("project")
        vals = self._vals(b)
        return scoo.scoo_project(vals, b.rows, b.lcols, Q, b.c_pad,
                                 cperm=b.cperm, col_ends=b.col_ends).to(vals.dtype)

    def ykv(self, Yc, Vg):
        return ops.ykv(Yc, Vg)

    def mode1(self, Yc, Vg, Wb, subject_mask, *, YkV=None):
        return ops.mttkrp_mode1(Yc, Vg, Wb, subject_mask=subject_mask, YkV=YkV)

    def mode2_compact(self, Yc, H, Wb, col_mask, subject_mask):
        return ops.mttkrp_mode2_compact(Yc, H.contiguous(), Wb, col_mask=col_mask,
                                        subject_mask=subject_mask)

    def mode3(self, Yc, Vg, H, subject_mask, *, YkV=None):
        return ops.mttkrp_mode3(Yc, Vg, H.contiguous(), subject_mask=subject_mask,
                                YkV=YkV)


BACKENDS = {"torch": TorchBackend(), "scoo": SparseBackend(),
            "fused": FusedBackend(), "staged": StagedBackend()}

# configured (below-f32 precision) instances, one per (name, precision), so
# that repeated calls hand back the same backend object
_CONFIGURED: Dict[Tuple[str, str], MttkrpBackend] = {}


def get_backend(name, device=None, precision: Optional[str] = None) -> MttkrpBackend:
    """Resolve a backend by name ("torch" | "scoo" | "fused" | "staged" |
    "auto") or pass an :class:`MttkrpBackend` instance through unchanged.
    ``auto`` needs the data's ``device``: ``fused`` on CUDA, ``torch`` on
    the CPU. ``precision`` (None/"f32" default) returns a configured
    instance that stages the streamed operands at that compute precision,
    cached per (name, precision); the f32 singletons in ``BACKENDS`` are
    untouched."""
    if isinstance(name, MttkrpBackend):
        return name
    if name == "auto":
        if device is None:
            raise ValueError("backend 'auto' is resolved from the data's device; "
                             "pass device=")
        name = "fused" if torch.device(device).type == "cuda" else "torch"
    if name not in BACKENDS:
        raise ValueError(f"unknown MTTKRP backend {name!r}; choose from "
                         f"{sorted(BACKENDS) + ['auto']}")
    if precision is None or precision == "f32":
        return BACKENDS[name]
    key = (name, precision)
    if key not in _CONFIGURED:
        _CONFIGURED[key] = type(BACKENDS[name])(precision=precision)
    return _CONFIGURED[key]
