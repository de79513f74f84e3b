"""PARAFAC2-ALS with the SPARTan MTTKRP (``repro.core.parafac2``).

One ALS iteration (Algorithm 2 of the paper) on the bucketed CC and SCOO
formats:

  1. Procrustes step, batched over subjects: B_k = X_k V S_k H^T,
     Q_k = polar(B_k) (Gram-eigh by default, see procrustes.py).
  2. Project: Y_k = Q_k^T X_k (the fused and scoo routes never form it).
  3. One CP-ALS iteration on {Y_k} through the mode-1/2/3 MTTKRPs; each
     factor update (H from M1, V from M2, W from M3) goes through the
     per-mode constraint layer (:mod:`repro_torch.core.constraints`,
     ``opts.constraints``; the default is the paper's H unconstrained, V
     and W nonneg by HALS, and ADMM-routed constraints carry their dual
     state in ``state.aux``); S_k = diag(W(k,:)).
  4. Fit = 1 - sqrt(sum_k ||X_k - Q_k H S_k V^T||^2) / ||X||_F.

``mode1_reuse=True`` uses Y_k V = Q_k^T (X_k V) from step 1. The stages go
through a compute backend (``opts.backend``: "torch" | "scoo" | "fused" |
"staged" | "auto", see :mod:`repro_torch.core.backend`). ``opts.engine``
picks the loop: "host" runs one ``als_step`` per iteration and reads the fit
on the host; "scan" runs chunks of ``opts.check_every`` iterations, or the
whole fit with the stopping rule on the device (``check_every=0``), as CUDA
graphs on a GPU (:mod:`repro_torch.core.engine`). W is one [K, R] tensor
(``w_layout="global"``) or a tuple of per-bucket [Kb, R] tensors whose
padded slots stay zero (``"bucketed"``). ``engine="mesh"`` runs the scan
engine's iteration on one rank's shard of the subjects, a process a GPU:
every sum over subjects (M1, M2, M3, the bucketed W's Gram, the fit's
residual) goes through :func:`repro_torch.dist.sharding.psum_subjects`, an
all-reduce over the ranks there and the identity elsewhere; H, V, a
global W and the fit are the same on every rank, a bucketed W is each
rank's own rows. ``opts.precision`` ("f32", "bf16",
"f16") is the compute precision of the streamed operands (see
:mod:`repro_torch.core.backend`); below f32 ``fit`` makes each bucket's
half values once, before the first iteration. ``opts.compress`` (a
:mod:`repro_torch.core.compress` spec, ``"none"`` by default) runs the whole
loop on randomized small cores: compress, this same ``fit`` on the core
data, then the exact expansion and the residual-corrected fit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compress as _compress
from repro_torch.core import constraints as cst
from repro_torch.core.backend import MttkrpBackend, get_backend
from repro_torch.core.cp import normalize_columns
from repro_torch.core.irregular import Bucket, Bucketed
from repro_torch.core.procrustes import solve_q
from repro_torch.dist.sharding import psum_subjects
from repro_torch.kernels.common import PRECISIONS

__all__ = ["Parafac2State", "Parafac2Options", "constraints_for", "init_state",
           "als_step", "fit", "reconstruct_uk", "update_subjects", "w_global"]

W_LAYOUTS = ("global", "bucketed")


@dataclasses.dataclass
class Parafac2State:
    H: torch.Tensor        # [R, R]
    V: torch.Tensor        # [J, R]
    W: Any                 # [K, R] (S_k = diag(W[k])), or a tuple of [Kb, R]
    fit: torch.Tensor      # scalar model fit in [-inf, 1]
    # per-mode constraint-solver state (ADMM duals), carried across
    # iterations by every engine: {"h": .., "v": .., "w": ..}, () for a mode
    # whose constraint is direct (none/nonneg), a (Z, U) pair of tensors for
    # an ADMM one, a list of pairs for W's in the bucketed layout
    aux: Any = ()


@dataclasses.dataclass(frozen=True)
class Parafac2Options:
    rank: int
    # per-mode constraint specs {"h"|"v"|"w": spec}; None selects the
    # paper's default, nonneg V and W (see repro_torch.core.constraints)
    constraints: Optional[Tuple[Tuple[str, str], ...]] = None
    # Removed before the port began: the pre-constraint-layer nonneg bool.
    # Passing it raises TypeError with the migration hint below.
    nonneg: dataclasses.InitVar[Optional[bool]] = None
    procrustes: str = "gram_eigh"       # "svd" | "gram_eigh" | "newton_schulz"
    mode1_reuse: bool = True            # reuse X_k V from step 1 for mode 1
    nnls_sweeps: int = 5
    # inner AO-ADMM iterations per factor update (ADMM-routed constraints;
    # warm-started duals make a handful enough, COPA section 3)
    admm_iters: int = 10
    # Tikhonov damping added to every factor update's R x R Gram (A +
    # ridge I). 0.0, the default, adds no operation at all, so the default
    # iteration is bit for bit the undamped one.
    ridge: float = 0.0
    dtype: torch.dtype = torch.float32
    backend: str = "auto"       # "torch" | "scoo" | "fused" | "staged" | "auto"
    # Compute precision of the streamed operands: "f32" (the default, bit for
    # bit the unconfigured path), or "bf16"/"f16", which stage the slab, Vg
    # and the projected slices half-width while every product still
    # accumulates in f32 (the kernels read the half operands at 2 bytes).
    precision: str = "f32"
    # W layout: "global" [K, R], or "bucketed" (a tuple of per-bucket [Kb, R]
    # rows aligned with the buckets: no W gathers)
    w_layout: str = "global"
    # Execution engine for fit() (see repro_torch.core.engine):
    #   "host" — one als_step per iteration, the fit read on the host each
    #            iteration (the reference loop);
    #   "scan" — chunks of `check_every` iterations, on a GPU replays of one
    #            captured CUDA graph, the fit history kept on the device and
    #            read once a chunk.
    # The engine name is checked in engine.fit_device.
    engine: str = "host"
    # Iterations per chunk for the scan engine. 0 selects the while variant:
    # the whole fit with the host loop's stopping rule evaluated on the device.
    check_every: int = 10
    # Preprocessing stage spec (repro_torch.core.compress): "none" (the
    # default), or "rsvd[:r[:p[:q]]]", which makes fit() compress the data
    # first, run the unchanged core ALS on the small cores and expand exactly
    # at the end.
    compress: str = "none"

    def __post_init__(self, nonneg):
        if nonneg is not None:
            raise TypeError(
                "Parafac2Options(nonneg=...) was removed; migrate to "
                "constraints={'v': 'nonneg', 'w': 'nonneg'} for nonneg=True "
                "or {'v': 'none', 'w': 'none'} for nonneg=False")
        if self.constraints is not None:
            object.__setattr__(
                self, "constraints", tuple(sorted(dict(self.constraints).items())))
        # a bad preprocessing spec fails here (ValueError listing the
        # registered preprocessors), as a bad constraint spec does
        _compress.parse_preprocess_spec(self.compress)
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype}")
        if self.ridge < 0.0:
            raise ValueError(f"ridge must be >= 0, got {self.ridge}")
        if self.w_layout not in W_LAYOUTS:
            raise ValueError(f"unknown w_layout {self.w_layout!r}; choose from {W_LAYOUTS}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; "
                f"choose from {PRECISIONS}")
        if self.precision != "f32" and self.dtype == torch.float64:
            raise ValueError(
                "precision='bf16'/'f16' casts the streamed operands below "
                "the requested f64 factor dtype; use dtype=float32 with "
                "reduced precision, or precision='f32' with f64")

    def constraint_specs(self) -> Dict[str, str]:
        """Resolved per-mode constraint specs (``constraints=None`` keeps the
        paper's nonnegative V/W default)."""
        if self.constraints is not None:
            return dict(self.constraints)
        return {"v": "nonneg", "w": "nonneg"}


def constraints_for(opts: Parafac2Options) -> Dict[str, cst.Constraint]:
    """The parsed per-mode constraint bundle of ``opts``, with the layout
    check: ``smooth`` on W couples subjects in subject-id order and needs
    the global W."""
    cons = cst.bundle(opts.constraint_specs())
    if opts.w_layout == "bucketed" and cons["w"].smooth_lam:
        raise ValueError(
            "constraint 'smooth' on mode 'w' couples W rows across subjects "
            "and needs w_layout='global' (the bucketed layout splits rows "
            "across buckets)")
    return cons


def _init_aux(cons: Dict[str, cst.Constraint], H, V, W) -> Dict[str, Any]:
    """Every mode's carried solver state from the factors it starts at: a
    per-bucket W carries a LIST of per-bucket pairs, the global W one pair."""
    if isinstance(W, tuple):
        aux_w = [cons["w"].init_aux(wb) for wb in W] if cons["w"].admm else ()
    else:
        aux_w = cons["w"].init_aux(W)
    return {"h": cons["h"].init_aux(H), "v": cons["v"].init_aux(V), "w": aux_w}


def init_state(data: Bucketed, opts: Parafac2Options, seed: int = 0, *,
               state: Optional[Parafac2State] = None) -> Parafac2State:
    """H = I, V random (uniform when V is nonneg, else normal), W = 1 (in
    the bucketed layout, per bucket, zero on padded slots); ADMM-routed
    constraints get their ``(Z, U)`` duals here, so the carried ``aux`` has
    a fixed structure for the engines.

    ``torch.Generator`` cannot reproduce the reference's ``jax.random``
    draw, so a caller that needs the reference's start passes it as
    ``state`` (see ``repro_torch.convert.state_from_arrays``); it is moved
    to the data's device and ``opts.dtype``, its ``aux`` with it, and
    without an ``aux`` dict the duals are made from its factors.
    """
    dev, dt = data.device, opts.dtype
    cons = constraints_for(opts)
    if state is not None:
        def to(x):
            return cst.tree_map(lambda t: t.to(device=dev, dtype=dt), x)

        H, V, W, f = (to(getattr(state, k)) for k in ("H", "V", "W", "fit"))
        aux = to(state.aux) if isinstance(state.aux, dict) else _init_aux(cons, H, V, W)
        return Parafac2State(H=H, V=V, W=W, fit=f, aux=aux)
    R = opts.rank
    gen = torch.Generator(device="cpu").manual_seed(seed)
    draw = torch.rand if cons["v"].nonneg else torch.randn
    V = draw((data.n_cols, R), generator=gen, dtype=dt).to(dev)
    H = torch.eye(R, dtype=dt, device=dev)
    if opts.w_layout == "bucketed":
        W = tuple(torch.ones((b.kb, R), dtype=dt, device=dev) * b.subject_mask[:, None]
                  for b in data.buckets)
    else:
        W = torch.ones((data.n_subjects, R), dtype=dt, device=dev)
    return Parafac2State(H=H, V=V, W=W, fit=torch.tensor(-np.inf, dtype=dt, device=dev),
                         aux=_init_aux(cons, H, V, W))


def _w_rows(W, b: Bucket, i: int) -> torch.Tensor:
    """W rows for bucket i (no gather in the bucketed layout)."""
    if isinstance(W, tuple):
        return W[i]
    return W[b.subject_ids.long()]


def _w_gram(W) -> torch.Tensor:
    if isinstance(W, tuple):
        # a bucketed W lies with the data, split over the ranks under the
        # mesh engine: its Gram is a sum over subjects (a global W is the
        # same on every rank)
        return psum_subjects(sum(wb.T @ wb for wb in W))
    return W.T @ W


def w_global(data: Bucketed, W) -> torch.Tensor:
    """The global [K, R] W from either layout (interpretation): one row
    assignment per bucket, since each subject lies in one bucket and the
    real subjects fill its first ``n_real`` slots. On a mesh rank's shard
    (``data.shard``) each rank assigns its own rows and the ranks' rows are
    summed (every rank then holds the whole W; it must be called on every
    rank)."""
    if not isinstance(W, tuple):
        return W
    out = W[0].new_zeros((data.n_subjects, W[0].shape[1]))
    for b, wb in zip(data.buckets, W):
        out[b.subject_ids[: b.n_real].long()] = (wb * b.subject_mask[:, None])[: b.n_real]
    if data.shard[1] > 1:
        from repro_torch.core import engine as _engine
        with _engine.mesh_collectives(data.device):
            out = psum_subjects(out)
    return out


def _ridged(A: torch.Tensor, opts: Parafac2Options) -> torch.Tensor:
    """A + ridge I on an R x R Gram; no operation at all at ridge == 0."""
    if opts.ridge:
        return A + opts.ridge * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A


def _procrustes_project(b: Bucket, H, V, W, opts: Parafac2Options, i: int,
                        be: MttkrpBackend):
    """Steps 1+2 for bucket ``i`` -> (proj, XkV, Q); ``proj`` is the
    backend's projected representation (Yc on the torch route, Q on the
    fused route), handed back only to the same backend."""
    Vg = b.gather_v(V)                                   # [Kb, C, R]
    XkV, B = be.procrustes_b_bucket(b, H, _w_rows(W, b, i), V, Vg)
    Q = be.shard_subjects(solve_q(B, opts.procrustes) * b.subject_mask[:, None, None])
    return be.project_bucket(b, Q), XkV, Q


def als_step(data: Bucketed, state: Parafac2State,
             opts: Parafac2Options) -> Parafac2State:
    """One full PARAFAC2-ALS iteration. Every factor update goes through the
    per-mode constraint bundle (:func:`constraints_for`); ADMM-routed
    constraints read and write their duals in ``state.aux``."""
    H, V, W = state.H, state.V, state.W
    R, J, K = opts.rank, data.n_cols, data.n_subjects
    dt, dev = opts.dtype, data.device
    be = get_backend(opts.backend, dev, opts.precision)
    cons = constraints_for(opts)
    solve_kw = dict(nnls_sweeps=opts.nnls_sweeps, admm_iters=opts.admm_iters)
    aux = state.aux if isinstance(state.aux, dict) else cst.empty_aux()
    bucketed = isinstance(W, tuple)

    def scale_w(W, norms):
        if isinstance(W, tuple):
            return tuple(wb * norms[None, :] for wb in W)
        return W * norms[None, :]

    # ---- 1+2: Procrustes + projection, per bucket --------------------------
    per_bucket = [_procrustes_project(b, H, V, W, opts, i, be)
                  for i, b in enumerate(data.buckets)]

    # ---- 3a: H update (mode-1 MTTKRP) --------------------------------------
    M1 = torch.zeros((R, R), dtype=dt, device=dev)
    for i, (b, (proj, XkV, Q)) in enumerate(zip(data.buckets, per_bucket)):
        Wb = _w_rows(W, b, i)
        if opts.mode1_reuse:
            M1 = M1 + be.mode1_xkv_bucket(b, Q, XkV, Wb)
        else:
            M1 = M1 + be.mode1_bucket(b, proj, Wb, V)
    M1 = psum_subjects(M1)
    H_new, aux_h = cons["h"].update(M1, _ridged(_w_gram(W) * (V.T @ V), opts), H,
                                    aux["h"], **solve_kw)
    aux_w = aux["w"]
    if not cons["h"].penalized:
        # absorb the scale into W (model-invariant for indicator constraints;
        # a penalized mode keeps its natural scale, Constraint.penalized)
        H_new, h_norms = normalize_columns(H_new)
        aux_h = cst.scale_aux(aux_h, 1.0 / torch.clamp(h_norms, min=1e-12))
        W = scale_w(W, h_norms)
        aux_w = cst.scale_aux(aux_w, h_norms)

    # ---- 3b: V update (mode-2 MTTKRP) --------------------------------------
    M2 = torch.zeros((J, R), dtype=dt, device=dev)
    for i, (b, (proj, _, _)) in enumerate(zip(data.buckets, per_bucket)):
        A = be.mode2_bucket(b, proj, H_new, _w_rows(W, b, i))
        M2 = M2 + be.mode2_scatter(A, b.cols, J,
                                   order=(b.scatter_perm, b.scatter_ends)).to(dt)
    M2 = psum_subjects(M2)
    V_new, aux_v = cons["v"].update(M2, _ridged(_w_gram(W) * (H_new.T @ H_new), opts), V,
                                    aux["v"], **solve_kw)
    if not cons["v"].penalized:
        V_new, v_norms = normalize_columns(V_new)
        aux_v = cst.scale_aux(aux_v, 1.0 / torch.clamp(v_norms, min=1e-12))
        W = scale_w(W, v_norms)
        aux_w = cst.scale_aux(aux_w, v_norms)

    # ---- 3c: W update (mode-3 MTTKRP) --------------------------------------
    VtV = V_new.T @ V_new
    gram3 = _ridged(VtV * (H_new.T @ H_new), opts)
    Gs, rows_per_bucket = [], []   # G_k = Y_k V_new per bucket, shared with the fit
    for b, (proj, _, _) in zip(data.buckets, per_bucket):
        G = be.ykv_bucket(b, proj, V_new)
        Gs.append(G)
        rows_per_bucket.append(be.mode3_bucket(b, proj, H_new, YkV=G))
    if bucketed:
        # per-bucket W rows update in place: no K-wide scatter, no gathers;
        # the per-bucket duals ride in a list aligned with the buckets
        aux_w_list = aux_w if isinstance(aux_w, list) else [() for _ in data.buckets]
        upd = [cons["w"].update(rows.to(wb.dtype), gram3, wb, awb, **solve_kw)
               for rows, wb, awb in zip(rows_per_bucket, W, aux_w_list)]
        W_new = tuple(wn * b.subject_mask[:, None] for (wn, _), b in zip(upd, data.buckets))
        aux_w = [a for _, a in upd] if cons["w"].admm else ()
    else:
        M3 = torch.zeros((K, R), dtype=dt, device=dev)
        for b, rows in zip(data.buckets, rows_per_bucket):
            # each subject lies in one bucket, and real subjects fill the
            # first n_real slots: a plain (deterministic) row assignment
            M3[b.subject_ids[: b.n_real].long()] = rows[: b.n_real].to(dt)
        M3 = psum_subjects(M3)
        W_new, aux_w = cons["w"].update(M3, gram3, W, aux_w, **solve_kw)

    # ---- 4: fit ------------------------------------------------------------
    # ||X_k - Q_k H S_k V^T||^2 = ||X||^2 - 2 tr(S H^T G_k) + tr(S Φ S V^T V)
    Phi = H_new.T @ H_new
    delta = torch.zeros((), dtype=dt, device=dev)
    for i, (b, G) in enumerate(zip(data.buckets, Gs)):
        Wb = _w_rows(W_new, b, i)
        cross = torch.einsum("rl,krl,kl,k->", H_new, G.to(dt), Wb, b.subject_mask)
        model = torch.einsum("rl,rl,kr,kl,k->", Phi, VtV, Wb, Wb, b.subject_mask)
        delta = delta - 2.0 * cross + model
    norm_sq = data.norm_sq_tensor(dt)
    resid = norm_sq + psum_subjects(delta)
    fit_val = 1.0 - torch.sqrt(torch.clamp(resid, min=0.0)) / torch.sqrt(norm_sq)
    return Parafac2State(H=H_new, V=V_new, W=W_new, fit=fit_val,
                         aux={"h": aux_h, "v": aux_v, "w": aux_w})


def fit(data: Bucketed, opts: Parafac2Options, *, max_iters: int = 100,
        tol: float = 1e-6, seed: int = 0, verbose: bool = False,
        state: Optional[Parafac2State] = None
        ) -> Tuple[Parafac2State, List[float]]:
    """The host loop: one ``als_step`` per iteration, one read of the fit
    per iteration (a device sync), stopping when the fit changes by less
    than ``tol``. ``opts.engine != "host"`` runs the device-resident
    engine instead (:func:`repro_torch.core.engine.fit_device`, the same
    contract). Below f32 ``opts.precision`` the buckets' half values are
    made once here (:meth:`Bucketed.with_compute_values`) and dropped with
    the fit. A non-identity ``opts.compress`` goes to
    :func:`repro_torch.core.compress.fit_compressed` before any engine."""
    if not _compress.parse_preprocess_spec(opts.compress).identity:
        return _compress.fit_compressed(data, opts, max_iters=max_iters, tol=tol,
                                        seed=seed, verbose=verbose, state=state)
    if opts.engine != "host":
        from repro_torch.core import engine as _engine
        return _engine.fit_device(data, opts, max_iters=max_iters, tol=tol, seed=seed,
                                  verbose=verbose, state=state)
    state = init_state(data, opts, seed, state=state)
    data = data.with_compute_values(opts.precision)
    history: List[float] = []
    prev = -np.inf
    for it in range(max_iters):
        state = als_step(data, state, opts)
        f = float(state.fit)
        history.append(f)
        if verbose:
            print(f"iter {it:3d}  fit={f:.6f}")
        if it > 0 and abs(f - prev) < tol:
            break
        prev = f
    return state, history


def update_subjects(batch: Bucketed, H: torch.Tensor, V: torch.Tensor,
                    opts: Parafac2Options, *, w_init: Optional[torch.Tensor] = None,
                    w_prev: Optional[torch.Tensor] = None,
                    prev_mask: Optional[torch.Tensor] = None, smooth_lam: float = 0.0,
                    inner_iters: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Incremental per-subject solve with the factors ``H``/``V`` fixed (the
    serving entry point, ``repro_torch.launch.stream``): a new or touched
    subject needs only its own Procrustes basis ``Q_k`` and W row, both
    independent across subjects. Per inner iteration, per bucket, through the
    same backend stages ``als_step`` uses:

      1. ``B_k = X_k V S_k H^T``, ``Q_k = polar(B_k)`` at the current w_k
         (``w_init`` on the first pass);
      2. ``G_k = Y_k V`` and the mode-3 row, then the W-row solve through
         ``opts``' "w" constraint: ``als_step``'s stage 3c (with
         ``smooth_lam == 0`` and ``inner_iters == 1`` it is that stage, on
         a batch of the touched subjects).

    ``smooth_lam > 0`` anchors subjects with a previous row (``prev_mask``)
    by ``lam * ||w_k - w_k^prev||^2``, folded into each row's normal
    equations (``M += lam w_prev``, ``A += lam I``), so each row has a Gram
    of its own and is solved by :meth:`Constraint.update_rows`. ADMM-routed
    W constraints start from fresh duals. Below f32 ``opts.precision`` the
    batch's half values are made here, once a call.

    Returns ``(W_rows [batch.n_subjects, R], resid [batch.n_subjects])`` with
    ``resid[k] = ||X_k - Q_k H S_k V^T||_F^2`` at the returned row (the
    ``als_step`` fit's algebra, per subject). Rows are put at their subject
    ids by a row assignment of each bucket's real slots: no atomics.
    """
    if inner_iters < 1:
        raise ValueError(f"inner_iters must be >= 1, got {inner_iters}")
    R, dt, dev = opts.rank, opts.dtype, batch.device
    batch = batch.with_compute_values(opts.precision)
    be = get_backend(opts.backend, dev, opts.precision)
    cons_w = constraints_for(opts)["w"]
    solve_kw = dict(nnls_sweeps=opts.nnls_sweeps, admm_iters=opts.admm_iters)
    VtV = V.T @ V
    Phi = H.T @ H
    gram3 = VtV * Phi                                     # [R, R]
    K = batch.n_subjects
    if w_init is None:
        w_init = torch.ones((K, R), dtype=dt, device=dev)
    if w_prev is None:
        w_prev = torch.zeros((K, R), dtype=dt, device=dev)
    if prev_mask is None:
        prev_mask = torch.zeros((K,), dtype=dt, device=dev)

    def row_solve(rows, wb, prevb, pmaskb):
        """The stage-3c W solve for one bucket's rows [Kb, R]."""
        if smooth_lam <= 0.0:
            return cons_w.update(rows.to(wb.dtype), gram3, wb, (), **solve_kw)[0]
        lam_k = smooth_lam * pmaskb                                      # [Kb]
        M = rows.to(wb.dtype) + lam_k[:, None] * prevb
        eye = torch.eye(R, dtype=wb.dtype, device=dev)
        A = gram3.to(wb.dtype)[None] + lam_k[:, None, None] * eye       # [Kb, R, R]
        w0 = prevb * pmaskb[:, None] + wb * (1.0 - pmaskb)[:, None]
        return cons_w.update_rows(M, A, w0, **solve_kw)

    ids = [b.subject_ids.long() for b in batch.buckets]
    wbs = [w_init[i] * b.subject_mask[:, None] for i, b in zip(ids, batch.buckets)]
    Gs: List[torch.Tensor] = [None] * len(batch.buckets)
    for _ in range(inner_iters):
        Wt = tuple(wbs)
        for i, b in enumerate(batch.buckets):
            proj, _, _ = _procrustes_project(b, H, V, Wt, opts, i, be)
            G = be.ykv_bucket(b, proj, V)                 # [Kb, R, R]
            Gs[i] = G
            rows = be.mode3_bucket(b, proj, H, YkV=G)     # [Kb, R]
            pmaskb = prev_mask[ids[i]] * b.subject_mask
            wbs[i] = row_solve(rows, wbs[i], w_prev[ids[i]], pmaskb) * b.subject_mask[:, None]

    # per-subject residual at the final rows (Q from the last Procrustes,
    # the als_step fit's convention)
    W_out = torch.zeros((K, R), dtype=dt, device=dev)
    resid = torch.zeros((K,), dtype=dt, device=dev)
    for b, i, wb, G in zip(batch.buckets, ids, wbs, Gs):
        sq = b.sq_norms().to(dt)
        cross = torch.einsum("rl,krl,kl->k", H, G.to(H.dtype), wb).to(dt)
        model = torch.einsum("rl,rl,kr,kl->k", Phi, VtV, wb, wb).to(dt)
        m = b.subject_mask.to(dt)
        real = i[: b.n_real]
        W_out[real] = (wb.to(dt) * m[:, None])[: b.n_real]
        resid[real] = ((sq - 2.0 * cross + model) * m)[: b.n_real]
    return W_out, resid


def reconstruct_uk(data: Bucketed, state: Parafac2State,
                   opts: Parafac2Options) -> Dict[int, np.ndarray]:
    """U_k = Q_k H per subject, as numpy arrays of its I_k rows (host side,
    for interpretation)."""
    be = get_backend(opts.backend, data.device, opts.precision)
    out: Dict[int, np.ndarray] = {}
    for i, b in enumerate(data.buckets):
        _, _, Q = _procrustes_project(b, state.H, state.V, state.W, opts, i, be)
        Uk = torch.einsum("kir,rl->kil", Q, state.H).cpu().numpy()
        sids = b.subject_ids.cpu().numpy()
        smask = b.subject_mask.cpu().numpy()
        rows = b.row_counts.cpu().numpy()
        for slot in range(b.kb):
            if smask[slot] > 0:
                out[int(sids[slot])] = Uk[slot, : rows[slot], :]
    return out
