"""PARAFAC2-ALS with the SPARTan MTTKRP (``repro.core.parafac2``).

One ALS iteration (Algorithm 2 of the paper) on the bucketed CC and SCOO
formats:

  1. Procrustes step, batched over subjects: B_k = X_k V S_k H^T,
     Q_k = polar(B_k) (Gram-eigh by default, see procrustes.py).
  2. Project: Y_k = Q_k^T X_k (the fused and scoo routes never form it).
  3. One CP-ALS iteration on {Y_k} through the mode-1/2/3 MTTKRPs; each
     factor update (H from M1, V from M2, W from M3) goes through the
     per-mode constraint (H unconstrained, V and W nonneg by HALS by
     default); S_k = diag(W(k,:)).
  4. Fit = 1 - sqrt(sum_k ||X_k - Q_k H S_k V^T||^2) / ||X||_F.

``mode1_reuse=True`` uses Y_k V = Q_k^T (X_k V) from step 1. The stages go
through a compute backend (``opts.backend``: "torch" | "scoo" | "fused" |
"staged" | "auto", see :mod:`repro_torch.core.backend`). ``opts.engine``
picks the loop: "host" runs one ``als_step`` per iteration and reads the fit
on the host; "scan" runs chunks of ``opts.check_every`` iterations, or the
whole fit with the stopping rule on the device (``check_every=0``), as CUDA
graphs on a GPU (:mod:`repro_torch.core.engine`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import constraints as cst
from repro_torch.core.backend import MttkrpBackend, get_backend
from repro_torch.core.cp import normalize_columns
from repro_torch.core.irregular import Bucket, Bucketed
from repro_torch.core.procrustes import solve_q

__all__ = ["Parafac2State", "Parafac2Options", "constraints_for", "init_state",
           "als_step", "fit", "w_global"]


@dataclasses.dataclass
class Parafac2State:
    H: torch.Tensor        # [R, R]
    V: torch.Tensor        # [J, R]
    W: torch.Tensor        # [K, R]  (S_k = diag(W[k]))
    fit: torch.Tensor      # scalar model fit in [-inf, 1]


@dataclasses.dataclass(frozen=True)
class Parafac2Options:
    rank: int
    # per-mode constraint specs {"h"|"v"|"w": spec}; None selects the
    # paper's default, nonneg V and W (see repro_torch.core.constraints)
    constraints: Optional[Tuple[Tuple[str, str], ...]] = None
    procrustes: str = "gram_eigh"       # "svd" | "gram_eigh" | "newton_schulz"
    mode1_reuse: bool = True            # reuse X_k V from step 1 for mode 1
    nnls_sweeps: int = 5
    dtype: torch.dtype = torch.float32
    backend: str = "auto"       # "torch" | "scoo" | "fused" | "staged" | "auto"
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

    def __post_init__(self):
        if self.constraints is not None:
            object.__setattr__(
                self, "constraints", tuple(sorted(dict(self.constraints).items())))
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype}")

    def constraint_specs(self) -> Dict[str, str]:
        if self.constraints is not None:
            return dict(self.constraints)
        return {"v": "nonneg", "w": "nonneg"}


def constraints_for(opts: Parafac2Options) -> Dict[str, cst.Constraint]:
    return cst.bundle(opts.constraint_specs())


def init_state(data: Bucketed, opts: Parafac2Options, seed: int = 0, *,
               state: Optional[Parafac2State] = None) -> Parafac2State:
    """H = I, V random (uniform when V is nonneg, else normal), W = 1.

    ``torch.Generator`` cannot reproduce the reference's ``jax.random``
    draw, so a caller that needs the reference's start passes it as
    ``state`` (see ``repro_torch.convert.state_from_arrays``); it is moved
    to the data's device and ``opts.dtype``.
    """
    dev, dt = data.device, opts.dtype
    if state is not None:
        return Parafac2State(**{f: getattr(state, f).to(device=dev, dtype=dt)
                                for f in ("H", "V", "W", "fit")})
    R = opts.rank
    gen = torch.Generator(device="cpu").manual_seed(seed)
    draw = torch.rand if constraints_for(opts)["v"].nonneg else torch.randn
    V = draw((data.n_cols, R), generator=gen, dtype=dt).to(dev)
    return Parafac2State(
        H=torch.eye(R, dtype=dt, device=dev), V=V,
        W=torch.ones((data.n_subjects, R), dtype=dt, device=dev),
        fit=torch.tensor(-np.inf, dtype=dt, device=dev))


def w_global(data: Bucketed, W: torch.Tensor) -> torch.Tensor:
    """The global [K, R] W (the only W layout ported)."""
    return W


def _w_rows(W: torch.Tensor, b: Bucket) -> torch.Tensor:
    return W[b.subject_ids.long()]


def _procrustes_project(b: Bucket, H, V, W, opts: Parafac2Options,
                        be: MttkrpBackend):
    """Steps 1+2 for one bucket -> (proj, XkV, Q); ``proj`` is the
    backend's projected representation (Yc on the torch route, Q on the
    fused route), handed back only to the same backend."""
    Vg = b.gather_v(V)                                   # [Kb, C, R]
    XkV, B = be.procrustes_b_bucket(b, H, _w_rows(W, b), V, Vg)
    Q = solve_q(B, opts.procrustes) * b.subject_mask[:, None, None]
    return be.project_bucket(b, Q), XkV, Q


def als_step(data: Bucketed, state: Parafac2State,
             opts: Parafac2Options) -> Parafac2State:
    """One full PARAFAC2-ALS iteration."""
    H, V, W = state.H, state.V, state.W
    R, J, K = opts.rank, data.n_cols, data.n_subjects
    dt, dev = opts.dtype, data.device
    be = get_backend(opts.backend, dev)
    cons = constraints_for(opts)
    sweeps = opts.nnls_sweeps

    # ---- 1+2: Procrustes + projection, per bucket --------------------------
    per_bucket = [_procrustes_project(b, H, V, W, opts, be) for b in data.buckets]

    # ---- 3a: H update (mode-1 MTTKRP) --------------------------------------
    M1 = torch.zeros((R, R), dtype=dt, device=dev)
    for b, (proj, XkV, Q) in zip(data.buckets, per_bucket):
        Wb = _w_rows(W, b)
        if opts.mode1_reuse:
            M1 = M1 + be.mode1_xkv_bucket(b, Q, XkV, Wb)
        else:
            M1 = M1 + be.mode1_bucket(b, proj, Wb, V)
    H_new = cons["h"].update(M1, (W.T @ W) * (V.T @ V), H, nnls_sweeps=sweeps)
    # both ported constraints are indicators: absorb the scale into W
    H_new, h_norms = normalize_columns(H_new)
    W = W * h_norms[None, :]

    # ---- 3b: V update (mode-2 MTTKRP) --------------------------------------
    M2 = torch.zeros((J, R), dtype=dt, device=dev)
    for b, (proj, _, _) in zip(data.buckets, per_bucket):
        A = be.mode2_bucket(b, proj, H_new, _w_rows(W, b))
        M2 = M2 + be.mode2_scatter(A, b.cols, J,
                                   order=(b.scatter_perm, b.scatter_ends)).to(dt)
    V_new = cons["v"].update(M2, (W.T @ W) * (H_new.T @ H_new), V, nnls_sweeps=sweeps)
    V_new, v_norms = normalize_columns(V_new)
    W = W * v_norms[None, :]

    # ---- 3c: W update (mode-3 MTTKRP) --------------------------------------
    VtV = V_new.T @ V_new
    gram3 = VtV * (H_new.T @ H_new)
    Gs = []   # G_k = Y_k V_new per bucket, shared with the fit
    M3 = torch.zeros((K, R), dtype=dt, device=dev)
    for b, (proj, _, _) in zip(data.buckets, per_bucket):
        G = be.ykv_bucket(b, proj, V_new)
        Gs.append(G)
        rows = be.mode3_bucket(b, proj, H_new, YkV=G)
        # each subject lies in one bucket, and real subjects fill the first
        # n_real slots: a plain (deterministic) row assignment
        M3[b.subject_ids[: b.n_real].long()] = rows[: b.n_real].to(dt)
    W_new = cons["w"].update(M3, gram3, W, nnls_sweeps=sweeps)

    # ---- 4: fit ------------------------------------------------------------
    # ||X_k - Q_k H S_k V^T||^2 = ||X||^2 - 2 tr(S H^T G_k) + tr(S Φ S V^T V)
    Phi = H_new.T @ H_new
    delta = torch.zeros((), dtype=dt, device=dev)
    for b, G in zip(data.buckets, Gs):
        Wb = _w_rows(W_new, b)
        cross = torch.einsum("rl,krl,kl,k->", H_new, G.to(dt), Wb, b.subject_mask)
        model = torch.einsum("rl,rl,kr,kl,k->", Phi, VtV, Wb, Wb, b.subject_mask)
        delta = delta - 2.0 * cross + model
    norm_sq = data.norm_sq_tensor(dt)
    resid = norm_sq + delta
    fit_val = 1.0 - torch.sqrt(torch.clamp(resid, min=0.0)) / torch.sqrt(norm_sq)
    return Parafac2State(H=H_new, V=V_new, W=W_new, fit=fit_val)


def fit(data: Bucketed, opts: Parafac2Options, *, max_iters: int = 100,
        tol: float = 1e-6, seed: int = 0, verbose: bool = False,
        state: Optional[Parafac2State] = None
        ) -> Tuple[Parafac2State, List[float]]:
    """The host loop: one ``als_step`` per iteration, one read of the fit
    per iteration (a device sync), stopping when the fit changes by less
    than ``tol``. ``opts.engine != "host"`` runs the device-resident
    engine instead (:func:`repro_torch.core.engine.fit_device`, the same
    contract)."""
    if opts.engine != "host":
        from repro_torch.core import engine as _engine
        return _engine.fit_device(data, opts, max_iters=max_iters, tol=tol, seed=seed,
                                  verbose=verbose, state=state)
    state = init_state(data, opts, seed, state=state)
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
