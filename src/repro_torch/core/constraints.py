"""Pluggable constraint layer for the PARAFAC2 factor updates, COPA-style
AO-ADMM (``repro.core.constraints``).

Every factor update consumes only the MTTKRP ``M`` and the Gram ``A`` of the
fixed factors and solves ``min_X ||T - X G^T||^2 + r(X)``. This module is the
swap point for ``r``:

* a **registry** of named terms (``register_term`` / ``available``), each a
  proximal operator plus solver metadata;
* a **spec grammar**, ``"name[:lam][+name[:lam]...]"`` per mode (``"nonneg"``,
  ``"l1:0.1"``, ``"smooth:0.5"``, ``"nonneg+l1:0.1"``), parsed by
  :func:`parse_spec` into a :class:`Constraint`;
* three **solver routes**: ``ridge`` (the unconstrained update,
  ``nnls.ridge_solve``), ``hals`` (HALS column sweeps, the paper's
  nonnegativity path) and ``admm`` (AO-ADMM, Huang et al. 2016: splitting
  ``X``/``Z = prox_{r/rho}``/dual ``U``, the ``(Z, U)`` pair carried across
  outer ALS iterations in ``Parafac2State.aux``).

Built-in terms: ``none``, ``nonneg`` (HALS), ``nonneg_admm`` (the same set by
ADMM's clip prox), ``l1`` (soft threshold: sparse phenotypes) and ``smooth``
(``lam * sum_k ||x_k - x_{k-1}||^2`` over factor rows, tPARAFAC2-style; its
prox is one tridiagonal solve, P2 of :mod:`repro_torch.kernels.tridiag` on a
GPU). ``nonneg+l1`` composes in closed form (shrink, then clip); compositions
without a closed-form joint prox raise when parsed.

Every ADMM quantity stays a tensor on the factor's device (``rho`` and the
l1 threshold included): no step reads a value back to the host, so a CUDA
graph captures an ADMM update like any other (``repro_torch.core.engine``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.nnls import hals_nnls, ridge_solve
from repro_torch.kernels.tridiag import tridiag_solve

__all__ = [
    "MODES",
    "Constraint",
    "TermDef",
    "admm_solve",
    "available",
    "bundle",
    "constraint_summary",
    "empty_aux",
    "parse_constraint_arg",
    "parse_spec",
    "prox_l1",
    "prox_nonneg",
    "prox_nonneg_l1",
    "prox_smooth",
    "register_term",
    "scale_aux",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]

MODES = ("h", "v", "w")   # PARAFAC2 factor modes a spec dict may constrain


# ---------------------------------------------------------------------------
# registry of atomic terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TermDef:
    """One registered constraint term.

    kind:        prox family: "none" | "clip" | "l1" | "smooth" | "custom"
    solver:      solver used when the term stands alone
    default_lam: strength when the spec omits ":lam"
    prox:        for kind="custom": ``prox(Y, rho, lam) -> Z`` (standalone
                 only; custom terms do not compose)
    nonneg:      solutions are guaranteed elementwise nonnegative
    """

    kind: str
    solver: str                      # "ridge" | "hals" | "admm"
    default_lam: float = 0.0
    prox: Optional[Callable] = None
    nonneg: bool = False


_REGISTRY: Dict[str, TermDef] = {}


def register_term(name: str, term: TermDef) -> None:
    """Register (or override) a named constraint term."""
    if term.kind == "custom" and term.prox is None:
        raise ValueError(f"custom term {name!r} needs a prox callable")
    _REGISTRY[name] = term
    if "parse_spec" in globals():          # built-ins register before it exists
        parse_spec.cache_clear()           # overrides must reach parsed specs


def available() -> Tuple[str, ...]:
    """Registered term names (sorted), for error messages and --help."""
    return tuple(sorted(_REGISTRY))


register_term("none", TermDef(kind="none", solver="ridge"))
register_term("nonneg", TermDef(kind="clip", solver="hals", nonneg=True))
register_term("nonneg_admm", TermDef(kind="clip", solver="admm", nonneg=True))
register_term("l1", TermDef(kind="l1", solver="admm", default_lam=0.1))
register_term("smooth", TermDef(kind="smooth", solver="admm", default_lam=0.1))


# ---------------------------------------------------------------------------
# prox operators
# ---------------------------------------------------------------------------

def prox_nonneg(Y: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative orthant."""
    return torch.clamp(Y, min=0.0)


def prox_l1(Y: torch.Tensor, t) -> torch.Tensor:
    """Soft threshold: prox of ``t * ||.||_1`` (elementwise shrink)."""
    return torch.sign(Y) * torch.clamp(torch.abs(Y) - t, min=0.0)


def prox_nonneg_l1(Y: torch.Tensor, t) -> torch.Tensor:
    """Joint prox of nonnegativity + l1: shrink, then clip (closed form)."""
    return torch.clamp(Y - t, min=0.0)


def prox_smooth(Y: torch.Tensor, rho, lam: float) -> torch.Tensor:
    """Prox of ``lam * sum_k ||y_k - y_{k-1}||^2`` over the leading axis.

    Minimises ``rho/2 ||Z - Y||^2 + lam ||D Z||^2`` (D: first differences
    over rows): ``(rho I + 2 lam D^T D) Z = rho Y``, one symmetric
    tridiagonal system for all columns, solved by P2
    (:func:`repro_torch.kernels.tridiag.tridiag_solve`: the kernel on a GPU,
    its plain version on the CPU). ``rho`` is a tensor (a device scalar) or
    a float.
    """
    if Y.shape[0] < 2:
        return Y
    if not isinstance(rho, torch.Tensor):
        rho = torch.full((), rho, dtype=Y.dtype, device=Y.device)
    return tridiag_solve(Y, rho, lam)


# ---------------------------------------------------------------------------
# spec parsing -> Constraint
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Constraint:
    """A parsed per-mode constraint: solver route + composed prox + aux shape.

    ``spec`` is the canonical string (stable across equivalent inputs);
    ``terms`` the resolved ``(name, lam)`` pairs. ``admm`` constraints carry
    a ``(Z, U)`` pair of tensors through ``Parafac2State.aux``.
    """

    spec: str
    terms: Tuple[Tuple[str, float], ...]

    @property
    def _defs(self) -> Tuple[TermDef, ...]:
        return tuple(_REGISTRY[n] for n, _ in self.terms)

    @property
    def solver(self) -> str:
        if len(self.terms) == 1:
            return self._defs[0].solver
        return "admm"

    @property
    def admm(self) -> bool:
        return self.solver == "admm"

    @property
    def nonneg(self) -> bool:
        """True when fitted factors are guaranteed elementwise nonnegative."""
        return any(d.nonneg for d in self._defs)

    @property
    def smooth_lam(self) -> float:
        return sum(lam for (n, lam), d in zip(self.terms, self._defs)
                   if d.kind == "smooth")

    @property
    def penalized(self) -> bool:
        """True when the constraint adds a penalty (l1 / smooth / custom with
        lam > 0) rather than only an indicator (none / nonneg). The ALS step
        skips column normalisation for penalized modes: the penalized
        objective is not scale-invariant, and normalise-then-absorb-into-W
        would rescale the penalty every iteration."""
        return any(lam > 0 and d.kind not in ("none", "clip")
                   for (_, lam), d in zip(self.terms, self._defs))

    def prox(self, Y: torch.Tensor, rho) -> torch.Tensor:
        """Joint prox of all terms at penalty ``rho`` (composability checked
        when parsed)."""
        kinds = {d.kind for d in self._defs}
        if "custom" in kinds:
            ((name, lam),), (d,) = self.terms, self._defs
            return d.prox(Y, rho, lam)
        if "smooth" in kinds:
            return prox_smooth(Y, rho, self.smooth_lam)
        l1_lam = sum(lam for (n, lam), d in zip(self.terms, self._defs)
                     if d.kind == "l1")
        t = l1_lam / rho
        if "clip" in kinds:
            return prox_nonneg_l1(Y, t) if l1_lam else prox_nonneg(Y)
        if l1_lam:
            return prox_l1(Y, t)
        return Y

    def init_aux(self, x0: torch.Tensor):
        """Initial carried solver state for a factor shaped like ``x0``:
        ``(Z, U)`` for ADMM constraints, ``()`` otherwise."""
        if not self.admm:
            return ()
        one = torch.ones((), dtype=x0.dtype, device=x0.device)
        return (self.prox(x0, one), torch.zeros_like(x0))

    def update(self, M: torch.Tensor, A: torch.Tensor, prev: torch.Tensor, aux,
               *, nnls_sweeps: int = 5, admm_iters: int = 10):
        """Solve ``min_X ||T - X G^T||^2 + r(X)`` from ``M = T G`` and
        ``A = G^T G``; returns ``(X, aux')``. The ridge and HALS routes
        carry nothing; the ADMM route warm-starts from the carried ``(Z, U)``
        pair (``init_aux(prev)`` when there is none) and returns the
        updated pair."""
        if self.solver == "ridge":
            return ridge_solve(M, A), ()
        if self.solver == "hals":
            return hals_nnls(M, A, prev, sweeps=nnls_sweeps), ()
        if not aux:
            aux = self.init_aux(prev)
        return admm_solve(M, A, aux, self.prox, iters=admm_iters)

    def prox_rows(self, Y: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        """The prox of each row of ``Y`` [N, R] as a one-row factor at its own
        penalty ``rho`` [N, 1]: ``smooth`` couples rows only, so it leaves a
        single row as it is."""
        kinds = {d.kind for d in self._defs}
        if "smooth" in kinds:
            return Y
        if "custom" in kinds:
            return torch.cat([self.prox(Y[k:k + 1], rho[k, 0]) for k in range(Y.shape[0])])
        return self.prox(Y, rho)

    def update_rows(self, M: torch.Tensor, A: torch.Tensor, prev: torch.Tensor, *,
                    nnls_sweeps: int = 5, admm_iters: int = 10) -> torch.Tensor:
        """``update`` row by row with a Gram of each row's own: row ``n`` of
        the result is ``update(M[n:n+1], A[n], prev[n:n+1], ())``, the
        reference's ``vmap`` of the one-row solve, batched (M, prev [N, R];
        A [N, R, R]). ADMM starts from fresh duals, and no duals are
        returned."""
        R = A.shape[-1]
        eye = torch.eye(R, dtype=A.dtype, device=A.device)
        trace = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)                 # [N]
        if self.solver == "ridge":
            floor = torch.finfo(A.dtype).tiny * 128
            lam = torch.clamp(1e-10 * trace / R, min=floor)
            L, _ = torch.linalg.cholesky_ex(A + lam[:, None, None] * eye)
            return torch.cholesky_solve(M[..., None], L)[..., 0]
        if self.solver == "hals":
            diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-12)
            X = torch.clamp(prev, min=0.0)
            for _ in range(nnls_sweeps):
                for r in range(R):
                    numer = M[:, r] - (X * A[:, :, r]).sum(-1) + X[:, r] * A[:, r, r]
                    X[:, r] = torch.clamp(numer / diag[:, r], min=0.0)
            return X
        dt = M.dtype
        rho = torch.clamp(trace / R, min=1e-12).to(dt)[:, None]             # [N, 1]
        L, _ = torch.linalg.cholesky_ex(A.to(dt) + rho[:, :, None] * eye.to(dt))
        Z, U = self.prox_rows(prev, torch.ones_like(rho)), torch.zeros_like(prev)
        for _ in range(admm_iters):
            rhs = M + rho * (Z - U)
            X = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            Z = self.prox_rows(X + U, rho)
            U = U + X - Z
        return Z


def _canon(name: str, lam: float, d: TermDef) -> str:
    return f"{name}:{lam:g}" if d.default_lam or lam else name


@functools.lru_cache(maxsize=None)
def parse_spec(spec: str) -> Constraint:
    """Parse ``"name[:lam][+...]"`` into a :class:`Constraint`.

    Unknown names raise ``ValueError`` listing the registered terms;
    compositions without a closed-form joint prox raise too.
    """
    raw = [p.strip() for p in str(spec).split("+") if p.strip()]
    if not raw:
        raw = ["none"]
    terms = []
    for part in raw:
        name, _, lam_s = part.partition(":")
        name = name.strip()
        if name not in _REGISTRY:
            raise ValueError(
                f"unknown constraint {name!r} in spec {spec!r}; "
                f"registered constraints: {', '.join(available())}")
        d = _REGISTRY[name]
        if lam_s and d.kind in ("none", "clip"):
            raise ValueError(
                f"constraint {name!r} is an indicator (no strength knob); "
                f"{part!r} is invalid")
        try:
            lam = float(lam_s) if lam_s else d.default_lam
        except ValueError:
            raise ValueError(f"bad strength {lam_s!r} in constraint {part!r}")
        if lam < 0:
            raise ValueError(f"negative strength in constraint {part!r}")
        terms.append((name, lam))
    # drop redundant "none" terms when composed with anything else
    if len(terms) > 1:
        terms = [t for t in terms if _REGISTRY[t[0]].kind != "none"] or terms[:1]
    kinds = [_REGISTRY[n].kind for n, _ in terms]
    if len(terms) > 1:
        if "custom" in kinds:
            raise ValueError(f"custom constraint terms do not compose: {spec!r}")
        if "smooth" in kinds:
            raise ValueError(
                f"no closed-form joint prox for {spec!r}: 'smooth' cannot be "
                f"composed with other terms (fit it on its own mode)")
        if not set(kinds) <= {"clip", "l1"}:
            raise ValueError(f"unsupported constraint composition {spec!r}")
    canon = "+".join(_canon(n, lam, _REGISTRY[n]) for n, lam in terms)
    return Constraint(spec=canon, terms=tuple(terms))


def bundle(specs: Mapping[str, str]) -> Dict[str, Constraint]:
    """Per-mode spec dict -> per-mode :class:`Constraint` dict (all of
    :data:`MODES` present; missing modes unconstrained)."""
    bad = set(specs) - set(MODES)
    if bad:
        raise ValueError(f"unknown constraint mode(s) {sorted(bad)}; "
                         f"valid modes: {MODES}")
    return {m: parse_spec(specs.get(m, "none")) for m in MODES}


def parse_constraint_arg(arg: str) -> Dict[str, str]:
    """Parse the launcher syntax ``"v=nonneg+l1:0.1,w=smooth:0.1"``.

    A bare spec with no ``mode=`` prefix applies to both V and W (the two
    modes the paper constrains). Every spec is parsed at once, so malformed
    input fails here with the registered-constraint listing.
    """
    out: Dict[str, str] = {}
    for part in (p.strip() for p in str(arg).split(",")):
        if not part:
            continue
        if "=" in part:
            mode, _, spec = part.partition("=")
            mode = mode.strip().lower()
            if mode not in MODES:
                raise ValueError(f"unknown constraint mode {mode!r} in "
                                 f"{arg!r}; valid modes: {MODES}")
            out[mode] = spec.strip()
        else:
            out.setdefault("v", part)
            out.setdefault("w", part)
    for spec in out.values():
        parse_spec(spec)   # raises with the registered-constraint listing
    return out


def constraint_summary(specs: Mapping[str, str]) -> Dict[str, str]:
    """Canonical per-mode specs (the ``--json`` summary block)."""
    return {m: parse_spec(specs.get(m, "none")).spec for m in MODES}


# ---------------------------------------------------------------------------
# AO-ADMM inner solver
# ---------------------------------------------------------------------------

def admm_solve(M: torch.Tensor, A: torch.Tensor, aux, prox: Callable,
               *, iters: int = 10):
    """AO-ADMM for ``min_X ||T - X G^T||^2 + r(X)`` in normal form.

    M:    [N, R] MTTKRP result (T G)
    A:    [R, R] Gram (G^T G)
    aux:  warm-start ``(Z, U)`` from the previous outer ALS iteration
    prox: ``prox(Y, rho) -> Z``, the prox of r at penalty rho

    Splitting (Huang, Sidiropoulos & Liavas 2016; COPA section 3):
        X  = (M + rho (Z - U)) (A + rho I)^{-1}     -- Cholesky solve
        Z  = prox(X + U, rho)
        U += X - Z
    with ``rho = max(trace(A)/R, 1e-12)``, a tensor on A's device, and the
    factor from ``cholesky_ex`` (``cholesky`` reads its info flag back to
    the host). Returns the feasible iterate Z and the updated ``(Z, U)``.
    """
    R = A.shape[-1]
    dt = M.dtype
    rho = torch.clamp(torch.trace(A) / R, min=1e-12).to(dt)
    L, _ = torch.linalg.cholesky_ex(
        A.to(dt) + rho * torch.eye(R, dtype=dt, device=A.device))
    Z, U = aux
    for _ in range(iters):
        rhs = M + rho * (Z - U)
        X = torch.cholesky_solve(rhs.T, L).T
        Z = prox(X + U, rho)
        U = U + X - Z
    return Z, (Z, U)


# ---------------------------------------------------------------------------
# aux helpers (the ALS step keeps the duals aligned with column rescales)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, x):
    """``fn`` on every leaf of a nested dict/list/tuple, the nesting kept
    (what the reference's ``jax.tree_util.tree_map`` does to ``aux``); a
    NamedTuple stays its own type."""
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [tree_map(fn, v) for v in x]
    if isinstance(x, tuple):
        vals = [tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return fn(x)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (``jax.tree_util.tree_leaves``):
    dict keys sorted, lists and tuples (NamedTuples too) in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure holding ``leaves``, given in :func:`tree_leaves`'s
    order (dicts keep ``like``'s key order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if isinstance(node, list):
                return vals
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def scale_aux(aux, col_scale: torch.Tensor):
    """Rescale every aux leaf columnwise, whenever the owning factor absorbs
    a column rescale, so that warm-started duals stay aligned. A no-op (no
    leaves) for direct constraints."""
    return tree_map(lambda a: a * col_scale[None, :], aux)


def empty_aux() -> Dict[str, Any]:
    """The aux of a fully direct (non-ADMM) constraint bundle."""
    return {m: () for m in MODES}
