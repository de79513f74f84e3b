"""Per-mode constraints for the PARAFAC2 factor updates (``repro.core.
constraints``), the paper's default bundle only.

Every factor update consumes only the MTTKRP ``M`` and the Gram ``A`` of the
fixed factors and solves ``min_X ||T - X G^T||^2 + r(X)``. Two terms are
ported: ``none`` (ridge solve, the default for H) and ``nonneg`` (HALS, the
paper's V and W). The registered AO-ADMM terms of the reference
(``nonneg_admm``, ``l1``, ``smooth`` and their compositions) raise
``NotImplementedError`` naming ROADMAP Queue A item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from repro_torch.core.nnls import hals_nnls, ridge_solve

__all__ = ["MODES", "Constraint", "bundle", "constraint_summary", "parse_spec"]

MODES = ("h", "v", "w")   # PARAFAC2 factor modes a spec dict may constrain

# name -> (solver, nonneg); the terms this port runs
_PORTED = {"none": ("ridge", False), "nonneg": ("hals", True)}
# terms the reference registers that wait for ROADMAP Queue A item 11
_NOT_PORTED = ("nonneg_admm", "l1", "smooth")


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A parsed per-mode constraint: ``spec`` is the canonical string."""

    spec: str

    @property
    def solver(self) -> str:
        return _PORTED[self.spec][0]

    @property
    def nonneg(self) -> bool:
        """True when fitted factors are elementwise nonnegative."""
        return _PORTED[self.spec][1]

    @property
    def penalized(self) -> bool:
        """True when the constraint adds a penalty term rather than only an
        indicator. The ALS step skips column normalisation for penalized
        modes; both ported terms are indicators."""
        return False

    def update(self, M: torch.Tensor, A: torch.Tensor, prev: torch.Tensor, *,
               nnls_sweeps: int = 5) -> torch.Tensor:
        """Solve ``min_X ||T - X G^T||^2 + r(X)`` from ``M = T G`` and
        ``A = G^T G`` (``prev`` warm-starts HALS). The reference also returns
        the carried ADMM state, which the direct solvers here do not have."""
        if self.solver == "ridge":
            return ridge_solve(M, A)
        return hals_nnls(M, A, prev, sweeps=nnls_sweeps)


def parse_spec(spec: str) -> Constraint:
    """Parse one mode's spec; only ``none`` and ``nonneg`` are ported."""
    raw = [p.strip() for p in str(spec).split("+") if p.strip()] or ["none"]
    if len(raw) > 1:       # "none" composed with anything is dropped
        raw = [p for p in raw if p != "none"] or ["none"]
    names = {p.partition(":")[0].strip() for p in raw}
    if len(raw) == 1 and raw[0] in _PORTED:
        return Constraint(spec=raw[0])
    if names <= set(_PORTED) | set(_NOT_PORTED):
        raise NotImplementedError(
            f"constraint {spec!r} needs the AO-ADMM constraint layer, not yet "
            "ported (ROADMAP Queue A item 11); ported: none, nonneg")
    raise ValueError(f"unknown constraint in spec {spec!r}; registered "
                     f"constraints: {', '.join(sorted(set(_PORTED) | set(_NOT_PORTED)))}")


def bundle(specs: Mapping[str, str]) -> Dict[str, Constraint]:
    """Per-mode spec dict -> per-mode :class:`Constraint` dict (all of
    :data:`MODES` present; missing modes unconstrained)."""
    bad = set(specs) - set(MODES)
    if bad:
        raise ValueError(f"unknown constraint mode(s) {sorted(bad)}; "
                         f"valid modes: {MODES}")
    return {m: parse_spec(specs.get(m, "none")) for m in MODES}


def constraint_summary(specs: Mapping[str, str]) -> Dict[str, str]:
    """Canonical per-mode specs (the ``--json`` summary block)."""
    return {m: c.spec for m, c in bundle(specs).items()}
