"""Least-squares solvers behind the constraint layer's direct routes
(``repro.core.nnls``).

``hals_nnls`` solves min_{X >= 0} ||T - X G^T||_F from the MTTKRP M = T G
and the Gram A = G^T G by HALS column sweeps; ``ridge_solve`` is the
unconstrained update.
"""
from __future__ import annotations

import torch

__all__ = ["hals_nnls", "ridge_solve"]


def hals_nnls(M: torch.Tensor, A: torch.Tensor, X0: torch.Tensor, *,
              sweeps: int = 5, eps: float = 1e-12) -> torch.Tensor:
    """HALS sweeps for min_{X>=0} ||T - X G^T||, normal form X A = M.

    M [N, R] MTTKRP result; A [R, R] Gram; X0 [N, R] warm start.
    """
    R = A.shape[0]
    diag = torch.clamp(torch.diagonal(A), min=eps)
    X = torch.clamp(X0, min=0.0)                 # a fresh tensor: X0 is kept
    for _ in range(sweeps):
        for r in range(R):
            numer = M[:, r] - X @ A[:, r] + X[:, r] * A[r, r]
            X[:, r] = torch.clamp(numer / diag[r], min=0.0)
    return X


def ridge_solve(M: torch.Tensor, A: torch.Tensor, *,
                ridge: float = 1e-10) -> torch.Tensor:
    """Unconstrained ALS update X = M A^+ by a ridge-stabilised Cholesky
    solve. The ridge is floored at 128 x the dtype's smallest normal, so a
    collapsed Gram (A == 0) gives X == 0 instead of NaN; the floor is
    inactive for any non-degenerate Gram."""
    R = A.shape[0]
    floor = torch.finfo(A.dtype).tiny * 128
    lam = torch.clamp(ridge * torch.trace(A) / R, min=floor)
    A_reg = A + lam * torch.eye(R, dtype=A.dtype, device=A.device)
    L, _ = torch.linalg.cholesky_ex(A_reg)
    return torch.cholesky_solve(M.T, L).T
