"""CP-ALS algebra shared by the PARAFAC2 step (``repro.core.cp``): Gram
utilities, column normalisation, one factor update, and a plain dense
CP-ALS (a reference for tests only; the PARAFAC2 step runs its one CP-ALS
iteration on the SPARTan MTTKRPs in ``repro_torch.core.parafac2``)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.nnls import hals_nnls, ridge_solve

__all__ = ["normalize_columns", "cp_gram", "factor_update", "CPState", "init_factors",
           "cp_als_dense"]


def normalize_columns(X: torch.Tensor, *, eps: float = 1e-12
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-normalize columns; return (normalized, norms)."""
    norms = torch.sqrt((X * X).sum(dim=0))
    return X / torch.clamp(norms, min=eps), norms


def cp_gram(*factors: torch.Tensor) -> torch.Tensor:
    """Hadamard product of the factors' Grams: prod_i (F_i^T F_i)."""
    G = None
    for F in factors:
        FtF = F.T @ F
        G = FtF if G is None else G * FtF
    return G


def factor_update(M: torch.Tensor, gram: torch.Tensor, prev: torch.Tensor, *,
                  nonneg: bool, nnls_sweeps: int = 5) -> torch.Tensor:
    """One ALS factor update from its MTTKRP M and Gram matrix: HALS from
    ``prev`` when ``nonneg``, else the ridge-stabilised solve."""
    if nonneg:
        return hals_nnls(M, gram, prev, sweeps=nnls_sweeps)
    return ridge_solve(M, gram)


class CPState(NamedTuple):
    U: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor
    lam: torch.Tensor


def init_factors(I: int, J: int, rank: int, *, nonneg: bool, seed: int,
                 dtype=torch.float32, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The initial U [I, rank] and V [J, rank] of :func:`cp_als_dense`:
    uniform on [0, 1) when ``nonneg``, else standard normal, from a
    ``torch.Generator`` seeded with ``seed`` (not the reference's
    ``jax.random`` bits: a parity test injects the reference's factors)."""
    gen = torch.Generator().manual_seed(seed)
    draw = torch.rand if nonneg else torch.randn
    U = draw((I, rank), generator=gen, dtype=dtype)
    V = draw((J, rank), generator=gen, dtype=dtype)
    return U.to(device), V.to(device)


def cp_als_dense(X: torch.Tensor, rank: int, *, iters: int = 50, nonneg: bool = False,
                 seed: int = 0, dtype=torch.float32) -> CPState:
    """Plain dense CP-ALS on an I x J x K tensor (reference / tests only)."""
    X = X.to(dtype)
    I, J, K = X.shape
    U, V = init_factors(I, J, rank, nonneg=nonneg, seed=seed, dtype=dtype, device=X.device)
    W = torch.ones((K, rank), dtype=dtype, device=X.device)
    X1 = X.reshape(I, J * K)                       # mode-1 unfolding (i, j*k)
    X2 = X.permute(1, 0, 2).reshape(J, I * K)
    X3 = X.permute(2, 0, 1).reshape(K, I * J)

    def kr(A, B):                                  # Khatri-Rao
        return (A[:, None, :] * B[None, :, :]).reshape(-1, A.shape[1])

    for _ in range(iters):
        U = factor_update(X1 @ kr(W, V), cp_gram(W, V), U, nonneg=nonneg)
        U, _ = normalize_columns(U)
        V = factor_update(X2 @ kr(W, U), cp_gram(W, U), V, nonneg=nonneg)
        V, _ = normalize_columns(V)
        W = factor_update(X3 @ kr(V, U), cp_gram(V, U), W, nonneg=nonneg)
    W, lam = normalize_columns(W)
    return CPState(U=U, V=V, W=W, lam=lam)
