"""Batched orthogonal-Procrustes solvers for the PARAFAC2 Q_k step.

With B_k = X_k V S_k H^T (I_k x R), Q_k is the orthogonal polar factor of
B_k. Three batched solvers over B [Kb, I, R] (``repro.core.procrustes``):

* ``polar_svd``           — torch.linalg.svd of B_k (reference)
* ``polar_gram_eigh``     — eigh of the R x R Gram B^T B (default)
* ``polar_newton_schulz`` — matmul-only Newton–Schulz iteration

``torch.linalg.eigh`` on a [Kb, R, R] batch is plain algebra, left outside
the kernels as the JAX package leaves it outside Pallas. Padded subjects have
B_k = 0 and get Q_k = 0 (never NaN).
"""
from __future__ import annotations

import torch

__all__ = ["polar_svd", "polar_gram_eigh", "polar_newton_schulz", "solve_q"]

# cuSOLVER's batched eigh refuses large batches of small matrices: on an H100
# with torch 2.11 / CUDA 12.8 the main path's largest bucket at choa scale
# 0.25 (58,112 5x5 Grams) raised CUSOLVER_STATUS_INVALID_VALUE. A CUDA batch
# is split into runs of at most this many.
EIGH_BATCH = 16384


def _batched_eigh(G: torch.Tensor):
    if not G.is_cuda or G.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(G)
    parts = [torch.linalg.eigh(g) for g in G.split(EIGH_BATCH)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def polar_svd(B: torch.Tensor) -> torch.Tensor:
    """Reference batched polar factor via thin SVD."""
    U, _, Vh = torch.linalg.svd(B, full_matrices=False)
    return U @ Vh


def polar_gram_eigh(B: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """Polar factor via eigendecomposition of the R x R Gram matrix:
    Q = B E diag(1/sqrt(lam)) E^T. Rank-deficient directions get a zero
    inverse root (pseudo-polar), the right limit for padded subjects."""
    G = B.transpose(1, 2) @ B                                # [Kb, R, R]
    lam, E = _batched_eigh(G)                                # ascending
    scale = torch.clamp(lam, min=0.0)
    tol = scale.amax(dim=-1, keepdim=True) * eps
    inv_root = torch.where(scale > tol,
                           torch.rsqrt(torch.maximum(scale, tol)),
                           torch.zeros_like(scale))
    P_inv = (E * inv_root[:, None, :]) @ E.transpose(1, 2)   # E diag E^T
    return B @ P_inv


def polar_newton_schulz(B: torch.Tensor, *, iters: int = 12) -> torch.Tensor:
    """Newton–Schulz polar: X <- 1.5 X - 0.5 X X^T X, pre-scaled by the
    Frobenius norm so that it converges."""
    norm = torch.sqrt((B * B).sum(dim=(1, 2))) + 1e-30
    X = B / norm[:, None, None]
    for _ in range(iters):
        X = 1.5 * X - 0.5 * (X @ (X.transpose(1, 2) @ X))
    return X


_SOLVERS = {
    "svd": polar_svd,
    "gram_eigh": polar_gram_eigh,
    "newton_schulz": polar_newton_schulz,
}


def solve_q(B: torch.Tensor, method: str = "gram_eigh", **kw) -> torch.Tensor:
    """Dispatch: batched Q_k = polar(B_k)."""
    try:
        fn = _SOLVERS[method]
    except KeyError:
        raise ValueError(f"unknown procrustes method {method!r}; "
                         f"options {sorted(_SOLVERS)}") from None
    return fn(B, **kw)
