"""Batched orthogonal-Procrustes solvers for the PARAFAC2 Q_k step.

With B_k = X_k V S_k H^T (I_k x R), Q_k is the orthogonal polar factor of
B_k. Three batched solvers over B [Kb, I, R] (``repro.core.procrustes``):

* ``polar_svd``           — torch.linalg.svd of B_k (reference)
* ``polar_gram_eigh``     — inverse root of the R x R Gram B^T B (default)
* ``polar_newton_schulz`` — matmul-only Newton–Schulz iteration

The Gram-eigh polar forms G = B^T B and Q = B P_inv with ``torch.bmm``, as
the reference forms both with ``einsum`` outside Pallas; P_inv = G^{-1/2}
comes from P1 (:mod:`repro_torch.kernels.polar`) on CUDA tensors: a batched
Jacobi that never reads back to the host, so the step can be captured in a
CUDA graph; it runs most of its sweeps in f32 and finishes in f64, a thread
a subject up to R = 8, a warp a subject up to 64, a block past that. On the
CPU it is P1's plain version on ``torch.linalg.eigh``. Padded subjects
have B_k = 0 and get Q_k = 0 (never NaN). ``torch.linalg.svd`` on CUDA
reads its error flags back to the host, so the scan engine refuses
``svd`` on the card (:mod:`repro_torch.core.engine`); Newton-Schulz is
matmuls only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import polar

__all__ = ["polar_svd", "polar_gram_eigh", "polar_newton_schulz", "solve_q"]


def polar_svd(B: torch.Tensor) -> torch.Tensor:
    """Reference batched polar factor via thin SVD."""
    U, _, Vh = torch.linalg.svd(B, full_matrices=False)
    return U @ Vh


def polar_gram_eigh(B: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """Polar factor via eigendecomposition of the R x R Gram matrix:
    Q = B E diag(1/sqrt(lam)) E^T. Rank-deficient directions get a zero
    inverse root (pseudo-polar), the right limit for padded subjects."""
    G = B.transpose(1, 2) @ B                                # [Kb, R, R]
    return B @ polar.gram_inv_sqrt(G, eps)


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
