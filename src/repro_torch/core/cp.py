"""CP-ALS algebra shared by the PARAFAC2 step (``repro.core.cp``)."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["cp_gram", "normalize_columns"]


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
