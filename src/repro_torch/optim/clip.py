"""Global-norm gradient clipping (``repro.optim.clip``)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.constraints import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32: each leaf's sum of
    squares in the reference's leaf order (dict keys sorted), the leaf sums
    added from 0 with Python's ``sum``, as the reference adds them."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(grads scaled so that their global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    # jnp's promotion: a half leaf times the f32 scale is f32
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
                    grads), norm
