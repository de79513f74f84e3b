"""Decoupled AdamW on parameter trees (``repro.optim.adamw``).

First and second moments are f32 whatever the parameters' dtype; the update
is computed in f32 and cast back to each parameter's dtype (round to nearest
even). Pure: ``adamw_update`` returns new trees and mutates nothing, so a
caller may retry or rewind a step from the trees it still holds.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.constraints import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.clip import clip_by_global_norm

__all__ = ["AdamWState", "adamw_init", "adamw_update"]


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero f32 moments, each on its parameter's device; step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr,
    wd: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    clip_norm: float = 1.0,
) -> Tuple[Any, AdamWState]:
    """One step: the gradients cast to f32 and clipped to ``clip_norm``
    (0: no clip), the moments updated, bias-corrected, weight decay on
    every floating leaf. ``lr`` is a float or a 0-d f32 tensor."""
    grads = tree_map(lambda g: g.float(), grads)
    if clip_norm:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p.is_floating_point():
            delta = delta + wd * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*leaves) for leaves in zip(tree_leaves(params), tree_leaves(grads),
                                          tree_leaves(state.m), tree_leaves(state.v))]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(step=step, m=tree_unflatten(params, [o[1] for o in out]),
                       v=tree_unflatten(params, [o[2] for o in out])))
