"""Mixture-of-Experts: token-choice top-k routing with sort-based dispatch,
as the reference's ``_moe_block_auto`` computes it.

Flatten the (token, expert) assignments, stable-sort them by expert, rank
each within its expert's group by ``searchsorted``, drop the ranks past
``capacity``, scatter the kept tokens into an [E, capacity, d] buffer (one
spare slot takes every dropped assignment, the reference's ``mode="drop"``),
run all experts as batched matmuls and combine with the router gates.
Capacity = max(8, round(T * k * capacity_factor / E + 0.5)). The
Switch-style load-balance aux loss is returned beside the output.

The reference's manual expert-parallel path (``_moe_block_manual``, a
``shard_map`` with all-to-alls) runs only under an LM mesh, which the port
does not have yet (ROADMAP A8c); ``moe_block`` always takes the auto path.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.common import act_fn, dense_init

__all__ = ["init_moe", "moe_block", "top_k"]


def init_moe(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=device)
    down_scale = 1.0 / math.sqrt(f * 2.0 * max(cfg.n_layers, 1))
    p = {
        "router": {"w": dense_init(gen, (d, E), scale=0.02, dtype=torch.float32,
                                   device=device)},
        "experts": {
            "w_gate": dense_init(gen, (E, d, f), **kw),
            "w_up": dense_init(gen, (E, d, f), **kw),
            "w_down": dense_init(gen, (E, f, d), scale=down_scale, **kw),
        },
    }
    if cfg.shared_expert:
        from repro_torch.models.mlp import init_mlp

        p["shared"] = init_mlp(gen, cfg, dtype, device)
    return p


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index first
    (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,d], aux_loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dev = x.device
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]["w"]                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                       # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # ---- flatten assignments and sort by expert --------------------------
    Tk = T * k
    flat_expert = expert_idx.reshape(Tk)
    flat_gate = gate_vals.reshape(Tk)
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]

    capacity = max(8, int(round(T * k * cfg.capacity_factor / E + 0.5)))
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.arange(Tk, device=dev) - first
    keep = rank < capacity
    n_slots = E * capacity
    dest = torch.where(keep, sorted_expert * capacity + rank, n_slots)

    # ---- dispatch: the slot map with one spare slot for the dropped -------
    token_for_slot = torch.full((n_slots + 1,), -1, dtype=torch.long, device=dev)
    token_for_slot[dest] = sorted_token
    token_for_slot = token_for_slot[:n_slots]
    slot_valid = token_for_slot >= 0
    hidden = xt[torch.clamp(token_for_slot, min=0)]
    hidden = torch.where(slot_valid[:, None], hidden, torch.zeros((), dtype=hidden.dtype,
                                                                   device=dev))
    hidden_in = hidden.reshape(E, capacity, d)

    # ---- grouped expert matmuls -------------------------------------------
    act = act_fn(cfg.act)
    w = p["experts"]
    h = act(torch.bmm(hidden_in, w["w_gate"]))
    h = h * torch.bmm(hidden_in, w["w_up"])
    y = torch.bmm(h, w["w_down"])

    # ---- combine back to tokens (the inverse permutation, a gather) --------
    src = y.reshape(n_slots, d)
    inv_order = torch.argsort(order, stable=True)
    slot_token_order = dest[inv_order]                            # [Tk]
    took = src[torch.clamp(slot_token_order, max=n_slots - 1)]
    took = torch.where((slot_token_order < n_slots)[:, None], took,
                       torch.zeros((), dtype=took.dtype, device=dev))
    contrib = took * flat_gate[:, None].to(took.dtype)
    out = contrib.reshape(T, k, d).sum(dim=1)

    if "shared" in p:
        from repro_torch.models.mlp import mlp_block

        out = out + mlp_block(p["shared"], x, cfg).reshape(T, d).to(out.dtype)

    # ---- Switch-style load-balance aux loss -------------------------------
    me = probs.mean(dim=0)                                        # [E] router mass
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, flat_expert, torch.ones((Tk,), dtype=torch.float32, device=dev)) / Tk
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, d).to(x.dtype), aux
