"""Mixture-of-Experts: token-choice top-k routing with sort-based dispatch,
as the reference's ``_moe_block_auto`` computes it.

Flatten the (token, expert) assignments, stable-sort them by expert, rank
each within its expert's group by ``searchsorted``, drop the ranks past
``capacity``, scatter the kept tokens into an [E, capacity, d] buffer (one
spare slot takes every dropped assignment, the reference's ``mode="drop"``),
run all experts as batched matmuls and combine with the router gates.
Capacity = max(8, round(T * k * capacity_factor / E + 0.5)). The
Switch-style load-balance aux loss is returned beside the output.

Under an installed ``DeviceMesh`` whose "model" dimension is larger than 1
and divides the experts and the sequence, ``moe_block`` takes the
reference's manual expert-parallel path (``_moe_block_manual``, its
``shard_map`` with all-to-alls) on ``torch.distributed``: each rank routes
its own tokens (the batch cut over "pod"/"data" where they divide it, the
sequence over "model") with a per-rank capacity, sends them to the experts'
owners along "model" with ``all_to_all_single``, runs its E / tp experts,
and sends the results back; the aux loss is the mean of the ranks'. The
block takes and returns replicated tensors (the port's LM runs replicated
on every rank) through the autograd collectives of
:mod:`repro_torch.dist.collectives`, so every rank ends with the whole
gradient. Elsewhere it takes the auto path (``_moe_block_auto``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import axis_group, current_mesh
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
    """Returns (output [B,S,d], aux_loss scalar): the manual expert-parallel
    path under a mesh whose "model" dimension (> 1) divides the experts and
    the sequence, the auto path otherwise (the reference's routing)."""
    mesh = current_mesh()
    if (mesh is not None and "model" in (mesh.mesh_dim_names or ())
            and cfg.n_experts % _axis_len(mesh, "model") == 0
            and _axis_len(mesh, "model") > 1
            and x.shape[1] % _axis_len(mesh, "model") == 0):
        return _moe_block_manual(p, x, cfg, mesh)
    return _moe_block_auto(p, x, cfg)


def _axis_len(mesh, name: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(name)]


def _moe_block_auto(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
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


# ---------------------------------------------------------------------------
# the manual expert-parallel path: all-to-alls over the "model" dimension
# ---------------------------------------------------------------------------

def _moe_block_manual(p: dict, x: torch.Tensor, cfg, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_block_manual`` on ``mesh`` (a ``DeviceMesh``):
    replicated ``x`` and ``p`` in, replicated (output, aux) out, every
    collective over ``mesh``'s process groups."""
    tp = _axis_len(mesh, "model")
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    dp = math.prod(_axis_len(mesh, a) for a in dp_axes)
    group = axis_group(mesh, dp_axes + ("model",))
    B = x.shape[0]

    # tokens cut over the dp dimensions where they divide the batch (else
    # every dp rank routes the same tokens) and over "model" along S
    split = dp > 1 and B % dp == 0
    tokens = [(a, 0) for a in dp_axes] * split + [("model", 1)]
    xb = col.to_local(x, mesh, tokens, group)
    wr = col.to_local(p["router"]["w"], mesh, [], group)
    wg, wu, wd = (col.to_local(p["experts"][n], mesh, [("model", 0)], group)
                  for n in ("w_gate", "w_up", "w_down"))
    out, aux = _local_moe(xb, wr, wg, wu, wd, cfg, tp, mesh.get_group("model"))
    out = col.from_local(out, mesh, tokens, scale=1.0 if split or dp == 1 else 1.0 / dp)
    aux = col.pmean(aux, group)
    if "shared" in p:
        from repro_torch.models.mlp import mlp_block

        out = out + mlp_block(p["shared"], x, cfg).to(out.dtype)
    return out, aux


def _local_moe(xb, wr, wg, wu, wd, cfg, tp: int, model_group):
    """One rank's block: xb [B_loc, S_loc, d]; wr [d, E]; wg/wu [E_loc, d, f];
    wd [E_loc, f, d]."""
    E, k = cfg.n_experts, cfg.experts_per_token
    Bl, Sl, d = xb.shape
    E_loc = E // tp
    Tl = Bl * Sl
    dev = xb.device
    # the capacity from the LOCAL token count, with the reference's integer
    # form of the capacity factor (Python's round, half to even)
    cap = max(8, -(-Tl * k * int(round(cfg.capacity_factor * 4)) // (4 * E)))
    xt = xb.reshape(Tl, d)
    logits = xt.float() @ wr
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    Tk = Tl * k
    flat_expert = expert_idx.reshape(Tk)
    flat_gate = gate_vals.reshape(Tk)
    flat_token = torch.arange(Tl, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.arange(Tk, device=dev) - first
    keep = rank < cap
    n_slots = E * cap
    dest = torch.where(keep, sorted_expert * cap + rank, n_slots)

    token_for_slot = torch.full((n_slots + 1,), -1, dtype=torch.long, device=dev)
    token_for_slot[dest] = sorted_token
    token_for_slot = token_for_slot[:n_slots]
    valid = token_for_slot >= 0
    hidden = xt[torch.clamp(token_for_slot, min=0)]
    hidden = torch.where(valid[:, None], hidden, torch.zeros((), dtype=hidden.dtype, device=dev))

    # to the experts' owners: recv [src, e, c] -> [e, src * cap + c]
    send = hidden.reshape(tp, E_loc, cap, d)
    recv = col.all_to_all(send, model_group)
    recv = recv.permute(1, 0, 2, 3).reshape(E_loc, tp * cap, d)

    act = act_fn(cfg.act)
    h = act(torch.bmm(recv, wg))
    h = h * torch.bmm(recv, wu)
    y = torch.bmm(h, wd)                                        # [E_loc, tp * cap, d]

    # back to the tokens' owners: global expert = owner * E_loc + e
    yb = y.reshape(E_loc, tp, cap, d).permute(1, 0, 2, 3)
    src = col.all_to_all(yb, model_group).reshape(n_slots, d)

    inv_order = torch.argsort(order, stable=True)
    slot_token_order = dest[inv_order]
    took = src[torch.clamp(slot_token_order, max=n_slots - 1)]
    took = torch.where((slot_token_order < n_slots)[:, None], took,
                       torch.zeros((), dtype=took.dtype, device=dev))
    contrib = took * flat_gate[:, None].to(took.dtype)
    out = contrib.reshape(Tl, k, d).sum(dim=1)

    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, flat_expert, torch.ones((Tk,), dtype=torch.float32, device=dev)) / Tk
    aux = E * torch.sum(me * ce)
    return out.reshape(Bl, Sl, d).to(xb.dtype), aux
