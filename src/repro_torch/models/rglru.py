"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), as
the reference's ``repro.models.rglru`` computes it.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ u_t)

Train/prefill runs the first-order recurrence as the reference's
``lax.associative_scan`` does, level by level (log2 S levels of whole-tensor
ops); decode is the O(1) elementwise update. The full recurrent block is
conv1d -> RG-LRU on one branch, gated by a GeLU branch (Griffin Fig. 2).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.common import dense_init, gelu_tanh, sigmoid
from repro_torch.models.ssm import _causal_conv, softplus

__all__ = ["init_rglru", "rglru_block", "init_rglru_cache", "rglru_scan"]

_C = 8.0


def init_rglru(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, (d, w), **kw),            # recurrent branch
        "w_gate_branch": dense_init(gen, (d, w), **kw),
        "conv": {"w": dense_init(gen, (cfg.conv_width, w), **kw),
                 "b": torch.zeros((w,), **kw)},
        "wa": dense_init(gen, (w, w), scale=0.02, **kw),
        "wx": dense_init(gen, (w, w), scale=0.02, **kw),
        "ba": torch.zeros((w,), **f32),
        "bx": torch.zeros((w,), **f32),
        # Lambda init so a^c is in (0.9, 0.999) at r=1 — Griffin's init range
        "a_param": torch.full((w,), 0.7, **f32),
        "w_out": dense_init(gen, (w, d), scale=1.0 / math.sqrt(w * 2.0 * max(cfg.n_layers, 1)),
                            **kw),
    }


def _combine(x: Tuple[torch.Tensor, torch.Tensor], y: Tuple[torch.Tensor, torch.Tensor]):
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    a1, b1 = x
    a2, b2 = y
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along axis 1."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems):
    """``lax.associative_scan(_combine, elems, axis=1)``'s recursion: pairs
    combined, the odd positions scanned recursively, the even ones from
    them, so the products and sums run in the reference's order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """First-order recurrence h_t = a_t h_{t-1} + b_t.

    a, b: [B, S, W]. Returns h [B, S, W] (h0 folded into the first element).
    """
    if h0 is not None:
        b = b.clone()
        b[:, 0, :] += a[:, 0, :] * h0
    _, h = _associative_scan([a, b])
    return h


def init_rglru_cache(cfg, batch: int, dtype, device):
    w = cfg.rglru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_block(p: dict, x: torch.Tensor, cfg, *, cache: Optional[dict] = None):
    """Griffin recurrent block. Returns (y [B,S,d], cache or None): with a
    cache, its conv context and state are written in place."""
    B, S, d = x.shape
    gate = gelu_tanh(x @ p["w_gate_branch"])
    u = x @ p["w_in"]

    if cache is not None and S == 1:
        conv_out, conv_state = _causal_conv(u, p["conv"]["w"], p["conv"]["b"],
                                            state=cache["conv"])
    else:
        conv_out, conv_state = _causal_conv(u, p["conv"]["w"], p["conv"]["b"])
    uc = conv_out.float()

    r = sigmoid(uc @ p["wa"].float() + p["ba"])
    i = sigmoid(uc @ p["wx"].float() + p["bx"])
    log_a = -_C * softplus(p["a_param"])[None, None, :] * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uc)

    new_cache = None
    if cache is not None and S == 1:
        h = a[:, 0] * cache["h"] + gated_in[:, 0]
        hs = h[:, None, :]
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h)
        new_cache = cache
    else:
        h0 = cache["h"] if cache is not None else None
        hs = rglru_scan(a, gated_in, h0)
        if cache is not None:
            cache["conv"].copy_(conv_state)
            cache["h"].copy_(hs[:, -1, :])
            new_cache = cache

    y = (hs.to(x.dtype) * gate) @ p["w_out"]
    return y, new_cache
