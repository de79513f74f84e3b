"""Attention: GQA with RoPE / qk-norm / sliding window, as the reference's
``repro.models.attention`` computes it.

* ``attend_train``  — chunked online-softmax (flash-style) attention over
  key blocks of ``block_kv``, a Python loop over the blocks in place of the
  reference's ``lax.scan``: O(S * block_kv) score memory, f32 scores.
* ``attend_decode`` — one query against a KV cache.
* cross-attention (whisper) reuses the chunked path without the causal mask.

All functions are batched [B, S, H, D] and GQA-aware (n_kv <= n_heads; q
heads grouped over kv heads). The arithmetic is the reference's, op for op;
no fused attention is called.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import apply_rope, block_out, dense_init, rmsnorm

__all__ = ["attend_train", "attend_decode", "init_attn", "attn_block"]

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*groups, D] by repeating kv heads."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _scale(D: int) -> float:
    """1 / sqrt(D) rounded as the reference's f32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def attend_train(
    q: torch.Tensor,            # [B, Sq, H, D]
    k: torch.Tensor,            # [B, Skv, KV, D]
    v: torch.Tensor,            # [B, Skv, KV, D]
    *,
    causal: bool = True,
    window: int = 0,            # sliding window (0 = full)
    q_offset: int = 0,          # absolute position of q[0] relative to k[0]
    block_kv: int = 1024,
) -> torch.Tensor:
    """Chunked online-softmax attention; padded keys of the last block,
    and keys outside the causal or sliding window, score ``NEG_INF``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    groups = H // KV
    k = _gqa_expand(k, groups)
    v = _gqa_expand(v, groups)
    dev = q.device
    qf = q.float() * _scale(D)

    nb = max(1, (Skv + block_kv - 1) // block_kv)
    pad = nb * block_kv - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for bidx in range(nb):
        kblk = k[:, bidx * block_kv:(bidx + 1) * block_kv]
        vblk = v[:, bidx * block_kv:(bidx + 1) * block_kv]
        k_pos = bidx * block_kv + torch.arange(block_kv, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk.float())
        mask = k_pos[None, :] <= Skv - 1                       # drop padded keys
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)                 # [B, Sq, H, D]


def attend_decode(
    q: torch.Tensor,            # [B, 1, H, D]
    k_cache: torch.Tensor,      # [B, Skv, KV, D]
    v_cache: torch.Tensor,
    *,
    length: torch.Tensor,       # [B] valid cache lengths (new token already in)
    window: int = 0,
) -> torch.Tensor:
    B, _, H, D = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    groups = H // KV
    dev = q.device
    qg = (q.float() * _scale(D)).reshape(B, KV, groups, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(Skv, device=dev)
    mask = pos[None, :] < length[:, None]
    if window:
        mask = mask & (pos[None, :] >= length[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention block (qkv proj + rope + attend + out proj)
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, (d, H * hd), **kw),
        "wk": dense_init(gen, (d, KV * hd), **kw),
        "wv": dense_init(gen, (d, KV * hd), **kw),
        "wo": dense_init(gen, (H * hd, d),
                         scale=1.0 / math.sqrt(H * hd * 2.0 * max(cfg.n_layers, 1)), **kw),
    }
    if cfg.qk_norm:
        p["q_norm_scale"] = torch.zeros((hd,), **kw)
        p["k_norm_scale"] = torch.zeros((hd,), **kw)
    return p


def attn_block(
    p: dict,
    x: torch.Tensor,                    # [B, S, d]
    cfg,
    *,
    positions: torch.Tensor,            # [S] or [B, S]
    causal: bool = True,
    window: int = 0,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,   # decode
    cache_length: Optional[torch.Tensor] = None,
    cache_index=None,                   # write slot (int or 0-dim tensor), S == 1
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,   # enc-dec
    use_rope: bool = True,
):
    """Returns (out [B,S,d], kv_cache or None). A decode step writes its k
    and v into ``kv_cache`` at ``cache_index`` in place (the reference's
    ``dynamic_update_slice``) and returns the same two tensors."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if cross_kv is None:
        k = (x @ p["wk"]).reshape(B, S, KV, hd)
        v = (x @ p["wv"]).reshape(B, S, KV, hd)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm_scale"], cfg.norm_eps)
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm_scale"], cfg.norm_eps)
    if use_rope and cross_kv is None:
        if positions.ndim == 1:
            positions = positions[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        kc, vc = kv_cache
        # the slot clamped into the cache, as dynamic_update_slice clamps it
        slot = torch.clamp(torch.as_tensor(cache_index, device=kc.device).reshape(1),
                           max=kc.shape[1] - S)
        kc.index_copy_(1, slot, k.to(kc.dtype))
        vc.index_copy_(1, slot, v.to(vc.dtype))
        new_cache = (kc, vc)
        out = attend_decode(q, kc, vc, length=cache_length, window=window)
    elif cross_kv is not None:
        out = attend_train(q, k, v, causal=False)
    else:
        out = attend_train(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, H * hd)
    with block_out():
        return out @ p["wo"], new_cache
