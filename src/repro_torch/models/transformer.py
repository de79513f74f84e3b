"""Unified decoder stack: pattern-based blocks over stacked layer groups, as
the reference's ``repro.models.transformer`` builds it.

Every architecture is a repeating ``pattern`` of block kinds:
  dense        ("attn_mlp",)
  qwen3        ("attn_mlp",) + qk_norm
  phi3.5-moe   ("attn_moe",)
  llama4       ("attn_mlp", "attn_moe")          # interleaved MoE
  recurrentgemma ("rglru", "rglru", "attn_local")
  mamba2       ("mamba",)
  whisper dec  ("attn_cross_mlp",)

The parameters of the ``n_layers // len(pattern)`` groups are stacked on a
leading layer axis exactly as the reference stacks them (so a parameter
tree carries across leaf for leaf); the remainder layers sit in ``rem``.
Forward and decode are Python loops over the groups, then the remainder;
under ``cfg.remat`` a training forward recomputes each group in the
backward (:func:`remat`).
Caches are stacked the same way, and a decode step writes each layer's new
KV entries and recurrent states into its slice of the cache in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attn_block, init_attn
from repro_torch.models.common import (block_out_active, dense_init, rmsnorm, tree_leaves,
                                       tree_map, tree_stack, tree_unflatten)
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.rglru import init_rglru, init_rglru_cache, rglru_block
from repro_torch.models.ssm import init_mamba, init_mamba_cache, mamba_block

__all__ = [
    "default_pattern",
    "init_block",
    "apply_block",
    "init_stack",
    "remat",
    "stack_forward",
    "init_cache",
    "stack_decode",
    "init_lm",
    "encode",
    "lm_forward",
    "lm_decode",
]

ATTN_KINDS = ("attn_mlp", "attn_local", "attn_moe", "attn_cross_mlp", "enc_attn_mlp")


def default_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.block_pattern:
        return cfg.block_pattern
    if cfg.family == "ssm":
        return ("mamba",)
    if cfg.family == "moe" and cfg.n_experts:
        return ("attn_moe",)
    return ("attn_mlp",)


# ---------------------------------------------------------------------------
# Per-kind init / apply
# ---------------------------------------------------------------------------

def init_block(kind: str, gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Dict[str, Any]:
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    if kind in ("attn_mlp", "attn_local", "enc_attn_mlp"):
        return {"ln1_scale": zeros(), "attn": init_attn(gen, cfg, dtype, device),
                "ln2_scale": zeros(), "mlp": init_mlp(gen, cfg, dtype, device)}
    if kind == "attn_moe":
        return {"ln1_scale": zeros(), "attn": init_attn(gen, cfg, dtype, device),
                "ln2_scale": zeros(), "moe": init_moe(gen, cfg, dtype, device)}
    if kind == "attn_cross_mlp":
        return {"ln1_scale": zeros(), "attn": init_attn(gen, cfg, dtype, device),
                "lnx_scale": zeros(), "cross": init_attn(gen, cfg, dtype, device),
                "ln2_scale": zeros(), "mlp": init_mlp(gen, cfg, dtype, device)}
    if kind == "mamba":
        return {"ln1_scale": zeros(), "mamba": init_mamba(gen, cfg, dtype, device)}
    if kind == "rglru":
        return {"ln1_scale": zeros(), "rec": init_rglru(gen, cfg, dtype, device),
                "ln2_scale": zeros(), "mlp": init_mlp(gen, cfg, dtype, device)}
    raise ValueError(f"unknown block kind {kind}")


def apply_block(
    kind: str,
    p: Dict[str, Any],
    x: torch.Tensor,
    cfg: ArchConfig,
    ctx: Dict[str, Any],
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (x_out, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    window = cfg.local_window if kind == "attn_local" else 0
    causal = kind != "enc_attn_mlp"
    if kind in ATTN_KINDS:
        kv = cache.get("self") if cache else None
        cache_length, cache_slot = ctx.get("cache_length"), ctx.get("cache_slot")
        if kv is not None and kind == "attn_local" and window:
            # ring buffer: the cache holds only the last `window` keys; the
            # slot wraps, the valid count saturates, no window mask needed
            W = kv[0].shape[1]
            pos = ctx["pos"]
            cache_slot = pos % W
            cache_length = torch.clamp(ctx["cache_length"], max=W)
        y, new_self = attn_block(
            p["attn"], h, cfg,
            positions=ctx["positions"], causal=causal, window=window if kv is None else 0,
            kv_cache=kv, cache_length=cache_length, cache_index=cache_slot,
        )
        x = x + y
        new_cache = {"self": new_self} if new_self is not None else ({} if cache else None)
        if kind == "attn_cross_mlp":
            hx = rmsnorm(x, p["lnx_scale"], cfg.norm_eps)
            cross_kv = cache.get("cross") if cache else ctx.get("cross_kv_fn")(p["cross"])
            y, _ = attn_block(p["cross"], hx, cfg, positions=ctx["positions"],
                              cross_kv=cross_kv, use_rope=False)
            x = x + y
            if new_cache is not None:
                new_cache["cross"] = cross_kv
        h2 = rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
        if kind == "attn_moe":
            y, aux = moe_block(p["moe"], h2, cfg)
        else:
            y = mlp_block(p["mlp"], h2, cfg)
        return x + y, new_cache, aux
    if kind == "mamba":
        y, new_cache = mamba_block(p["mamba"], h, cfg, cache=cache)
        return x + y, new_cache, aux
    if kind == "rglru":
        y, new_cache = rglru_block(p["rec"], h, cfg, cache=cache)
        x = x + y
        h2 = rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
        return x + mlp_block(p["mlp"], h2, cfg), new_cache, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack init / forward / decode
# ---------------------------------------------------------------------------

def _stack_meta(cfg: ArchConfig, n_layers: Optional[int], encoder: bool):
    n_layers = n_layers or cfg.n_layers
    pattern = ("enc_attn_mlp",) if encoder else default_pattern(cfg)
    return pattern, n_layers // len(pattern), n_layers % len(pattern)


def init_stack(gen: torch.Generator, cfg: ArchConfig, dtype, device, *,
               n_layers: Optional[int] = None, encoder: bool = False) -> Dict[str, Any]:
    """``{"groups": {"p{pos}_{kind}": params stacked over the groups (or {}
    with none)}, "rem": [params of each remainder layer]}``."""
    pattern, g, rem = _stack_meta(cfg, n_layers, encoder)
    groups = {}
    for pos, kind in enumerate(pattern):
        stacked = [init_block(kind, gen, cfg, dtype, device) for _ in range(g)]
        groups[f"p{pos}_{kind}"] = tree_stack(stacked) if g else {}
    rem_params = [init_block(pattern[i], gen, cfg, dtype, device) for i in range(rem)]
    return {"groups": groups, "rem": rem_params}


def _slice(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _save_block_outputs(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="save_block_outputs"``:
    keep the products that :func:`block_out` marks (the attention's and the
    MLP's output projections, the reference's ``block_out`` names),
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if block_out_active() and op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant), the
    counterpart of the reference's ``jax.checkpoint`` of a group:
    ``"nothing"`` saves nothing inside it, ``"save_block_outputs"`` keeps
    the marked block outputs (a selective-checkpoint policy). The forward
    draws no random numbers, so no RNG state is kept; the values are those
    of ``fn`` unwrapped."""
    from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                        noop_context_fn)

    if policy == "save_block_outputs":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_block_outputs)
    elif policy == "nothing":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {policy!r}")

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)

    return run


def stack_forward(stack_params, x, cfg: ArchConfig, ctx, *,
                  n_layers: Optional[int] = None,
                  encoder: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward through the whole stack. Returns (x, aux_sum).
    With ``cfg.remat`` and gradients enabled each group runs under
    :func:`remat` (never under ``no_grad``, as serving runs); the remainder
    layers never do, as in the reference."""
    pattern, g, rem = _stack_meta(cfg, n_layers, encoder)

    def group_fn(x, slices):
        aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos, kind in enumerate(pattern):
            x, _, aux = apply_block(kind, slices[f"p{pos}_{kind}"], x, cfg, ctx)
            aux_g = aux_g + aux
        return x, aux_g

    if cfg.remat and torch.is_grad_enabled():
        group_fn = remat(group_fn, cfg.remat_policy)
    # each stacked leaf unbound once: its gradient is one stack of the
    # groups' gradients, not a sum of zero-padded slices
    groups = stack_params["groups"]
    parts = [a.unbind(0) for a in tree_leaves(groups)]
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(g):
        x, aux_g = group_fn(x, tree_unflatten(groups, [p[i] for p in parts]))
        aux_acc = aux_acc + aux_g
    for i in range(rem):
        x, _, aux = apply_block(pattern[i], stack_params["rem"][i], x, cfg, ctx)
        aux_acc = aux_acc + aux
    return x, aux_acc


def _init_block_cache(kind, cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def kv(length):
        shp = (batch, length, KV, hd)
        return (torch.zeros(shp, dtype=dtype, device=device),
                torch.zeros(shp, dtype=dtype, device=device))

    if kind in ("attn_mlp", "attn_moe", "enc_attn_mlp"):
        return {"self": kv(max_len)}
    if kind == "attn_local":
        return {"self": kv(min(cfg.local_window or max_len, max_len))}
    if kind == "attn_cross_mlp":
        return {"self": kv(max_len), "cross": kv(cfg.encoder_seq)}
    if kind == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *, device,
               n_layers: Optional[int] = None):
    """Zero caches for every layer, stacked over the groups as the
    parameters are: KV pairs of ``max_len`` (``attn_local``: its window),
    mamba's conv contexts and f32 SSM state, RG-LRU's conv context and f32
    state."""
    pattern, g, rem = _stack_meta(cfg, n_layers, False)
    groups = {}
    for pos, kind in enumerate(pattern):
        groups[f"p{pos}_{kind}"] = (
            tree_map(lambda a: a[None].repeat((g,) + (1,) * a.ndim),
                     _init_block_cache(kind, cfg, batch, max_len, dtype, device))
            if g else {})
    rem_caches = [_init_block_cache(pattern[i], cfg, batch, max_len, dtype, device)
                  for i in range(rem)]
    return {"groups": groups, "rem": rem_caches}


def stack_decode(stack_params, cache, x, cfg: ArchConfig, ctx):
    """One decode step. Returns (x, cache): every layer's slice of the
    cache updated in place."""
    pattern, g, rem = _stack_meta(cfg, None, False)
    for i in range(g):
        p_slices = _slice(stack_params["groups"], i)
        c_slices = _slice(cache["groups"], i)
        for pos, kind in enumerate(pattern):
            key = f"p{pos}_{kind}"
            x, _, _ = apply_block(kind, p_slices[key], x, cfg, ctx, cache=c_slices[key])
    for i in range(rem):
        x, _, _ = apply_block(pattern[i], stack_params["rem"][i], x, cfg, ctx,
                              cache=cache["rem"][i])
    return x, cache


# ---------------------------------------------------------------------------
# Full language model (embed -> stack -> norm -> head)
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ArchConfig, device):
    """The reference's parameter tree, drawn with ``gen`` on ``device``."""
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    params = {
        "embed": {"tokens": dense_init(gen, (cfg.vocab_size, d), scale=0.02, dtype=dtype,
                                       device=device)},
        "layers": init_stack(gen, cfg, dtype, device),
        "final_norm_scale": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype, device=device)
    if cfg.n_prefix_embeds:
        params["patch_proj"] = dense_init(gen, (d, d), dtype=dtype, device=device)
    if cfg.is_encdec:
        params["encoder"] = init_stack(gen, cfg, dtype, device,
                                       n_layers=cfg.encoder_layers, encoder=True)
        params["enc_norm_scale"] = torch.zeros((d,), dtype=dtype, device=device)
    return params


def _embed(params, tokens, cfg, prefix_embeds=None):
    x = params["embed"]["tokens"][tokens]
    if cfg.n_prefix_embeds and prefix_embeds is not None:
        proj = prefix_embeds.to(x.dtype) @ params["patch_proj"]
        n = cfg.n_prefix_embeds
        pos_mask = (torch.arange(x.shape[1], device=x.device) < n)[None, :, None]
        pe = torch.zeros_like(x)
        pe[:, :n, :] = proj[:, :n, :]
        x = torch.where(pos_mask, pe, x)
    return x


def _head(params, x, cfg):
    x = rmsnorm(x, params["final_norm_scale"], cfg.norm_eps)
    head = params["embed"]["tokens"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def encode(params, frames, cfg: ArchConfig):
    """Whisper-style encoder over precomputed frame embeddings (conv stub)."""
    x = frames.to(getattr(torch, cfg.dtype))
    ctx = {"positions": torch.arange(x.shape[1], device=x.device)}
    x, _ = stack_forward(params["encoder"], x, cfg, ctx,
                         n_layers=cfg.encoder_layers, encoder=True)
    return rmsnorm(x, params["enc_norm_scale"], cfg.norm_eps)


def lm_forward(params, tokens, cfg: ArchConfig, *, prefix_embeds=None,
               encoder_frames=None):
    """Train/prefill forward. Returns (logits, aux_loss)."""
    x = _embed(params, tokens, cfg, prefix_embeds)
    ctx = {"positions": torch.arange(tokens.shape[1], device=tokens.device)}
    if cfg.is_encdec:
        enc = encode(params, encoder_frames, cfg)
        B, Fr, _ = enc.shape
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim

        def cross_kv_fn(p_cross):
            return ((enc @ p_cross["wk"]).reshape(B, Fr, KV, hd),
                    (enc @ p_cross["wv"]).reshape(B, Fr, KV, hd))

        ctx["cross_kv_fn"] = cross_kv_fn
    x, aux = stack_forward(params["layers"], x, cfg, ctx)
    return _head(params, x, cfg), aux


def lm_decode(params, cache, tokens, cfg: ArchConfig, *, pos):
    """One decode step for the whole batch (aligned streams at position
    ``pos``, an int or a 0-dim integer tensor). tokens [B, 1]. Returns
    (logits, cache), the cache updated in place."""
    x = _embed(params, tokens, cfg)
    pos = torch.as_tensor(pos, device=tokens.device)
    ctx = {
        "positions": pos.reshape(1, 1),                         # rope position
        "cache_length": (pos + 1).expand(tokens.shape[0]),      # linear caches
        "cache_slot": pos,                                      # attn_local: ring slot
        "pos": pos,
    }
    x, cache = stack_decode(params["layers"], cache, x, cfg, ctx)
    return _head(params, x, cfg), cache
