"""Public model API (the reference's ``repro.models.api``): ``build(cfg)``
returns a :class:`ModelBundle` with parameter init, the optimizer's init and
``train_step`` (cross entropy plus the MoE aux loss, gradients by
``torch.autograd.grad``, microbatches, AdamW on the WSD schedule), prefill
and decode steps, the cache and ``input_specs(shape)``, meta-device tensors
standing in for every model input of a cell (no allocation).

The step functions are pure on the caller's trees: ``train_step`` returns
new parameter and optimizer trees and mutates neither (the gradients are
taken on detached copies of the leaves); ``decode_step`` alone writes into
the cache it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.transformer import init_cache, init_lm, lm_decode, lm_forward
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import wsd_schedule

__all__ = ["AUX_COEF", "ModelBundle", "build", "cross_entropy", "loss_and_grads",
           "stub_shapes"]

AUX_COEF = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, ignore: int = -1):
    """Mean CE over valid labels, in f32; logits [B,S,V] (any float dtype),
    labels [B,S]. The gold logit is a gather at ``max(label, 0)``: the
    reference's masked sum over the vocabulary adds zeros to that one
    value, so both give the same bits. A batch with every label ignored
    gives 0."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = (labels != ignore).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _loss(cfg: ArchConfig, params, batch):
    extra = {k: batch[k] for k in ("encoder_frames", "prefix_embeds") if k in batch}
    logits, aux = lm_forward(params, batch["tokens"], cfg, **extra)
    loss = cross_entropy(logits, batch["labels"])
    return loss + AUX_COEF * aux, loss, aux


def _grad(cfg: ArchConfig, params, batch):
    leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in tree_leaves(params)]
    with torch.enable_grad():
        total, ce, aux = _loss(cfg, tree_unflatten(params, leaves), batch)
        live = [p for p in leaves if p.requires_grad]
        got = iter(torch.autograd.grad(total, live, allow_unused=True))
    grads = [next(got) if p.requires_grad else None for p in leaves]
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return total.detach(), ce.detach(), aux.detach(), tree_unflatten(params, grads)


def loss_and_grads(cfg: ArchConfig, params, batch, microbatches: int = 1):
    """(total, ce, aux, grads) of ``train_step``: the loss is the cross
    entropy plus ``AUX_COEF`` times the MoE aux loss; the gradients of it
    are taken by ``torch.autograd.grad`` on detached copies of the leaves
    (the caller's tree is never touched), each in its parameter's dtype.
    With ``microbatches > 1`` the batch is split along dim 0 and the
    micro-steps run one after another: their f32 gradients are summed into
    zeros in order, ``tot``, ``ce`` and ``aux`` summed from 0.0, and all
    divided by n, as the reference's scan does."""
    if microbatches <= 1:
        return _grad(cfg, params, batch)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    tot = ce = aux = 0.0
    for i in range(microbatches):
        mb = {k: v[i * (v.shape[0] // microbatches):(i + 1) * (v.shape[0] // microbatches)]
              for k, v in batch.items()}
        t, c, a, g = _grad(cfg, params, mb)
        acc = [s + x.float() for s, x in zip(acc, tree_leaves(g))]
        tot, ce, aux = tot + t, ce + c, aux + a
    n = float(microbatches)
    return tot / n, ce / n, aux / n, tree_unflatten(params, [g / n for g in acc])


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]
    init_opt: Callable[[Any], Any]
    train_step: Callable[..., Tuple[Any, Any, Dict[str, torch.Tensor]]]
    prefill_step: Callable[..., torch.Tensor]
    decode_step: Callable[..., Any]
    input_specs: Callable[[str], Dict[str, Any]]
    init_cache: Callable[..., Any]


def _device(device) -> torch.device:
    """``resolve_device``'s rule, and ``"meta"`` for trees of shapes only."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def stub_shapes(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    """The shapes of the modality-stub inputs (whisper's precomputed encoder
    frames, pixtral's patch embeddings), by batch key."""
    out = {}
    if cfg.is_encdec:
        out["encoder_frames"] = (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = (batch, cfg.n_prefix_embeds, cfg.d_model)
    return out


def build(cfg: ArchConfig, *, lr: float = 3e-4, wd: float = 0.1,
          total_steps: int = 10_000, microbatches: int = 1) -> ModelBundle:
    """``microbatches > 1`` accumulates gradients: the global batch is split
    along dim 0 into n micro-steps run one after another, whose f32
    gradients are summed and averaged (one optimizer update a step)."""
    dtype = getattr(torch, cfg.dtype)
    cache_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    sched = wsd_schedule(peak=lr, warmup=max(1, total_steps // 100),
                         total=total_steps, decay_frac=0.1)

    def init_params(generator: torch.Generator, device="cuda"):
        """The parameter tree on ``device`` (a GPU by default; raises
        without one unless ``"cpu"``), drawn from ``generator``, a
        ``torch.Generator`` on that device. On ``"meta"`` it is the tree's
        shapes and dtypes only (``generator`` may be None): the planner's
        stand-in for the reference's ``jax.eval_shape(init_params)``."""
        return init_lm(generator, cfg, device=_device(device))

    def train_step(params, opt_state, batch, step):
        """(params, opt_state, {"loss", "aux", "total"}): one AdamW update at
        the schedule's lr for ``step`` (0 at step 0, as the reference's)."""
        total, ce, aux, grads = loss_and_grads(cfg, params, batch, microbatches)
        params, opt_state = adamw_update(params, grads, opt_state, lr=sched(step), wd=wd)
        return params, opt_state, {"loss": ce, "aux": aux, "total": total}

    def prefill_step(params, batch):
        extra = {k: batch[k] for k in ("encoder_frames", "prefix_embeds") if k in batch}
        logits, _ = lm_forward(params, batch["tokens"], cfg, **extra)
        return logits

    def decode_step(params, cache, tokens, pos):
        """(logits [B, 1, V], cache): the cache is updated in place."""
        return lm_decode(params, cache, tokens, cfg, pos=pos)

    def _cache(batch: int, max_len: int, device="cuda"):
        return init_cache(cfg, batch, max_len, dtype=cache_dtype, device=_device(device))

    def input_specs(shape_name) -> Dict[str, Any]:
        """Meta-device stand-ins for every model input of this cell."""
        spec = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
        B, S = spec.global_batch, spec.seq_len

        def meta(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        i32 = torch.int32
        if spec.kind in ("train", "prefill"):
            out = {"tokens": meta((B, S), i32)}
            if spec.kind == "train":
                out["labels"] = meta((B, S), i32)
            for k, shp in stub_shapes(cfg, B).items():
                out[k] = meta(shp, dtype)
            return ({"batch": out, "step": meta((), i32)} if spec.kind == "train"
                    else {"batch": out})
        # decode: KV/state cache of seq_len, one new token
        return {"cache": _cache(B, S, device="meta"), "tokens": meta((B, 1), i32),
                "pos": meta((), i32)}

    return ModelBundle(cfg=cfg, init_params=init_params, init_opt=adamw_init,
                       train_step=train_step, prefill_step=prefill_step,
                       decode_step=decode_step, input_specs=input_specs,
                       init_cache=_cache)
