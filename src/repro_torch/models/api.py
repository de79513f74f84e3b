"""Public model API, the serving half of the reference's ``repro.models.api``:
``build(cfg)`` returns a :class:`ModelBundle` with parameter init, prefill
and decode steps, the cache and ``input_specs(shape)``, meta-device tensors
standing in for every model input of a cell (no allocation).

The training half (``train_step``, ``init_opt``, ``cross_entropy``,
microbatches) comes with the port's optimizers (ROADMAP A8b); until then
the bundle has no such fields.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_cache, init_lm, lm_decode, lm_forward

__all__ = ["ModelBundle", "build"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]
    prefill_step: Callable[..., torch.Tensor]
    decode_step: Callable[..., Any]
    input_specs: Callable[[str], Dict[str, Any]]
    init_cache: Callable[..., Any]


def _extra_inputs(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    """Modality-stub inputs (precomputed frame/patch embeddings)."""
    out = {}
    if cfg.is_encdec:
        out["encoder_frames"] = (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = (batch, cfg.n_prefix_embeds, cfg.d_model)
    return out


def build(cfg: ArchConfig) -> ModelBundle:
    dtype = getattr(torch, cfg.dtype)
    cache_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def init_params(generator: torch.Generator, device="cuda"):
        """The parameter tree on ``device`` (a GPU by default; raises
        without one unless ``"cpu"``), drawn from ``generator``, a
        ``torch.Generator`` on that device."""
        return init_lm(generator, cfg, device=resolve_device(device))

    def prefill_step(params, batch):
        extra = {k: batch[k] for k in ("encoder_frames", "prefix_embeds") if k in batch}
        logits, _ = lm_forward(params, batch["tokens"], cfg, **extra)
        return logits

    def decode_step(params, cache, tokens, pos):
        """(logits [B, 1, V], cache): the cache is updated in place."""
        return lm_decode(params, cache, tokens, cfg, pos=pos)

    def _cache(batch: int, max_len: int, device="cuda"):
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        return init_cache(cfg, batch, max_len, dtype=cache_dtype, device=device)

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
            for k, shp in _extra_inputs(cfg, B).items():
                out[k] = meta(shp, dtype)
            return ({"batch": out, "step": meta((), i32)} if spec.kind == "train"
                    else {"batch": out})
        # decode: KV/state cache of seq_len, one new token
        return {"cache": _cache(B, S, device="meta"), "tokens": meta((B, 1), i32),
                "pos": meta((), i32)}

    return ModelBundle(cfg=cfg, init_params=init_params, prefill_step=prefill_step,
                       decode_step=decode_step, input_specs=input_specs,
                       init_cache=_cache)
