"""Dense MLP blocks: SwiGLU (llama-family) and GELU (whisper/older)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import act_fn, block_out, dense_init

__all__ = ["init_mlp", "mlp_block"]


def init_mlp(gen: torch.Generator, cfg, dtype, device, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    down_scale = 1.0 / math.sqrt(f * 2.0 * max(cfg.n_layers, 1))
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), **kw),
            "w_up": dense_init(gen, (d, f), **kw),
            "w_down": dense_init(gen, (f, d), scale=down_scale, **kw),
        }
    return {
        "w_up": dense_init(gen, (d, f), **kw),
        "w_down": dense_init(gen, (f, d), scale=down_scale, **kw),
    }


def mlp_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = act_fn(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    with block_out():
        return h @ p["w_down"]
