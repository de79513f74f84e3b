"""Shared model primitives: initializers, norms, RoPE, activations, and the
tree helpers the model code walks its parameters with (``tree_map``,
``tree_leaves`` and ``tree_unflatten`` are the port's ones, from
``repro_torch.core.constraints``)."""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.constraints import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "dense_init",
    "rmsnorm",
    "layernorm",
    "rope_freqs",
    "apply_rope",
    "act_fn",
    "block_out",
    "block_out_active",
    "gelu_tanh",
    "sigmoid",
    "silu",
    "cast",
    "tree_leaves",
    "tree_map",
    "tree_stack",
    "tree_unflatten",
]


def dense_init(generator: torch.Generator, shape: Sequence[int], *, device,
               scale: Optional[float] = None, dtype=torch.float32):
    """Truncated-normal fan-in init (LeCun-style): a standard normal cut at
    [-2, 2], times ``scale`` or 1/sqrt(fan_in); drawn in f32 on ``device``
    with ``generator`` (which lives there), then cast to ``dtype``."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) == 1 else shape[-2]
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain (zero-initialised scales)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] (broadcastable). Rotates the two
    halves of D against each other (split halves, not interleaved pairs)."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, device=x.device)                      # [D/2]
    ang = positions[..., None].float() * inv                         # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# The activations as the reference's program computes them: its StableHLO
# rounds every op to the input's dtype, and Python constants to that dtype
# first. At bf16 a fused F.silu or F.gelu rounds once and parts from it.

def _const(c: float, x: torch.Tensor) -> float:
    """``c`` rounded to ``x``'s dtype, as jnp rounds a Python constant."""
    return torch.tensor(c, dtype=x.dtype).item()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + e^-x)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form:
    x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))."""
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (1 + torch.tanh(inner)))


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``jax.nn.silu`` or ``jax.nn.gelu``, whose default is the tanh form."""
    if name in ("swiglu", "silu"):
        return silu
    if name == "gelu":
        return gelu_tanh
    raise ValueError(f"unknown activation {name}")


_BLOCK_OUT = [False]


@contextlib.contextmanager
def block_out():
    """Marks the products computed inside it as a block's output, the
    reference's ``checkpoint_name(y, "block_out")``: what
    ``remat_policy="save_block_outputs"`` keeps. A flag, read only by that
    policy; it changes no value."""
    _BLOCK_OUT[0] = True
    try:
        yield
    finally:
        _BLOCK_OUT[0] = False


def block_out_active() -> bool:
    return _BLOCK_OUT[0]


def tree_stack(trees: Sequence):
    """Stack same-shaped trees leaf by leaf on a new leading axis (the
    reference's ``tree_map(lambda *xs: jnp.stack(xs), *trees)``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(list(trees))


def cast(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype``."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
