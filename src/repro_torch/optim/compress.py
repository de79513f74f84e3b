"""Error-feedback int8 gradient compression (``repro.optim.compress``).

Each gradient leaf is quantized to int8 with a per-leaf f32 scale; the
quantization residual is kept as error feedback and added to the next
step's gradient (EF-SGD). ``quantize``, ``dequantize`` and
``ef_compress_update`` are pure and run on one device; ``compressed_psum``,
the all-reduce over the LM's mesh, comes with the LM on a mesh (ROADMAP
A8c).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = ["quantize", "dequantize", "ef_compress_update", "compressed_psum"]


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 payload, f32 scale). Symmetric per-tensor quantization;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_update(grad: torch.Tensor, error: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One error-feedback step: returns (payload, scale, decoded, new_error)."""
    corrected = grad.float() + error
    q, s = quantize(corrected)
    decoded = dequantize(q, s)
    return q, s, decoded, corrected - decoded


def compressed_psum(grads: Any, errors: Any, axis_name: str):
    """The compressed all-reduce over a mesh axis: not ported yet."""
    raise NotImplementedError(
        "compressed_psum is a collective over the LM's mesh, which the port "
        "does not have yet (ROADMAP A8c, the LM on a mesh)")
