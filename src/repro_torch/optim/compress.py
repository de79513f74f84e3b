"""Error-feedback int8 gradient compression (``repro.optim.compress``).

Each gradient leaf is quantized to int8 with a per-leaf f32 scale; the
quantization residual is kept as error feedback and added to the next
step's gradient (EF-SGD). ``quantize``, ``dequantize`` and
``ef_compress_update`` are pure and run on one device;
``compressed_psum`` is the all-reduce of the int8 payloads over a
dimension of the installed ``DeviceMesh`` (``torch.distributed``: NCCL on
GPUs, gloo on the CPU).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = ["quantize", "dequantize", "ef_compress_update", "compressed_psum"]


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 payload, f32 scale). Symmetric per-tensor quantization;
    ``torch.round`` rounds half to even, as ``jnp.round`` does. Every
    divisor is a tensor: CUDA divides by a Python number as a product with
    its reciprocal, which can part from the quotient by an ulp."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)
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


def compressed_psum(grads: Any, errors: Any, axis_name):
    """The compressed all-reduce with error feedback over ``axis_name``, a
    dimension (or a tuple of dimensions, their flattened group) of the mesh
    installed with ``dist.sharding.axis_rules``: (reduced grads, new
    errors), trees like ``grads``.

    Per leaf, in the reference's leaf order: ``ef_compress_update``, an
    all-reduce of the int8 payload widened to int32 (no overflow past 127
    ranks) and one of the f32 scale, then payload sum x (scale sum / n) / n
    over the group's n ranks. That is the mean of the ranks' dequantized
    gradients only where their scales agree: the reference's rule, kept.
    The error feedback stays on its rank."""
    from repro_torch.analysis.comm import note
    from repro_torch.core.constraints import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import axis_group, current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a DeviceMesh: install one with "
                         "dist.sharding.axis_rules(rules, mesh)")
    names = tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)
    group = axis_group(mesh, names)
    size = float(torch.distributed.get_world_size(group))
    reduced, new_errors = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(errors)):
        q, s, _, new_e = ef_compress_update(g, e)
        n = s.new_tensor(size)          # a tensor divisor, as in quantize
        acc = q.to(torch.int32)
        s_sum = s.reshape(1).clone()
        note("all-reduce", acc)
        torch.distributed.all_reduce(acc, group=group)
        note("all-reduce", s_sum)
        torch.distributed.all_reduce(s_sum, group=group)
        reduced.append(acc.float() * (s_sum[0] / n) / n)
        new_errors.append(new_e)
    return tree_unflatten(grads, reduced), tree_unflatten(grads, new_errors)
