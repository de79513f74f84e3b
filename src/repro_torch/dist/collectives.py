"""Collectives with gradients: the reference's ``shard_map`` semantics for
the LM on a mesh, in eager torch.

The port's LM runs replicated on every rank: each holds every parameter
and every activation whole, since eager torch has no sharding constraint.
A region the reference runs under ``shard_map`` (the manual
expert-parallel MoE, :func:`repro_torch.models.moe._moe_block_manual`)
takes replicated tensors in, works on this rank's pieces, and gives
replicated tensors back. These autograd functions carry the cuts across:

* :func:`to_local`: a replicated tensor -> this rank's block (a view). Its
  backward writes the block's cotangent into zeros of the whole and
  all-reduces them over the region's group, so that every rank holds the
  whole gradient: what ``shard_map``'s transpose sums over the ranks.
* :func:`from_local`: this rank's block -> the replicated whole
  (all-gathers, one mesh dimension at a time). Its backward takes the
  rank's own block of the cotangent, which every rank holds whole; a sum
  (what ``torch.distributed.nn.functional.all_gather``'s backward does)
  would count it once a rank.
* :func:`all_to_all`: ``all_to_all_single`` over a group, whose backward is
  the same exchange of the cotangent.
* :func:`pmean`: a value of each rank -> their mean on every rank. Its
  backward hands each rank 1/n of the (replicated) cotangent.

A cut is ``(mesh dimension name, tensor dim)``; cuts of one tensor dim
nest in the order given (outer first: ``("pod", 0), ("data", 0)`` is the
reference's ``P(("pod", "data"))``). Dimensions of size 1 cut nothing.
Every collective is issued even on a world of one, and reports its operand
to :func:`repro_torch.analysis.comm.record_collectives`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.comm import note

__all__ = ["all_to_all", "from_local", "pmean", "to_local"]

Cut = Tuple[str, int]


def _blocks(mesh, cuts: Sequence[Cut]) -> List[Tuple[object, int, int, int]]:
    """(group, tensor dim, this rank's index, count) per cut of a dimension
    of size > 1."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for name, dim in cuts:
        count = mesh.shape[names.index(name)]
        if count > 1:
            out.append((mesh.get_group(name), dim, mesh.get_local_rank(name), count))
    return out


def _narrow(x: torch.Tensor, blocks) -> torch.Tensor:
    for _, dim, index, count in blocks:
        size = x.shape[dim] // count
        x = x.narrow(dim, index * size, size)
    return x


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, group):
        ctx.blocks, ctx.group, ctx.shape = blocks, group, x.shape
        return _narrow(x, blocks) if blocks else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        whole = g.new_zeros(ctx.shape)
        _narrow(whole, ctx.blocks).copy_(g)
        note("all-reduce", whole)
        dist.all_reduce(whole, op=dist.ReduceOp.SUM, group=ctx.group)
        return whole, None, None


class _FromLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, scale):
        ctx.blocks, ctx.scale = blocks, scale
        if not blocks:
            return x.view_as(x)
        for group, dim, _, count in reversed(blocks):     # the innermost cut first
            parts = [torch.empty_like(x) for _ in range(count)]
            note("all-gather", x)
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.blocks) * ctx.scale, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        note("all-to-all", x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        note("all-to-all", g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        y = x.detach().reshape(1).clone()
        note("all-reduce", y)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return (y / ctx.n).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def to_local(x: torch.Tensor, mesh, cuts: Sequence[Cut], group) -> torch.Tensor:
    """This rank's block of the replicated ``x`` under ``cuts``; the
    backward all-reduces the zero-padded cotangent over ``group``."""
    return _ToLocal.apply(x, _blocks(mesh, cuts), group)


def from_local(x: torch.Tensor, mesh, cuts: Sequence[Cut], scale: float = 1.0) -> torch.Tensor:
    """The whole of which ``x`` is this rank's block under ``cuts``; the
    backward is the rank's block of the cotangent times ``scale`` (1/r
    where r ranks hold the same block, so that a sum over every rank
    counts it once)."""
    return _FromLocal.apply(x, _blocks(mesh, cuts), float(scale))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of ``x``'s dim 0 to the group's rank i; block i of the result
    from rank i."""
    return _AllToAll.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of the ranks' ``x`` (a scalar) over ``group``, on every rank."""
    return _PMean.apply(x, group)
