"""Collective-communication byte accounting (the counterpart of
``repro.analysis.hlo``).

The reference parses the partitioned HLO text and sums, for every
all-gather, all-reduce, reduce-scatter, all-to-all and collective-permute,
the bytes of its operands: what each device puts into the interconnect for
that op. Torch has no HLO text, so the port counts the collectives its own
program issues instead: every site that calls ``torch.distributed``
(``dist.sharding.psum_subjects``, the autograd collectives of
``dist.collectives`` and ``optim.compress.compressed_psum``) reports its
operand through :func:`note`, and :func:`record_collectives` sums what was
reported while it is open.

The count is taken where the Python code issues the op: under CUDA-graph
capture it is counted once, at capture, and never at replay.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Sequence

import torch

__all__ = ["COLLECTIVE_KINDS", "CollectiveRecord", "note", "record_collectives",
           "shape_bytes"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def shape_bytes(dtype: torch.dtype, shape: Sequence[int]) -> int:
    """The bytes of a ``dtype`` tensor of ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype, device="meta").element_size()


class CollectiveRecord(dict):
    """The reference's dict of operand bytes by collective kind plus
    ``"total"``; ``calls`` counts the ops by kind."""

    def __init__(self):
        super().__init__({k: 0 for k in COLLECTIVE_KINDS}, total=0)
        self.calls: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}

    def add(self, kind: str, nbytes: int) -> None:
        self[kind] += nbytes
        self["total"] += nbytes
        self.calls[kind] += 1


_OPEN: list = []       # the open records (process-wide: autograd runs a CUDA
                       # backward on a thread of its own)


def note(kind: str, t: torch.Tensor) -> None:
    """Report one collective of ``kind`` whose operand on this rank is
    ``t`` to every open :func:`record_collectives`."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    nbytes = t.numel() * t.element_size()
    for rec in _OPEN:
        rec.add(kind, nbytes)


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveRecord]:
    """Yield a :class:`CollectiveRecord` that sums the operand bytes of
    every collective the process issues until the block ends (records
    nest: an inner one's ops count in the outer one too)."""
    rec = CollectiveRecord()
    _OPEN.append(rec)
    try:
        yield rec
    finally:
        _OPEN.remove(rec)
