"""One machine-readable summary schema for the launchers
(``repro.launch.summary``).

:func:`run_summary` stamps ``schema_version`` (2, as the reference), ``kind``
and ``resolved_options``, the canonical option block; launcher payload keys
stay at the top level.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


from repro_torch.core.compress import preprocess_summary
from repro_torch.core.constraints import constraint_summary

__all__ = ["SCHEMA_VERSION", "resolved_options", "run_summary"]

SCHEMA_VERSION = 2


def resolved_options(opts=None, **extra) -> Dict[str, Any]:
    """Canonical option block from a ``Parafac2Options`` (+ launcher extras),
    with the reference's keys; the constraint and compress specs resolved
    (``repro_torch.core.constraints`` / ``repro_torch.core.compress``), so
    that two spellings of one spec give one block."""
    block: Dict[str, Any] = {}
    if opts is not None:
        block.update(
            rank=opts.rank,
            engine=opts.engine,
            backend=opts.backend,
            check_every=opts.check_every,
            w_layout=opts.w_layout,
            procrustes=opts.procrustes,
            dtype=str(opts.dtype).removeprefix("torch."),
            constraints=constraint_summary(opts.constraint_specs()),
            compress=preprocess_summary(opts.compress, opts.rank),
        )
    block.update(extra)
    return block


def run_summary(kind: str, options: Optional[Dict[str, Any]] = None,
                **payload) -> Dict[str, Any]:
    """Assemble one schema-stamped launcher summary; ``payload`` keys land at
    the top level and must not collide with the schema keys."""
    reserved = {"schema_version", "kind", "resolved_options"}
    clash = reserved & set(payload)
    if clash:
        raise ValueError(f"summary payload keys {sorted(clash)} collide with "
                         f"the schema block")
    return {"schema_version": SCHEMA_VERSION, "kind": kind,
            "resolved_options": dict(options or {}), **payload}
