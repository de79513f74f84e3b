"""Roofline terms of a planned step on an NVIDIA H100 (the counterpart of
``repro.analysis.roofline``):

    compute term    = flops_per_device            / peak_flops
    memory term     = bytes_per_device            / hbm_bw
    collective term = collective_bytes_per_device / link_bw

The reference reads its counts from a compiled, partitioned XLA module
(``cost_analysis`` and the HLO text). Torch has neither, so the port's
planner (:mod:`repro_torch.launch.dryrun`) counts them itself: the flops
of one step of the whole (global) program on meta tensors
(``torch.utils.flop_counter``), the bytes its ops read and write, and
the collective bytes from the cell's shardings, each divided by the chips.
The record keeps the reference's ``hlo_`` names so that it reads like the
reference's. ``model_flops`` (6 N D, 2 N D) is the useful-work yardstick.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

__all__ = ["HW", "H100_SXM", "roofline_terms", "model_flops", "calibrate_flops_convention"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float      # per device, dense bf16
    hbm_bw: float          # device memory, bytes/s
    link_bw: float         # bytes/s a device into the fabric a pod mesh crosses
    hbm_bytes: int         # device memory, bytes (the budget a cell must fit)


# NVIDIA H100 SXM5 80GB at 700 W, datasheet figures: 989 TFLOP/s dense bf16
# on the tensor cores and 3.35 TB/s HBM3. A 256-card mesh spans 32 nodes of
# 8, so its collectives cross the inter-node fabric: one 400 Gb/s NDR port a
# GPU, 50e9 bytes/s (NVLink's 450 GB/s a direction holds only within a
# node). hbm_bytes is torch.cuda.get_device_properties(0).total_memory of an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (81,559 MiB by nvidia-smi),
# printed beside them by a run on the card.
H100_SXM = HW(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9,
              hbm_bytes=85_017_493_504)


def roofline_terms(costs: Dict[str, Any], *, hw: HW = H100_SXM) -> Dict[str, Any]:
    """The three roofline terms (seconds) and the raw counts, from a dict of
    per-device counts: ``flops``, ``bytes`` (read plus written by the ops)
    and ``collectives`` (bytes by kind, as
    :func:`repro_torch.analysis.comm.record_collectives` gives them, with
    ``"total"``)."""
    flops = float(costs.get("flops", 0.0))
    nbytes = float(costs.get("bytes", 0.0))
    coll = dict(costs.get("collectives") or {})
    total = float(coll.pop("total", sum(coll.values())))
    terms: Dict[str, Any] = {
        "hlo_flops": flops,
        "hlo_bytes": nbytes,
        "collective_bytes": total,
        "collective_breakdown": coll,
        "t_compute": flops / hw.peak_flops,
        "t_memory": nbytes / hw.hbm_bw,
        "t_collective": total / hw.link_bw,
    }
    dominant = max(("t_compute", "t_memory", "t_collective"), key=lambda k: terms[k])
    terms["bottleneck"] = dominant
    tmax = terms[dominant]
    # the share of the achievable step time (the dominant term, if every
    # term overlapped) that is useful compute
    terms["roofline_fraction_compute"] = terms["t_compute"] / tmax if tmax > 0 else 0.0
    return terms


def model_flops(cfg, shape, *, per_device: bool = True, n_chips: int = 1) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE) for a train step; 2*N*D for a
    forward-only (prefill) step; 2*N_active per token for decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_chips if per_device else total


def calibrate_flops_convention(mesh=None) -> str:
    """How the port's counts are taken: of the whole step's program (at its
    global shapes), then divided by the chips. The reference probes XLA's
    convention here; the port has none to probe."""
    return "global/n_chips"
