"""The staged kernels' public wrappers with the full SPARTan bucket
semantics (``repro.kernels.ops``): ``subject_mask`` / ``col_mask`` zeroing
of padding and the dispatch between the YkV-reuse and the full forms, so
that :class:`repro_torch.core.backend.StagedBackend` can treat them as
drop-in equals of the ``core/spartan.py`` math.

The device decides the route: on CUDA tensors the kernels of
``csrc/staged.cu`` (and ``gather_matmul``'s of ``csrc/gather_matmul.cu``),
on the CPU their plain versions (the reference's ``use_pallas`` switch has
no counterpart).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather_matmul import gather_matmul
from repro_torch.kernels.mttkrp_mode1 import mode1, mode1_reuse
from repro_torch.kernels.mttkrp_mode2 import mode2_compact
from repro_torch.kernels.mttkrp_mode3 import mode3, mode3_reuse
from repro_torch.kernels.ykv import ykv

__all__ = ["ykv", "mttkrp_mode1", "mttkrp_mode2_compact", "mttkrp_mode3",
           "gather_matmul"]


def mttkrp_mode1(Yc: Optional[torch.Tensor], Vg: Optional[torch.Tensor],
                 Wb: torch.Tensor, *, subject_mask: Optional[torch.Tensor] = None,
                 YkV: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M1 partial [R,R]. With ``YkV`` given ([K,R,R] = Y_k V cached), Yc/Vg
    may be None and only the Hadamard + subject reduction runs."""
    if YkV is not None:
        return mode1_reuse(YkV, Wb, subject_mask)
    return mode1(Yc, Vg, Wb, subject_mask)


def mttkrp_mode2_compact(Yc: torch.Tensor, H: torch.Tensor, Wb: torch.Tensor, *,
                         col_mask: Optional[torch.Tensor] = None,
                         subject_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compact per-column A [K,C,R]; rows for masked columns/subjects are 0."""
    return mode2_compact(Yc, H, Wb, col_mask, subject_mask)


def mttkrp_mode3(Yc: Optional[torch.Tensor], Vg: Optional[torch.Tensor],
                 H: torch.Tensor, *, subject_mask: Optional[torch.Tensor] = None,
                 YkV: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M3 rows [K,R]. With ``YkV`` given, Yc/Vg may be None (coldot only)."""
    if YkV is not None:
        return mode3_reuse(YkV, H, subject_mask)
    return mode3(Yc, Vg, H, subject_mask)
