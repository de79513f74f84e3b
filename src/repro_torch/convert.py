"""Carry PARAFAC2 factors between the JAX package and the port.

The reference's ``Parafac2State`` leaves, as numpy arrays, become the port's
state on a chosen device and dtype, and back. This is how a parity test
starts both packages from the same state: ``torch.Generator`` cannot
reproduce the reference's ``jax.random`` initialisation.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.parafac2 import Parafac2State
from repro_torch.device import resolve_device

__all__ = ["state_from_arrays", "state_to_arrays"]


def state_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda",
                      dtype: torch.dtype = torch.float32) -> Parafac2State:
    """``{"H", "V", "W"[, "fit"]}`` numpy arrays -> :class:`Parafac2State`
    (global W layout; ``fit`` defaults to -inf, the fresh-start value) on
    ``device``, a GPU by default (raises without one unless ``"cpu"``)."""
    missing = {"H", "V", "W"} - set(arrays)
    if missing:
        raise KeyError(f"state arrays lack {sorted(missing)}")
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    return Parafac2State(H=t(arrays["H"]), V=t(arrays["V"]), W=t(arrays["W"]),
                         fit=t(arrays.get("fit", -np.inf)))


def state_to_arrays(state: Parafac2State) -> dict:
    """The inverse: a state's H, V, W and fit as numpy arrays on the host."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in ("H", "V", "W", "fit")}
