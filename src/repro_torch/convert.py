"""Carry PARAFAC2 states between the JAX package and the port.

The reference's ``Parafac2State`` leaves, as numpy arrays, become the port's
state on a chosen device and dtype, and back. This is how a parity test
starts both packages from the same state: ``torch.Generator`` cannot
reproduce the reference's ``jax.random`` initialisation. A bucketed W is a
list (or tuple) of per-bucket arrays; ``aux``, the constraint layer's duals,
is the reference's nested dict of tuples and lists of arrays. Under the
mesh engine each rank takes the whole of the replicated leaves and its own
rows of a bucketed W and of that W's duals (``shard=``).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import tree_map
from repro_torch.core.parafac2 import Parafac2State
from repro_torch.device import resolve_device

__all__ = ["state_from_arrays", "state_to_arrays"]


def state_from_arrays(arrays: Mapping, device="cuda", dtype: torch.dtype = torch.float32,
                      shard: Tuple[int, int] = (0, 1)) -> Parafac2State:
    """``{"H", "V", "W"[, "fit"][, "aux"]}`` arrays -> :class:`Parafac2State`
    on ``device``, a GPU by default (raises without one unless ``"cpu"``).
    ``W`` is one [K, R] array, or a list of per-bucket [Kb, R] arrays (the
    bucketed layout, a tuple in the state); ``fit`` defaults to -inf, the
    fresh-start value; ``aux`` to none (``init_state`` then makes the
    duals). ``shard=(index, count)``: a mesh rank's state, with chunk
    ``index`` of ``count`` of each bucketed W's rows (and of their duals'),
    the rest whole; the chunks are the rows ``bucketize(shard=...)`` gives
    that rank."""
    missing = {"H", "V", "W"} - set(arrays)
    if missing:
        raise KeyError(f"state arrays lack {sorted(missing)}")
    device = resolve_device(device)
    index, count = shard

    def t(a):
        return torch.tensor(np.array(a), dtype=dtype, device=device)

    def rows(a):
        a = np.array(a)
        n = a.shape[0] // count
        return t(a[index * n:(index + 1) * n])

    W = arrays["W"]
    bucketed = isinstance(W, (list, tuple))
    W = tuple(rows(w) for w in W) if bucketed else t(W)
    aux = arrays.get("aux", ())
    if isinstance(aux, Mapping):
        aux = {k: tree_map(rows if (k == "w" and bucketed) else t, v) for k, v in aux.items()}
    else:
        aux = tree_map(t, aux)
    return Parafac2State(H=t(arrays["H"]), V=t(arrays["V"]), W=W,
                         fit=t(arrays.get("fit", -np.inf)), aux=aux)


def state_to_arrays(state: Parafac2State) -> dict:
    """The inverse: the state's H, V, W (a list for the bucketed layout),
    fit and aux as numpy arrays on the host."""
    def a(x):
        return x.detach().cpu().numpy()

    W = [a(w) for w in state.W] if isinstance(state.W, tuple) else a(state.W)
    return {"H": a(state.H), "V": a(state.V), "W": W, "fit": a(state.fit),
            "aux": tree_map(a, state.aux)}
