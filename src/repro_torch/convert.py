"""Carry PARAFAC2 states and LM parameter trees between the JAX package and
the port.

The reference's ``Parafac2State`` leaves, as numpy arrays, become the port's
state on a chosen device and dtype, and back. This is how a parity test
starts both packages from the same state: ``torch.Generator`` cannot
reproduce the reference's ``jax.random`` initialisation. A bucketed W is a
list (or tuple) of per-bucket arrays; ``aux``, the constraint layer's duals,
is the reference's nested dict of tuples and lists of arrays. Under the
mesh engine each rank takes the whole of the replicated leaves and its own
rows of a bucketed W and of that W's duals (``shard=``). An LM's parameter
tree (nested dicts and lists of arrays) crosses the same way, leaf for leaf
(:func:`lm_params_from_arrays`, :func:`lm_params_to_arrays`), and so does
its AdamW state (:func:`opt_state_from_arrays`, :func:`opt_state_to_arrays`).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import tree_map
from repro_torch.core.parafac2 import Parafac2State
from repro_torch.device import resolve_device

__all__ = ["lm_params_from_arrays", "lm_params_to_arrays", "opt_state_from_arrays",
           "opt_state_to_arrays", "state_from_arrays", "state_to_arrays"]


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


def _leaf_to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: through its bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _leaf_to_array(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_from_arrays(tree, device="cuda", dtype: Optional[torch.dtype] = None):
    """The reference's LM parameter tree, as nested dicts and lists of
    numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), as the
    port's tree on ``device`` (a GPU by default; raises without one unless
    ``"cpu"``): each leaf keeps its dtype, or takes ``dtype``; bfloat16
    leaves (``ml_dtypes``) cross through their bits."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_to_tensor(a, device, dtype), tree)


def lm_params_to_arrays(params):
    """The inverse: the port's tree as numpy arrays on the host, bit for bit
    (bfloat16 leaves as ``ml_dtypes.bfloat16``)."""
    return tree_map(_leaf_to_array, params)


def opt_state_from_arrays(state, device="cuda"):
    """The reference's ``AdamWState`` with numpy leaves (``step``, ``m``,
    ``v``: ``jax.tree_util.tree_map(np.asarray, opt)``), or any
    ``(step, m, v)`` triple of arrays, as the port's
    :class:`~repro_torch.optim.AdamWState` on ``device`` (a GPU by default;
    raises without one unless ``"cpu"``), leaf for leaf and bit for bit:
    ``step`` an int32 0-d tensor, the moments f32."""
    from repro_torch.optim.adamw import AdamWState

    step, m, v = state
    return AdamWState(step=lm_params_from_arrays(np.asarray(step, np.int32), device),
                      m=lm_params_from_arrays(m, device), v=lm_params_from_arrays(v, device))


def opt_state_to_arrays(state):
    """The inverse: the port's ``AdamWState`` with numpy leaves on the host
    (``repro.optim.AdamWState(*opt_state_to_arrays(opt))`` is the
    reference's)."""
    return type(state)(*(lm_params_to_arrays(x) for x in state))
