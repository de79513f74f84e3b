"""Model interpretation helpers, the paper's section 5.3 workflow
(``repro.core.interpret``).

* V columns      -> phenotype definitions (feature memberships)
* diag(S_k)=W[k] -> per-subject phenotype importance (sortable)
* U_k columns    -> per-subject temporal signatures (evolution over I_k steps)

Host-side numpy on the fitted factors (``tensor.cpu().numpy()`` or
``parafac2.reconstruct_uk``'s arrays).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["top_phenotype_features", "subject_top_phenotypes",
           "temporal_signature", "model_is_nonneg"]


def top_phenotype_features(
    V: np.ndarray, feature_names: Optional[Sequence[str]] = None, top: int = 10
) -> List[List[Tuple[str, float]]]:
    """For each phenotype r, the top features by weight in V(:, r)."""
    V = np.asarray(V)
    J, R = V.shape
    names = list(feature_names) if feature_names is not None else [f"feat_{j}" for j in range(J)]
    out = []
    for r in range(R):
        col = V[:, r]
        idx = np.argsort(-col)[:top]
        out.append([(names[j], float(col[j])) for j in idx if col[j] > 0])
    return out


def subject_top_phenotypes(W: np.ndarray, k: int, top: int = 2) -> List[Tuple[int, float]]:
    """Most relevant phenotypes for subject k by importance diag(S_k) = W[k,:]."""
    w = np.asarray(W)[k]
    idx = np.argsort(-w)[:top]
    return [(int(r), float(w[r])) for r in idx]


def model_is_nonneg(constraints) -> bool:
    """Whether a fitted model's V and W are guaranteed nonnegative.

    ``constraints`` may be a ``Parafac2Options``, a per-mode spec mapping
    ({"v": "nonneg+l1:0.1", ...}), or None (unknown: taken as the paper's
    nonnegative default).
    """
    if constraints is None:
        return True
    from repro_torch.core.constraints import parse_spec

    if hasattr(constraints, "constraint_specs"):   # Parafac2Options
        constraints = constraints.constraint_specs()
    return all(parse_spec(constraints.get(m, "none")).nonneg for m in ("v", "w"))


def temporal_signature(
    Uk: np.ndarray,
    phenotypes: Sequence[int],
    clip_nonneg: Optional[bool] = None,
    *,
    constraints=None,
) -> Dict[int, np.ndarray]:
    """Temporal evolution of selected phenotypes for one subject.

    As in the paper, only the nonnegative part of a signature is read, but
    only when the model was fit under nonnegativity. ``clip_nonneg=None``
    consults the fitted constraint spec (``constraints``: the
    ``Parafac2Options`` or its spec dict); signatures of an unconstrained or
    l1-only fit are returned unclipped. An explicit bool overrides.
    """
    if clip_nonneg is None:
        clip_nonneg = model_is_nonneg(constraints)
    Uk = np.asarray(Uk)
    out = {}
    for r in phenotypes:
        sig = Uk[:, r]
        out[int(r)] = np.maximum(sig, 0.0) if clip_nonneg else sig
    return out
