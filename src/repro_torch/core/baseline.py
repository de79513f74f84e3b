"""The baseline MTTKRP the paper compares against (``repro.core.baseline``).

The Tensor-Toolbox baseline materialises the intermediate tensor Y (R x J x
K) and computes each MTTKRP as a matricisation times a full Khatri-Rao
product. Kept as the paper has it, at test sizes: memory O(R J K) for Y and
O(max(KJ, RK, RJ) R) for the Khatri-Rao products, the blow-up SPARTan
removes.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core import constraints as cst
from repro_torch.core.cp import cp_gram, normalize_columns
from repro_torch.core.irregular import Bucket

__all__ = [
    "baseline_als_step",
    "baseline_mode1",
    "baseline_mode2",
    "baseline_mode3",
    "dense_y",
    "khatri_rao",
]


def khatri_rao(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Column-wise Khatri-Rao product: [I, R] x [J, R] -> [I*J, R]."""
    I, R = A.shape
    J, _ = B.shape
    return (A[:, None, :] * B[None, :, :]).reshape(I * J, R)


def dense_y(buckets: List[Bucket], Ycs: List[torch.Tensor], J: int, K: int) -> torch.Tensor:
    """Materialise Y in R^{R x J x K} from per-bucket compressed slices."""
    R = Ycs[0].shape[1]
    Y = Ycs[0].new_zeros((R, J, K))
    for b, Yc in zip(buckets, Ycs):
        dense_k = b.scatter_cols_to_dense(Yc, J)              # [Kb, R, J]
        masked = dense_k * b.subject_mask[:, None, None]
        Y.index_add_(2, b.subject_ids.long(), masked.permute(1, 2, 0))
    return Y


def baseline_mode1(Y: torch.Tensor, V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """M1 = Y_(1) (W ⊙ V): mode-1 matricisation x full Khatri-Rao product."""
    R, J, K = Y.shape
    return Y.permute(0, 2, 1).reshape(R, K * J) @ khatri_rao(W, V)


def baseline_mode2(Y: torch.Tensor, H: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """M2 = Y_(2) (W ⊙ H)."""
    R, J, K = Y.shape
    return Y.permute(1, 2, 0).reshape(J, K * R) @ khatri_rao(W, H)


def baseline_mode3(Y: torch.Tensor, H: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """M3 = Y_(3) (V ⊙ H)."""
    R, J, K = Y.shape
    return Y.permute(2, 1, 0).reshape(K, J * R) @ khatri_rao(V, H)


def baseline_als_step(data, state, opts):
    """One PARAFAC2-ALS iteration with the baseline CP step: the dense Y and
    matricisation x full Khatri-Rao MTTKRPs. The Procrustes step and the
    factor updates are ``als_step``'s, the same constraint bundle and
    carried ADMM duals included, so a timing difference isolates the MTTKRP
    reformulation. Global W only, as in the reference."""
    from repro_torch.core.backend import get_backend
    from repro_torch.core.parafac2 import (Parafac2State, _procrustes_project,
                                           constraints_for)

    H, V, W = state.H, state.V, state.W
    J, K = data.n_cols, data.n_subjects
    cons = constraints_for(opts)
    solve_kw = dict(nnls_sweeps=opts.nnls_sweeps, admm_iters=opts.admm_iters)
    aux = state.aux if isinstance(state.aux, dict) else cst.empty_aux()
    be = get_backend(opts.backend, data.device, opts.precision)
    Ycs = [b.project(_procrustes_project(b, H, V, W, opts, i, be)[2])
           for i, b in enumerate(data.buckets)]
    Y = dense_y(data.buckets, Ycs, J, K)                     # the memory blow-up

    M1 = baseline_mode1(Y, V, W)
    H_new, aux_h = cons["h"].update(M1, cp_gram(W, V), H, aux["h"], **solve_kw)
    aux_w = aux["w"]
    if not cons["h"].penalized:     # the normalisation rule of als_step
        H_new, h_norms = normalize_columns(H_new)
        aux_h = cst.scale_aux(aux_h, 1.0 / torch.clamp(h_norms, min=1e-12))
        W = W * h_norms[None, :]
        aux_w = cst.scale_aux(aux_w, h_norms)

    M2 = baseline_mode2(Y, H_new, W)
    V_new, aux_v = cons["v"].update(M2, cp_gram(W, H_new), V, aux["v"], **solve_kw)
    if not cons["v"].penalized:
        V_new, v_norms = normalize_columns(V_new)
        aux_v = cst.scale_aux(aux_v, 1.0 / torch.clamp(v_norms, min=1e-12))
        W = W * v_norms[None, :]
        aux_w = cst.scale_aux(aux_w, v_norms)

    M3 = baseline_mode3(Y, H_new, V_new)
    gram3 = (V_new.T @ V_new) * (H_new.T @ H_new)
    W_new, aux_w = cons["w"].update(M3, gram3, W, aux_w, **solve_kw)

    Phi = H_new.T @ H_new
    VtV = V_new.T @ V_new
    norm_sq = data.norm_sq_tensor(opts.dtype)
    G_all = torch.einsum("rjk,jl->krl", Y, V_new)
    cross = torch.einsum("rl,krl,kl->", H_new, G_all, W_new)
    model = torch.einsum("rl,rl,kr,kl->", Phi, VtV, W_new, W_new)
    resid = norm_sq - 2.0 * cross + model
    fit_val = 1.0 - torch.sqrt(torch.clamp(resid, min=0.0)) / torch.sqrt(norm_sq)
    return Parafac2State(H=H_new, V=V_new, W=W_new, fit=fit_val,
                         aux={"h": aux_h, "v": aux_v, "w": aux_w})
