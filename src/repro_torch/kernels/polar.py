"""P1, the Gram-eigh polar's inverse square root: ``csrc/polar.cu``, its
wrapper, its plain version and its launch count.

``gram_inv_sqrt(G)`` maps K symmetric R x R Grams G = B^T B to P_inv =
E diag(inv_root) E^T with the reference's clamp (``repro.core.procrustes.
polar_gram_eigh``): ``scale = max(lambda, 0)``, ``tol = max(scale) * eps``,
``inv_root = 1/sqrt(max(scale, tol))`` where ``scale > tol``, else 0, so an
all-zero G (a padded subject) gives P_inv = 0. The reference takes
``jnp.linalg.eigh`` inside its compiled program, so P1 is a kernel of the
port only: a batched cyclic Jacobi that decides convergence on the device,
so that a CUDA graph can capture the polar step (``torch.linalg.eigh`` reads
its error flags back to the host). Both the kernel and the plain version
are accurate to an f64 solve whatever the input dtype, and return the input's
dtype: an f32 eigensolver's own error (about R * condition * 2^-24 of max
|P_inv|) passes the f32 tolerance of 1e-6 from R = 40 on. The kernel runs
most of its sweeps in f32 on G scaled by a power of two, makes the f32
eigenvectors orthonormal in f64, and finishes in f64 on E^T G E, which is
diagonal to about 1e-6 of ||G||, so that one or two f64 sweeps remain. Its
designs (:data:`VARIANTS`, by rank): a thread a subject in registers (R <=
8, the main path's R = 5), a warp a subject in shared memory (R <= 64, the
paper's 10, 20 and 40), and past that a block a subject in f64 alone, with
its matrices in shared memory or, past R = 119, in a global workspace.

On CUDA tensors :func:`gram_inv_sqrt` launches the kernel (or raises); on
the CPU it runs :func:`gram_inv_sqrt_plain`, the algebra on
``torch.linalg.eigh``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import I as _I, P as _P
from repro_torch.kernels._launch import KernelLib, dtype_code, on_cpu

__all__ = ["KERNELS", "LAUNCHES", "LIB", "VARIANTS", "gram_inv_sqrt", "gram_inv_sqrt_plain",
           "gram_inv_sqrt_variant", "reset_launches"]

KERNELS = ("gram_inv_sqrt",)
LIB = KernelLib("polar", KERNELS, {
    "spartan_gram_inv_sqrt": [_I, _P, _P, _I, _I, ctypes.c_double, _P, _P],
    "spartan_gram_inv_sqrt_workspace": [_I, _I],
    "spartan_gram_inv_sqrt_variant": [_I],
})
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches
# the designs of csrc/polar.cu, by the code spartan_gram_inv_sqrt_variant returns
VARIANTS = ("thread-per-subject", "warp-per-subject", "block-shared", "block-workspace")
_WORKSPACE: dict = {}    # (K, R) -> the doubles of workspace a launch needs


def gram_inv_sqrt_plain(G: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The polar's inverse root on ``torch.linalg.eigh``, in f64. A Gram
    with a non-finite entry (a state poisoned with NaNs) gives NaNs, as the
    reference's ``eigh`` does, where ``torch.linalg.eigh`` would raise."""
    G64 = G.to(torch.float64)
    bad = ~torch.isfinite(G64).all(dim=-1).all(dim=-1)[:, None, None]
    lam, E = torch.linalg.eigh(torch.where(bad, 0.0, G64))   # ascending
    scale = torch.clamp(lam, min=0.0)
    tol = scale.amax(dim=-1, keepdim=True) * eps
    inv_root = torch.where(scale > tol, torch.rsqrt(torch.maximum(scale, tol)),
                           torch.zeros_like(scale))
    out = (E * inv_root[:, None, :]) @ E.transpose(1, 2)       # E diag E^T
    return torch.where(bad, float("nan"), out).to(G.dtype)


def gram_inv_sqrt(G: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """G [K, R, R] symmetric -> P_inv [K, R, R], G's dtype."""
    K, R, R2 = G.shape
    if R2 != R:
        raise ValueError(f"G has shape {tuple(G.shape)}, want [K, R, R]")
    if K == 0:
        return torch.zeros_like(G)
    if on_cpu(G):
        return gram_inv_sqrt_plain(G, eps)
    code = dtype_code(G)
    need = _WORKSPACE.get((K, R))
    if need is None:        # asked once per (K, R): a launch makes one ctypes call
        need = _WORKSPACE[(K, R)] = LIB.lib().spartan_gram_inv_sqrt_workspace(K, R)
    if need < 0:
        raise ValueError(f"gram_inv_sqrt: no workspace for K={K}, R={R}")
    ws = torch.empty(need, dtype=torch.float64, device=G.device) if need else None
    out = torch.empty_like(G)
    LIB.launch("gram_inv_sqrt", "spartan_gram_inv_sqrt", G.device, code, G.data_ptr(),
               out.data_ptr(), K, R, float(eps), ws.data_ptr() if ws is not None else None)
    return out


def gram_inv_sqrt_variant(R: int) -> str:
    """The design :func:`gram_inv_sqrt` launches at rank R: a thread a
    subject (R <= 8), a warp a subject (R <= 64), a block a subject with its
    matrices in shared memory, or in a global workspace (R > 119)."""
    code = LIB.lib().spartan_gram_inv_sqrt_variant(R)
    if code < 0:
        raise ValueError(f"no gram_inv_sqrt variant for R={R}")
    return VARIANTS[code]
