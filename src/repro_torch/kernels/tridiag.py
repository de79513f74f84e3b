"""P2, the tridiagonal solve of the ``smooth`` constraint's prox:
``csrc/tridiag.cu``, its wrapper, its plain version and its launch count.

``tridiag_solve(Y, rho, lam)`` returns Z [N, R] with ``(rho I + 2 lam D^T D)
Z = rho Y``, D the first differences over the N rows (the reference's
``prox_smooth``, ``src/repro/core/constraints.py:130``, which ends in
``lax.linalg.tridiagonal_solve``). The diagonal is ``rho + 2 lam [1, 2, ...,
2, 1]`` and the off-diagonals ``-2 lam``, one matrix for all R columns.
``rho`` is a scalar tensor on Y's device: the ADMM loop computes it there,
and the kernel reads it from device memory, so a call needs no host sync and
a CUDA graph can capture it. The arithmetic stays in Y's dtype, as the
reference's does.

On CUDA tensors :func:`tridiag_solve` launches the kernel (or raises): the
partition method, every level inside one launch of a persistent grid, whose
last block to finish the reduction solves the deepest levels
(``csrc/tridiag.cu``). On the CPU it runs :func:`tridiag_solve_plain`,
cyclic reduction in torch ops, about 2 log2(N) vectorised steps whatever N.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import I as _I, P as _P
from repro_torch.kernels._launch import KernelLib, Workspaces, dtype_code, on_cpu

__all__ = ["KERNELS", "LAUNCHES", "LIB", "WORKSPACES", "device_kernels", "reset_launches",
           "tridiag_solve", "tridiag_solve_plain"]

KERNELS = ("tridiag_solve",)
LIB = KernelLib("tridiag", KERNELS, {
    "spartan_tridiag_solve": [_I, _P, _P, _P, _I, _I, ctypes.c_double, _P, _P],
    "spartan_tridiag_workspace": [_I, _I, _I],
    "spartan_tridiag_kernels": [_I],
})
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches
WORKSPACES = Workspaces(LIB, "spartan_tridiag_workspace")


def _check(Y: torch.Tensor, rho: torch.Tensor) -> None:
    if Y.dim() != 2 or Y.shape[0] < 2:
        raise ValueError(f"Y has shape {tuple(Y.shape)}, want [N, R] with N >= 2")
    if not isinstance(rho, torch.Tensor) or rho.numel() != 1:
        raise TypeError("rho must be a one-element tensor on Y's device")


def _cyclic_reduction(a, b, c, d):
    """Solve a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i (a_0 = c_{n-1} = 0;
    a, b, c [n], d [n, R]) by cyclic reduction: the even rows keep, with
    their odd neighbours eliminated, a tridiagonal system of half the size;
    the odd rows follow from their even neighbours."""
    n = b.shape[0]
    if n == 1:
        return d / b[:, None]
    z1, o1 = b.new_zeros(1), b.new_ones(1)
    ap, bp, cp = torch.cat([z1, a, z1]), torch.cat([o1, b, o1]), torch.cat([z1, c, z1])
    dp = torch.cat([d.new_zeros(1, d.shape[1]), d, d.new_zeros(1, d.shape[1])])
    ne = (n + 1) // 2
    # padded index i + 1 holds row i: even rows at 1, 3, ...; their left
    # neighbours at 0, 2, ...; their right neighbours at 2, 4, ...
    lo, mid, hi = slice(0, 2 * ne, 2), slice(1, 2 * ne + 1, 2), slice(2, 2 * ne + 2, 2)
    alpha = -ap[mid] / bp[lo]
    gamma = -cp[mid] / bp[hi]
    xe = _cyclic_reduction(alpha * ap[lo],
                           bp[mid] + alpha * cp[lo] + gamma * ap[hi],
                           gamma * cp[hi],
                           dp[mid] + alpha[:, None] * dp[lo] + gamma[:, None] * dp[hi])
    no = n // 2
    xn = torch.cat([xe, xe.new_zeros(1, xe.shape[1])])[1:no + 1]     # right neighbours
    xo = (d[1::2] - a[1::2, None] * xe[:no] - c[1::2, None] * xn) / b[1::2, None]
    x = torch.empty_like(d)
    x[0::2], x[1::2] = xe, xo
    return x


def tridiag_solve_plain(Y: torch.Tensor, rho: torch.Tensor, lam: float) -> torch.Tensor:
    """The solve in torch ops (cyclic reduction), in Y's dtype."""
    _check(Y, rho)
    N, dt = Y.shape[0], Y.dtype
    rho = rho.reshape(()).to(dt)
    two_lam = torch.tensor(2.0 * lam, dtype=dt, device=Y.device)
    dtd = torch.full((N,), 2.0, dtype=dt, device=Y.device)
    dtd[0] = dtd[-1] = 1.0
    off = (-two_lam).expand(N - 1)
    zero = Y.new_zeros(1)
    return _cyclic_reduction(torch.cat([zero, off]), rho + two_lam * dtd,
                             torch.cat([off, zero]), rho * Y)


def tridiag_solve(Y: torch.Tensor, rho: torch.Tensor, lam: float) -> torch.Tensor:
    """Y [N, R] (N >= 2), rho a scalar tensor, lam >= 0 -> Z [N, R], Y's
    dtype."""
    _check(Y, rho)
    if on_cpu(Y, rho):
        return tridiag_solve_plain(Y, rho, lam)
    code = dtype_code(Y)
    out = torch.empty_like(Y)
    if Y.numel() == 0:
        return out
    rho = rho.reshape(())
    if rho.dtype != Y.dtype:
        rho = rho.to(Y.dtype)
    N, R = Y.shape
    WORKSPACES.launch("tridiag_solve", "spartan_tridiag_solve", Y, code, N, R,
                      before=(Y.data_ptr(), rho.data_ptr(), out.data_ptr(), N, R,
                              float(2.0 * lam)),
                      after=())
    return out


def device_kernels(N: int) -> int:
    """The device kernels one call at N rows enqueues: 1."""
    return LIB.lib().spartan_tridiag_kernels(N)
