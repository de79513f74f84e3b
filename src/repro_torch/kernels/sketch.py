"""Randomized range-finder stages of the rsvd preprocessing pass
(``repro.kernels.sketch``).

The compression stage (:mod:`repro_torch.core.compress`) needs, per bucket,
an orthonormal basis P_k of the row space of every slice X_k [I_pad, J]. The
randomized QB recipe (Halko, Martinsson and Tropp) is three stages, each an
existing bucket contraction:

  1. **sketch** Y_k = X_k Ω with one Gaussian test matrix Ω [J, S]:
     :meth:`Bucket.xk_times_v` (a gather of Ω's kept-column rows and one
     ``torch.bmm`` a bucket on CC buckets, the plain sorted segment sum on
     SCOO buckets, which are never densified);
  2. **power iteration** (q rounds): Y <- X_k (X_k^T Y), a projection into
     the compact kept-column layout and another ``xk_times_v`` on it;
  3. **orthonormalize** P_k = polar(Y_k) by the Gram-eigh polar
     (:func:`repro_torch.core.procrustes.polar_gram_eigh`, P1 at R = S on
     CUDA tensors): rank-deficient directions (padding subjects, slices with
     fewer than S independent rows) get zero basis columns, not NaNs.

The reference computes all three with ``einsum`` outside any Pallas kernel;
so does the port, apart from P1 in the polar. ``torch.Generator`` cannot
reproduce the reference's ``jax.random`` draw of Ω, so a test that needs the
reference's Ω replaces :func:`gaussian_sketch`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.procrustes import polar_gram_eigh

__all__ = ["SKETCH_FOLD", "gaussian_sketch", "sketch_bucket", "power_iterate", "range_basis"]

# folded into the seed of the sketch's draw, so that Ω is not drawn from the
# stream that init_state's factor draw takes at the same seed (the
# reference's fold_in(PRNGKey(seed), 0x5EED))
SKETCH_FOLD = 0x5EED


def gaussian_sketch(seed: int, n_cols: int, sketch_dim: int,
                    dtype: torch.dtype = torch.float32, device="cpu") -> torch.Tensor:
    """The shared Gaussian test matrix Ω [J, S] / sqrt(S), one draw for every
    bucket (so CC and SCOO buckets of the same data sketch against the same
    noise). Drawn on the CPU from a ``torch.Generator`` seeded by ``seed``
    and :data:`SKETCH_FOLD`, then moved to ``device``: the CPU and a GPU see
    the same Ω for a seed."""
    gen = torch.Generator(device="cpu").manual_seed(
        (int(seed) + (SKETCH_FOLD << 32)) & 0xFFFF_FFFF_FFFF_FFFF)
    omega = torch.randn((n_cols, sketch_dim), generator=gen, dtype=dtype)
    return (omega / math.sqrt(sketch_dim)).to(device)


def sketch_bucket(b, Omega: torch.Tensor,
                  Og: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Y_k = X_k Ω for every subject of ``b``: [Kb, I_pad, S]. Only Ω's rows
    of kept columns take part, in either format."""
    return b.xk_times_v(Omega, Og)


def power_iterate(b, Y: torch.Tensor, q: int) -> torch.Tensor:
    """q rounds of Y <- X_k (X_k^T Y), in the compact kept-column space."""
    for _ in range(q):
        Z = b.project(Y)                           # [Kb, S, C_pad]
        Y = b.xk_times_v(None, Vg=Z.transpose(1, 2))
    return Y


def range_basis(b, Omega: torch.Tensor, *, q: int = 1) -> torch.Tensor:
    """Orthonormal range basis P_k [Kb, I_pad, S] for every slice of ``b``.
    Columns past a slice's rank come back zero (pseudo-polar), and padding
    subjects get a zero basis through the subject mask."""
    Y = sketch_bucket(b, Omega)
    Y = power_iterate(b, Y, q)
    P = polar_gram_eigh(Y)
    return P * b.subject_mask[:, None, None]
