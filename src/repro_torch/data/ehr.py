"""Synthetic EHR-shaped irregular tensors (CHOA-like geometry, paper §5.1).

The real CHOA dataset is K=464,900 subjects x J=1,328 features x <=166 weekly
observations, 12.3M nonzeros; MovieLens is K=25,249 x J=26,096 x <=19 years,
8.9M nonzeros. These generators reproduce the *geometry* (row/column sparsity
distributions) at any scale factor.

This is the port's own copy of ``repro.data.ehr`` (numpy only): for the same
seed it yields byte-identical arrays, which ``tests/test_torch_data.py``
checks, so the port and the JAX package decompose the same tensor.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.coo import IrregularCOO, SubjectCOO

__all__ = ["choa_like", "movielens_like"]


def _build(K, J, max_rows, mean_rows, feats_per_obs, seed, phenotypes=None):
    """Per-subject generation with BATCHED numpy draws.

    The per-observation work — one Poisson count, one without-replacement
    feature pick, and the value draws per observation — is vectorized over
    all I_k observations of a subject (3 rng calls per subject instead of
    ~3*I_k): counts come from one batched Poisson; the without-replacement
    picks take the first n_i entries of an argsorted random-key matrix (a
    uniform random permutation per observation, so marginally identical to
    per-row ``rng.choice(..., replace=False)``); values from one batched
    Poisson over the total pick count. Output is deterministic per seed (the
    stream differs from the pre-vectorization per-observation loop; the
    geometry statistics are asserted unchanged in tests/test_ehr.py).
    """
    rng = np.random.default_rng(seed)
    subs = []
    R = 0 if phenotypes is None else phenotypes.shape[1]
    if phenotypes is None:
        # long-tail feature popularity (zipf), like diagnostic code frequency
        pop = 1.0 / np.arange(1, J + 1) ** 0.8
        pop /= pop.sum()
    for k in range(K):
        I_k = int(np.clip(rng.poisson(mean_rows) + 1, 1, max_rows))
        if phenotypes is None:
            active = rng.choice(J, size=min(J, max(3, int(rng.poisson(feats_per_obs * 3)))),
                                replace=False, p=pop)
        else:
            r_k = rng.integers(0, R)
            w = phenotypes[:, r_k]
            active = np.argsort(-w)[: max(3, feats_per_obs * 2)]
        A = active.size
        n = np.minimum(np.maximum(rng.poisson(feats_per_obs, I_k), 1), A)
        # first n_i of a random permutation per row == uniform sample
        # without replacement per observation
        order = np.argsort(rng.random((I_k, A)), axis=1)
        picked = np.arange(A)[None, :] < n[:, None]          # [I_k, A] mask
        cols = active[order[picked]]                          # row-major flat
        rows = np.repeat(np.arange(I_k), n)
        vals = rng.poisson(2.0, rows.size) + 1.0
        key = rows.astype(np.int64) * J + cols.astype(np.int64)
        uk, inv = np.unique(key, return_inverse=True)
        v = np.zeros(uk.size)
        np.add.at(v, inv, vals.astype(np.float64))
        subs.append(SubjectCOO(
            rows=(uk // J).astype(np.int32),
            cols=(uk % J).astype(np.int32),
            vals=v, n_rows=I_k, n_cols=J))
    return IrregularCOO(subjects=subs, n_cols=J)


def choa_like(*, scale: float = 0.01, seed: int = 0,
              with_phenotypes: bool = False, rank: int = 5):
    """CHOA-shaped EHR data at `scale` of the real K (full: 464,900)."""
    K = max(8, int(464_900 * scale))
    J = 1_328
    phen = None
    if with_phenotypes:
        rng = np.random.default_rng(seed + 1)
        phen = rng.random((J, rank)) ** 4    # sparse-ish phenotype defs
    return _build(K, J, max_rows=166, mean_rows=28, feats_per_obs=4,
                  seed=seed, phenotypes=phen)


def movielens_like(*, scale: float = 0.05, seed: int = 0):
    """MovieLens-shaped: many variables (movies), few observations (years)."""
    K = max(8, int(25_249 * scale))
    J = 26_096
    return _build(K, J, max_rows=19, mean_rows=6, feats_per_obs=20, seed=seed)
