"""COO utilities and deterministic random irregular-tensor generators.

An *irregular tensor* is a collection ``{X_k in R^{I_k x J}}`` of K sparse
matrices sharing the variables axis J but with ragged observation counts I_k.
On the host side we represent it as a list of per-subject COO triplets; the
device-side formats live in :mod:`repro_torch.core.irregular`.

The port's own copy of ``repro.sparse.coo`` (numpy only): the same seed gives
byte-identical arrays in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "SubjectCOO",
    "IrregularCOO",
    "random_irregular",
    "random_parafac2",
    "from_dense_slices",
]


@dataclasses.dataclass(frozen=True)
class SubjectCOO:
    """One subject's sparse slice X_k (I_k x J) in COO."""

    rows: np.ndarray  # int32 [nnz]
    cols: np.ndarray  # int32 [nnz]
    vals: np.ndarray  # float  [nnz]
    n_rows: int       # I_k
    n_cols: int       # J (shared)

    @property
    def nnz(self) -> int:
        return int(self.vals.size)

    def nonzero_cols(self) -> np.ndarray:
        """Sorted unique column indices with at least one nonzero."""
        return np.unique(self.cols)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.float64)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out


@dataclasses.dataclass(frozen=True)
class IrregularCOO:
    """Host-side irregular tensor: K ragged sparse slices over shared J."""

    subjects: List[SubjectCOO]
    n_cols: int  # J

    @property
    def n_subjects(self) -> int:
        return len(self.subjects)

    @property
    def nnz(self) -> int:
        return sum(s.nnz for s in self.subjects)

    def row_counts(self) -> np.ndarray:
        return np.asarray([s.n_rows for s in self.subjects], dtype=np.int32)

    def col_counts(self) -> np.ndarray:
        return np.asarray([s.nonzero_cols().size for s in self.subjects], dtype=np.int32)

    def nnz_counts(self) -> np.ndarray:
        """Per-subject nonzero counts (the SCOO planner's padding currency)."""
        return np.asarray([s.nnz for s in self.subjects], dtype=np.int64)

    def frobenius_sq(self) -> float:
        return float(sum(np.sum(np.square(s.vals, dtype=np.float64)) for s in self.subjects))


def from_dense_slices(slices: Sequence[np.ndarray]) -> IrregularCOO:
    """Build an IrregularCOO from a list of dense I_k x J arrays."""
    if not slices:
        raise ValueError("need at least one slice")
    J = slices[0].shape[1]
    subs = []
    for X in slices:
        if X.shape[1] != J:
            raise ValueError("all slices must share the J (columns) axis")
        r, c = np.nonzero(X)
        subs.append(
            SubjectCOO(
                rows=r.astype(np.int32),
                cols=c.astype(np.int32),
                vals=X[r, c].astype(np.float64),
                n_rows=X.shape[0],
                n_cols=J,
            )
        )
    return IrregularCOO(subjects=subs, n_cols=J)


def random_irregular(
    *,
    n_subjects: int,
    n_cols: int,
    max_rows: int,
    avg_nnz_per_subject: float,
    seed: int = 0,
    min_rows: int = 1,
    nonneg: bool = True,
) -> IrregularCOO:
    """Uniform random sparse irregular tensor (synthetic-scaling experiments).

    Mirrors the paper's synthetic setup: every kept row has >= 1 nonzero
    (rows with no nonzeros are filtered by construction, as the paper notes).
    """
    rng = np.random.default_rng(seed)
    subs = []
    for _ in range(n_subjects):
        I_k = int(rng.integers(min_rows, max_rows + 1))
        lam = max(avg_nnz_per_subject, I_k)
        nnz = max(I_k, int(rng.poisson(lam)))
        # guarantee each row has at least one nonzero, rest uniform.
        rows = np.concatenate([np.arange(I_k), rng.integers(0, I_k, nnz - I_k)])
        cols = rng.integers(0, n_cols, nnz)
        vals = rng.random(nnz) if nonneg else rng.standard_normal(nnz)
        # dedupe (r, c) pairs by summing.
        key = rows.astype(np.int64) * n_cols + cols
        uk, inv = np.unique(key, return_inverse=True)
        v = np.zeros(uk.size)
        np.add.at(v, inv, vals)
        subs.append(
            SubjectCOO(
                rows=(uk // n_cols).astype(np.int32),
                cols=(uk % n_cols).astype(np.int32),
                vals=v,
                n_rows=I_k,
                n_cols=n_cols,
            )
        )
    return IrregularCOO(subjects=subs, n_cols=n_cols)


def random_parafac2(
    *,
    n_subjects: int,
    n_cols: int,
    max_rows: int,
    rank: int,
    density: float,
    seed: int = 0,
    nonneg: bool = True,
    noise: float = 0.0,
) -> Tuple[IrregularCOO, dict]:
    """Random low-rank PARAFAC2 model, then sparsified uniformly at random.

    This is the paper's synthetic-data protocol (Section 5.2): construct the
    factors of a rank-R PARAFAC2 model, build the slices {X_k}, then sparsify.
    Returns the data plus the ground-truth factors for recovery tests.
    """
    rng = np.random.default_rng(seed)
    sample = rng.random if nonneg else rng.standard_normal
    H = sample((rank, rank))
    V = sample((n_cols, rank))
    W = np.abs(rng.standard_normal((n_subjects, rank))) + 0.1
    subs = []
    for k in range(n_subjects):
        I_k = int(rng.integers(max(2, rank), max_rows + 1))
        # random column-orthonormal Q_k
        A = rng.standard_normal((I_k, rank))
        Q, _ = np.linalg.qr(A)
        Xk = (Q @ H) @ np.diag(W[k]) @ V.T
        if noise > 0:
            Xk = Xk + noise * rng.standard_normal(Xk.shape) * np.abs(Xk).mean()
        mask = rng.random(Xk.shape) < density
        Xk = np.where(mask, Xk, 0.0)
        keep = mask.any(axis=1)  # paper: filter all-zero rows
        Xk = Xk[keep]
        if Xk.shape[0] == 0:
            Xk = np.abs(sample((1, n_cols))) * (rng.random((1, n_cols)) < density)
        r, c = np.nonzero(Xk)
        subs.append(
            SubjectCOO(
                rows=r.astype(np.int32),
                cols=c.astype(np.int32),
                vals=Xk[r, c],
                n_rows=Xk.shape[0],
                n_cols=n_cols,
            )
        )
    truth = {"H": H, "V": V, "W": W}
    return IrregularCOO(subjects=subs, n_cols=n_cols), truth
