"""Quickstart (the reference's ``examples/quickstart.py``): fit a PARAFAC2
model to a synthetic irregular tensor and recover its planted structure.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On the GPU the fit runs the ``auto`` backend's hand kernels (F1-F4, P1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import Parafac2Options, bucketize, fit, reconstruct_uk
from repro_torch.device import resolve_device
from repro_torch.sparse import random_parafac2

MAX_ITERS, TOL = 60, 1e-7


def run(device="cuda", *, state=None, dtype: torch.dtype = torch.float32,
        max_iters: int = MAX_ITERS, backend: str = "auto") -> dict:
    """The example's fit on ``device`` (from ``state`` when given, a
    ``Parafac2State`` on that device, else ``init_state``'s): the fit
    history, V, W, the U_k, the fit's wall ms and the read-out (the
    PARAFAC2 invariant, U_0^T U_0 = U_1^T U_1 within 1e-2)."""
    dev = resolve_device(device)
    # 1) an irregular dataset from a planted rank-4 PARAFAC2 model
    data, _ = random_parafac2(n_subjects=50, n_cols=60, max_rows=40, rank=4, density=0.8,
                              seed=7)
    print(f"K={data.n_subjects} subjects, J={data.n_cols} variables, nnz={data.nnz}")

    # 2) ragged subjects packed into static-shape buckets (the CC format)
    bucketed = bucketize(data, max_buckets=3, device=dev, dtype=dtype)

    # 3) fit
    opts = Parafac2Options(rank=4, constraints={"v": "nonneg", "w": "nonneg"}, dtype=dtype,
                           backend=backend)
    t0 = time.perf_counter()
    state, history = fit(bucketed, opts, max_iters=max_iters, tol=TOL, state=state)
    fit_ms = (time.perf_counter() - t0) * 1e3       # fit reads the fit each iteration
    print(f"fit after {len(history)} iterations: {history[-1]:.4f}")

    # 4) the factors
    V, W = state.V.cpu().numpy(), state.W.cpu().numpy()
    print("V (variable loadings) shape:", V.shape)
    print("W (subject importances) shape:", W.shape)
    uks = reconstruct_uk(bucketed, state, opts)
    print("U_0 (temporal signature of subject 0) shape:", uks[0].shape)
    invariant = bool(np.allclose(uks[0].T @ uks[0], uks[1].T @ uks[1], atol=1e-2))
    print("PARAFAC2 invariant: U_k^T U_k constant across subjects ->", invariant)
    return {"history": history, "V": V, "W": W, "uks": uks, "fit_ms": fit_ms,
            "readout": {"invariant": invariant}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    out = run(ap.parse_args(argv).device)
    assert out["history"][-1] > 0.5
    assert out["readout"]["invariant"]
    return out


if __name__ == "__main__":
    main()
