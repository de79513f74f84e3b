"""Temporal phenotyping on synthetic EHR data, the paper's section 5.3 case
study (the reference's ``examples/phenotyping.py``).

Fits a rank-5 non-negative PARAFAC2 model to CHOA-shaped synthetic records
and prints the phenotype definitions (V), each subject's top phenotypes
(S_k) and a temporal signature (U_k), as in Figure 8 / Table 4 of the
paper.

  PYTHONPATH=src python -m repro_torch.examples.phenotyping
  PYTHONPATH=src python -m repro_torch.examples.phenotyping --device cpu

On the GPU the fit runs the ``auto`` backend's hand kernels (F1-F4, P1).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import Parafac2Options, bucketize, fit, reconstruct_uk
from repro_torch.core.interpret import (subject_top_phenotypes, temporal_signature,
                                        top_phenotype_features)
from repro_torch.data import choa_like
from repro_torch.device import resolve_device

FEATURES = [f"dx:ccs_{i}" for i in range(800)] + [f"rx:cat_{i}" for i in range(528)]
MAX_ITERS, TOL = 40, 1e-6


def run(device="cuda", *, state=None, dtype: torch.dtype = torch.float32,
        max_iters: int = MAX_ITERS, backend: str = "auto") -> dict:
    """The example's fit on ``device`` (from ``state`` when given, a
    ``Parafac2State`` on that device, else ``init_state``'s): the fit
    history, V, W, the U_k, the fit's wall ms and the read-out (each
    phenotype's top six features; subjects 0 and 1's top two phenotypes and
    their temporal signatures)."""
    dev = resolve_device(device)
    data = choa_like(scale=0.001, seed=3, with_phenotypes=True, rank=5)
    print(f"synthetic MCP cohort: K={data.n_subjects}, J={data.n_cols}, nnz={data.nnz}")
    bucketed = bucketize(data, max_buckets=4, device=dev, dtype=dtype)
    opts = Parafac2Options(rank=5, constraints={"v": "nonneg", "w": "nonneg"}, dtype=dtype,
                           backend=backend)
    t0 = time.perf_counter()
    state, hist = fit(bucketed, opts, max_iters=max_iters, tol=TOL, state=state)
    fit_ms = (time.perf_counter() - t0) * 1e3       # fit reads the fit each iteration
    print(f"fit: {hist[-1]:.4f} ({len(hist)} iters)\n")

    V, W = state.V.cpu().numpy(), state.W.cpu().numpy()
    print("== phenotype definitions (top features of V) ==")
    features = top_phenotype_features(V, FEATURES, top=6)
    for r, feats in enumerate(features):
        pretty = ", ".join(f"{n} ({w:.2f})" for n, w in feats)
        print(f"  phenotype {r}: {pretty}")

    uks = reconstruct_uk(bucketed, state, opts)
    subjects = {}
    for k in (0, 1):
        tops = subject_top_phenotypes(W, k, top=2)
        print(f"\n== subject {k}: top phenotypes {tops} ==")
        sig = temporal_signature(uks[k], [r for r, _ in tops], constraints=opts)
        for r, series in sig.items():
            spark = "".join(" .:-=+*#"[min(7, int(v / (series.max() + 1e-9) * 7))]
                            for v in series[:60])
            print(f"  phenotype {r} over {len(series)} weeks: |{spark}|")
        subjects[k] = {"top": tops, "signatures": sig}
    return {"history": hist, "V": V, "W": W, "uks": uks, "fit_ms": fit_ms,
            "readout": {"features": features, "subjects": subjects}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
