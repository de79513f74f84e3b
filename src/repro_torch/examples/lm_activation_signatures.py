"""PARAFAC2 over LM activations (the reference's
``examples/lm_activation_signatures.py``).

K sequences of *unequal* length I_k, each giving a matrix of activations of
one width J, form the irregular tensor PARAFAC2 models: train a tiny
qwen3-family LM briefly, harvest each sequence's activations, sparsify them
(top entries, like recorded medical events), and extract per-sequence
temporal signatures U_k and shared "activation phenotypes" V.

  PYTHONPATH=src python -m repro_torch.examples.lm_activation_signatures
  PYTHONPATH=src python -m repro_torch.examples.lm_activation_signatures --device cpu

On the GPU the fit runs the ``auto`` backend's hand kernels (F1-F4, P1).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import Parafac2Options, bucketize, fit, reconstruct_uk
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.models.transformer import lm_forward
from repro_torch.sparse import from_dense_slices

LENGTHS = [9, 14, 20, 27, 32, 12, 24, 30]
OPTS = Parafac2Options(rank=3, constraints={"v": "nonneg", "w": "nonneg"})


def train_and_harvest(dev: torch.device, steps: int = 40):
    """(the last training loss, the activation slices): the reduced qwen3
    trained ``steps`` steps on ``dev``, then its logits over the first 64
    vocabulary columns for 8 sequences of unequal length, each row shifted
    down by its 0.6 quantile and cut at 0 (numpy, on the host)."""
    cfg = reduced(get_config("qwen3-0.6b"))
    bundle = build(cfg, lr=3e-3, total_steps=60)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = bundle.init_opt(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=4, seq_len=32, seed=1)
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(i).items()}
        params, opt, m = bundle.train_step(params, opt, batch, i)
    slices = []
    with torch.no_grad():
        for k, L in enumerate(LENGTHS):
            toks = torch.from_numpy(stream.batch_at(100 + k)["tokens"][:1, :L]).to(dev)
            logits, _ = lm_forward(params, toks, cfg)
            h = logits[0].float().cpu().numpy()[:, :64]
            slices.append(np.maximum(h - np.quantile(h, 0.6, axis=1, keepdims=True), 0.0))
    return float(m["loss"]), slices


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    loss, slices = train_and_harvest(dev)
    print(f"tiny LM trained 40 steps, loss={loss:.3f}")
    data = from_dense_slices(slices)
    print(f"irregular activation tensor: K={data.n_subjects} sequences, "
          f"J={data.n_cols}, ragged I_k={LENGTHS}, nnz={data.nnz}")

    bucketed = bucketize(data, max_buckets=2, device=dev)
    state, hist = fit(bucketed, OPTS, max_iters=40, tol=1e-6)
    print(f"PARAFAC2 fit on activations: {hist[-1]:.4f}")

    uks = reconstruct_uk(bucketed, state, OPTS)
    for k in (0, 1):
        sig = np.maximum(uks[k][:, 0], 0)
        spark = "".join(" .:-=+*#"[min(7, int(v / (sig.max() + 1e-9) * 7))] for v in sig)
        print(f"sequence {k} (len {LENGTHS[k]}) signature[phenotype 0]: |{spark}|")
    print("shared activation phenotypes V:", tuple(state.V.shape))
    return {"loss": loss, "slices": slices, "history": hist, "state": state, "uks": uks}


if __name__ == "__main__":
    main()
