"""Deterministic synthetic LM token pipeline (``repro.data.tokens``, its
numpy code copied: the batches are the reference's bytes).

Batches are a pure function of (seed, step) — a counter-based generator — so
the iterator state is a single integer. Checkpoint/restart never replays or
skips data: resuming at step N reproduces exactly the batch an uninterrupted
run saw.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch: int            # global batch
    seq_len: int
    seed: int = 0
    step: int = 0         # iterator state (checkpointable)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for `step` (counter-based; no stream state): int32
        ``tokens`` and ``labels`` (the next token, -1 at the last position)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        # zipf-ish marginal over vocab, with short repeated motifs so tiny
        # models can actually learn structure in examples/tests
        base = rng.zipf(1.3, size=(self.batch, self.seq_len)).astype(np.int64)
        tokens = (base % (self.vocab_size - 1)) + 1
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            out = self.batch_at(self.step)
            self.step += 1
            yield out

    def state(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: Dict[str, int]) -> "TokenStream":
        self.seed = int(state["seed"])
        self.step = int(state["step"])
        return self
