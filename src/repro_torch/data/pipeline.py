"""Data pipeline: the synthetic Markov corpus and worker-stacked batches.

The port's own copy of ``repro.data.pipeline`` for the text-only path. It is
numpy-only and draws in the same order, so its batches are bit-identical to
the JAX package's for the same seed. Batches stay numpy; the train step moves
them to the device.

Batches are emitted worker-stacked: {"tokens": (n_workers, local_B, S), ...};
each worker draws a disjoint slice of one stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "make_batches"]


@dataclasses.dataclass
class SyntheticLM:
    """Order-1 Markov token source with heavy-tailed transitions."""

    vocab: int
    seed: int = 0
    branching: int = 16  # successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.succ = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        probs = rng.dirichlet(np.full(self.branching, 0.3), size=self.vocab)
        self.cum = np.cumsum(probs, axis=1)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, seq + 1):
            u = rng.random(batch)[:, None]
            choice = (u > self.cum[cur]).sum(axis=1)
            cur = self.succ[cur, np.minimum(choice, self.branching - 1)]
            out[:, t] = cur
        return out


def make_batches(
    vocab: int,
    n_workers: int,
    local_batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    steps: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields worker-stacked batches: tokens/labels (n, local_B, S) int32, mask ones."""
    src = SyntheticLM(vocab, seed=seed)
    step = 0
    while steps is None or step < steps:
        batch_rng = np.random.default_rng((seed, step))
        toks = src.sample(batch_rng, n_workers * local_batch, seq_len)
        toks = toks.reshape(n_workers, local_batch, seq_len + 1)
        yield {
            "tokens": toks[..., :-1],
            "labels": toks[..., 1:],
            "mask": np.ones((n_workers, local_batch, seq_len), np.float32),
        }
        step += 1
