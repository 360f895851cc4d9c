"""Data pipeline: the synthetic Markov corpus and worker-stacked batches.

The port's own copy of ``repro.data.pipeline``. It is numpy-only and draws
in the same order, so its batches are bit-identical to the JAX package's for
the same seed. Batches stay numpy; the train step moves them to the device.

Batches are emitted worker-stacked: {"tokens": (n_workers, local_B, S), ...};
each worker draws a disjoint slice of one stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "make_batches", "model_inputs"]


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


def model_inputs(cfg) -> Dict[str, int]:
    """``make_batches``' keywords for ``cfg``'s inputs beside the tokens: a
    VLM's vision prefix, an encoder-decoder's frames (none for the others)."""
    return dict(vision_tokens=cfg.vision_tokens if cfg.arch_type == "vlm" else 0,
                d_model=cfg.d_model, encoder_seq=cfg.encoder_seq if cfg.is_encdec else 0)


def make_batches(
    vocab: int,
    n_workers: int,
    local_batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    vision_tokens: int = 0,
    d_model: int = 0,
    encoder_seq: int = 0,
    steps: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields worker-stacked batches: tokens/labels (n, local_B, S) int32, mask
    ones. A VLM's adds "vision" (n, local_B, vision_tokens, d_model), an
    encoder-decoder's "frames" (n, local_B, encoder_seq, d_model): stub
    embeddings drawn, in that order, from the step's generator after the tokens."""
    src = SyntheticLM(vocab, seed=seed)
    step = 0
    while steps is None or step < steps:
        batch_rng = np.random.default_rng((seed, step))
        toks = src.sample(batch_rng, n_workers * local_batch, seq_len)
        toks = toks.reshape(n_workers, local_batch, seq_len + 1)
        out: Dict[str, np.ndarray] = {
            "tokens": toks[..., :-1],
            "labels": toks[..., 1:],
            "mask": np.ones((n_workers, local_batch, seq_len), np.float32),
        }
        if vision_tokens:
            out["vision"] = batch_rng.standard_normal(
                (n_workers, local_batch, vision_tokens, d_model), dtype=np.float32)
        if encoder_seq:
            out["frames"] = batch_rng.standard_normal(
                (n_workers, local_batch, encoder_seq, d_model), dtype=np.float32)
        yield out
        step += 1
