"""Per-tensor compression-rate rules (the paper's §4 guidance), as in
``repro.core.rates``: the first rule whose pattern matches a tensor path
sets its chunk and top-m; ``chunk=None`` reduces that tensor densely.

The paper sets each layer's rate from its FLOPs/gradient-size ratio per
worker minibatch (``PAPER_TIERS``: [196, inf) -> 25x, [128, 196) -> 50x,
(0, 128) -> 400x; ``paper_guidance_chunk``). For transformer weights the
ratio is uniform, 2 x tokens per worker (``lm_flops_per_grad``)."""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

from repro_torch.core.compressors import CompressorConfig

__all__ = ["RateRule", "resolve_compressor", "paper_guidance_chunk", "lm_flops_per_grad",
           "PAPER_TIERS"]

# (ratio_lower_bound, compression rate): paper §4
PAPER_TIERS: Tuple[Tuple[float, float], ...] = ((196.0, 25.0), (128.0, 50.0), (0.0, 400.0))


@dataclasses.dataclass(frozen=True)
class RateRule:
    """First matching pattern wins. chunk=None means: do not compress."""

    pattern: str
    chunk: Optional[int]
    topm: int = 1


def resolve_compressor(
    path: str, base: CompressorConfig, rules: Sequence[RateRule]
) -> Optional[CompressorConfig]:
    """CompressorConfig for one tensor, or None => dense reduction."""
    for rule in rules:
        if re.search(rule.pattern, path):
            if rule.chunk is None:
                return None
            return dataclasses.replace(base, chunk=rule.chunk, topm=rule.topm)
    return base


def paper_guidance_chunk(flops_per_grad: float) -> int:
    """Chunk size (= rate at topm=1) from the paper's FLOPs/gradient tiers."""
    for lo, rate in PAPER_TIERS:
        if flops_per_grad >= lo:
            return int(rate)
    return int(PAPER_TIERS[-1][1])


def lm_flops_per_grad(tokens_per_worker: int) -> float:
    """Uniform matmul ratio for transformer weights: 2 x tokens/worker
    (forward; the paper's table is calibrated on forward FLOPs per element)."""
    return 2.0 * tokens_per_worker
