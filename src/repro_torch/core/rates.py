"""Per-tensor compression-rate rules (the paper's §4 guidance), as in
``repro.core.rates``: the first rule whose pattern matches a tensor path
sets its chunk and top-m; ``chunk=None`` reduces that tensor densely."""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

from repro_torch.core.compressors import CompressorConfig

__all__ = ["RateRule", "resolve_compressor"]


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
