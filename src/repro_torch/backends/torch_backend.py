"""Plain PyTorch backend: the reference on any device and the CPU path.

A thin veneer over the trailing-axis ops of ``repro_torch.core.chunked``;
``ef_update`` and ``fused_reduce`` are the base-class compositions. On the
card it computes the same values as the CUDA backend bit for bit
(``chip_smoke.py`` checks one reduce of each).
"""

from __future__ import annotations

import functools

from repro_torch.backends.base import KernelBackend, register_backend
from repro_torch.core import chunked

__all__ = ["TorchBackend"]


class TorchBackend(KernelBackend):
    name = "torch"

    def select_indices(self, x, chunk, topm=1):
        if topm == 1:
            return chunked.chunk_argmax(x, chunk)
        return chunked.chunk_topm_indices(x, chunk, topm)

    def gather(self, x, idx, chunk, topm=1):
        return chunked.chunk_gather(x, idx, chunk, topm)

    def scatter(self, vals, idx, chunk, size, topm=1):
        return chunked.chunk_scatter(vals, idx, chunk, size, topm)


@functools.lru_cache(maxsize=1)
def _instance() -> TorchBackend:
    return TorchBackend()


register_backend("torch", _instance)
