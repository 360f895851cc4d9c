"""Sparsifying compressors: configuration and the chunked index selection.

The port of the selection half of ``repro.core.compressors``. Selection works
on the worker-stacked error-feedback gradient ``ef`` with chunks along the
trailing axis, ``(G, size)`` (flat layout) or ``(G, *param_shape)``
(rowwise), and dispatches every chunked op to a ``repro_torch.backends``
KernelBackend:

  clt_k       Cyclic Local Top-k, the paper's contribution: the leader
              (``t mod G``) picks per-chunk magnitude arg-max offsets of its
              own EF gradient and every worker compresses with them.
  true_topk   offsets from the worker-mean EF gradient (the dense oracle).
  local_topk  every worker picks its own offsets (gradient build-up).
  none        no compression: the reduce is dense.

``random_k`` draws its offsets from ``jax.random`` in the JAX package; the
port has no matching draw yet and refuses it (ROADMAP Queue 1 item 11, with the
top-m and gather kernels). The exact dense top-k analysis path is not ported
either.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CompressorConfig", "COMPRESSORS", "leader_pick", "select_indices"]

COMPRESSORS = ("clt_k", "true_topk", "local_topk", "random_k", "none")


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    """Static configuration of a sparsifying compressor.

    name:  one of COMPRESSORS
    chunk: chunk size C (compression rate = C / topm)
    topm:  entries kept per chunk
    exact: exact dense top-k instead of chunked selection (not ported)
    """

    name: str = "clt_k"
    chunk: int = 64
    topm: int = 1
    exact: bool = False

    def __post_init__(self):
        if self.name not in COMPRESSORS:
            raise ValueError(f"unknown compressor {self.name!r}; expected one of {COMPRESSORS}")
        if not 1 <= self.topm <= self.chunk:
            raise ValueError(
                f"topm must be in [1, chunk]; got topm={self.topm} "
                f"chunk={self.chunk} (compression rate = chunk/topm)"
            )
        if self.name == "random_k":
            raise NotImplementedError(
                "random_k is not ported yet: its draw comes from jax.random "
                "(ROADMAP Queue 1 item 11, random_k with the top-m and gather kernels)"
            )
        if self.exact:
            raise NotImplementedError(
                "the exact dense top-k analysis path is not ported yet "
                "(ROADMAP Queue 1 item 11)"
            )


def leader_pick(stacked: torch.Tensor, leader: int) -> torch.Tensor:
    """Row ``leader`` of a worker-stacked (G, ...) tensor.

    The JAX package writes this as a masked sum over the worker axis so that
    GSPMD moves only the k-sized payload; on one device it is the same value
    as an index.
    """
    return stacked[leader]


def _select_clt(ef, t: int, cfg: CompressorConfig, backend):
    """Every worker's candidate offsets in one batched call; the leader's win."""
    idx_all = backend.select_indices(ef, cfg.chunk, cfg.topm)
    return leader_pick(idx_all, t % ef.shape[0])


def _select_true(ef, t: int, cfg: CompressorConfig, backend):
    """True top-k oracle: offsets of the worker-mean EF gradient."""
    del t
    return backend.select_indices(torch.mean(ef, dim=0), cfg.chunk, cfg.topm)


_SHARED_INDEX_SELECTORS = {"clt_k": _select_clt, "true_topk": _select_true}


def select_indices(ef, t: int, cfg: CompressorConfig, backend):
    """Chunked offsets for step ``t``: shared (..., n_chunks[, topm]) for
    clt_k/true_topk, per-worker (G, ..., n_chunks[, topm]) for local_topk."""
    if cfg.name == "local_topk":
        return backend.select_indices(ef, cfg.chunk, cfg.topm)
    return _SHARED_INDEX_SELECTORS[cfg.name](ef, t, cfg, backend)
