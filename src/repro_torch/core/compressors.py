"""Sparsifying compressors: configuration, chunked index selection, ``compress``.

The port of ``repro.core.compressors``. Selection works on the worker-stacked
error-feedback gradient ``ef`` with chunks along the trailing axis,
``(G, size)`` (flat layout) or ``(G, *param_shape)`` (rowwise), and
dispatches every chunked op to a ``repro_torch.backends`` KernelBackend:

  clt_k       Cyclic Local Top-k, the paper's contribution: the leader
              (``t mod G``) picks per-chunk magnitude top-m offsets of its
              own EF gradient and every worker compresses with them.
  true_topk   offsets from the worker-mean EF gradient (the dense oracle).
  local_topk  every worker picks its own offsets (gradient build-up).
  random_k    a shared random offset set, drawn anew each step.
  none        no compression: the reduce is dense.

``exact=True`` replaces the chunked selection by an exact dense top-k over
the whole tensor (k = size * topm / chunk), an analysis path for small sizes.

random_k's draw comes from ``random_draw``: the port's own explicit
``torch.Generator`` seeded from the JAX package's salt ``0x5CA1EC0`` and the
step ``t``. It cannot give ``jax.random``'s bits, so the tests hand both
packages the same draws through that one function. Exact top-k breaks ties
toward the lower index, as ``jax.lax.top_k`` does, through a stable
descending sort (``torch.topk`` makes no such promise).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.chunked import num_chunks

__all__ = [
    "CompressorConfig",
    "COMPRESSORS",
    "compress",
    "compression_rate",
    "exact_k",
    "leader_pick",
    "random_draw",
    "random_offsets",
    "select_indices",
]

COMPRESSORS = ("clt_k", "true_topk", "local_topk", "random_k", "none")

RANDOM_SALT = 0x5CA1EC0  # the JAX package's PRNGKey salt for random_k


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    """Static configuration of a sparsifying compressor.

    name:  one of COMPRESSORS
    chunk: chunk size C (compression rate = C / topm)
    topm:  entries kept per chunk
    exact: exact dense top-k over the whole tensor instead of chunked
           selection (analysis only; k = size * topm / chunk)
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

    @property
    def rate(self) -> float:
        return self.chunk / self.topm


def compression_rate(cfg: CompressorConfig) -> float:
    return cfg.rate


def leader_pick(stacked: torch.Tensor, leader: int) -> torch.Tensor:
    """Row ``leader`` of a worker-stacked (G, ...) tensor.

    The JAX package writes this as a masked sum over the worker axis so that
    GSPMD moves only the k-sized payload; on one device it is the same value
    as an index.
    """
    return stacked[leader]


def random_draw(t: int, shape: Sequence[int], device, high: Optional[int] = None) -> torch.Tensor:
    """Step ``t``'s random bits for random_k, from a generator seeded by (salt, t).

    int32 offsets uniform in [0, high) when ``high`` is given (the topm == 1
    draw of ``jax.random.randint``), else float32 uniform in [0, 1) (the
    ``jax.random.uniform`` keys ranked by the top-m and exact draws).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed((RANDOM_SALT << 32) + (t & 0xFFFFFFFF))
    if high is None:
        return torch.rand(tuple(shape), generator=gen, device=device)
    return torch.randint(0, high, tuple(shape), generator=gen, device=device, dtype=torch.int32)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Offsets of the k largest entries along the last axis, ties to the lower
    offset (``jax.lax.top_k``'s order), as int32."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k].to(torch.int32)


def _select_clt(ef, t: int, cfg: CompressorConfig, backend):
    """Every worker's candidate offsets in one batched call; the leader's win."""
    idx_all = backend.select_indices(ef, cfg.chunk, cfg.topm)
    return leader_pick(idx_all, t % ef.shape[0])


def _select_true(ef, t: int, cfg: CompressorConfig, backend):
    """True top-k oracle: offsets of the worker-mean EF gradient."""
    del t
    return backend.select_indices(torch.mean(ef, dim=0), cfg.chunk, cfg.topm)


def _select_random(ef, t: int, cfg: CompressorConfig, backend):
    """Shared random offsets for step ``t`` over ef's per-worker view."""
    del backend
    return random_offsets(t, cfg, tuple(ef.shape[1:]), ef.device)


def random_offsets(t: int, cfg: CompressorConfig, work: Sequence[int], device) -> torch.Tensor:
    """random_k's shared offsets for step ``t`` over a work view ``work`` (the
    per-tensor dims, chunks along the last): (*work[:-1], n_chunks[, topm]).

    When the trailing axis is no chunk multiple, the last chunk holds only
    ``size mod chunk`` real elements: draws are confined to them (topm == 1
    clamps the offset; topm > 1 ranks the past-the-end lanes below every real
    one), so no billed value is dropped from ĝ. Top-m draws are without
    replacement: the top-m of uniform keys per chunk. A rank that holds part
    of a tensor takes its chunks' rows of this draw over the whole tensor.
    """
    lead = tuple(work[:-1])  # per-tensor dims before the chunked axis
    size, chunk = work[-1], cfg.chunk
    n_ch = num_chunks(size, chunk)
    tail = size - (n_ch - 1) * chunk  # real width of the last chunk
    if cfg.topm == 1:
        idx = random_draw(t, lead + (n_ch,), device, high=chunk)
        if tail < chunk:
            last = torch.arange(n_ch, device=device) == n_ch - 1
            idx = torch.minimum(idx, torch.where(last, tail - 1, chunk - 1).to(torch.int32))
        return idx
    r = random_draw(t, lead + (n_ch, chunk), device)
    if tail < chunk:
        valid = (torch.arange(n_ch, device=device)[:, None] < n_ch - 1) | (
            torch.arange(chunk, device=device)[None, :] < tail
        )
        r = torch.where(valid, r, -1.0)
    return _top_k(r, cfg.topm)


_SHARED_INDEX_SELECTORS = {
    "clt_k": _select_clt,
    "true_topk": _select_true,
    "random_k": _select_random,
}


def select_indices(ef, t: int, cfg: CompressorConfig, backend):
    """Chunked offsets for step ``t``: shared (..., n_chunks[, topm]) for
    clt_k/true_topk/random_k, per-worker (G, ..., n_chunks[, topm]) for
    local_topk."""
    if cfg.name == "local_topk":
        return backend.select_indices(ef, cfg.chunk, cfg.topm)
    return _SHARED_INDEX_SELECTORS[cfg.name](ef, t, cfg, backend)


def exact_k(size: int, cfg: CompressorConfig) -> int:
    """k of the exact (dense top-k) analysis path: size * topm / chunk."""
    return max(1, int(size * cfg.topm // cfg.chunk))


def _compress_exact(ef, t: int, cfg: CompressorConfig):
    n, size = ef.shape
    k = exact_k(size, cfg)
    if cfg.name == "clt_k":
        idx = leader_pick(_top_k(ef.abs(), k), t % n)
    elif cfg.name == "true_topk":
        idx = _top_k(torch.mean(ef, dim=0).abs(), k)
    elif cfg.name == "random_k":
        idx = _top_k(random_draw(t, (size,), ef.device), k)  # k distinct offsets
    elif cfg.name == "local_topk":
        idx_all = _top_k(ef.abs(), k)
        vals = torch.gather(ef, 1, idx_all.long())
        dense = torch.zeros_like(ef).scatter(1, idx_all.long(), vals)
        return vals, idx_all, torch.mean(dense, dim=0)
    else:
        raise ValueError(cfg.name)
    vals = torch.gather(ef, 1, idx.long().expand(n, k))
    dense = torch.zeros(size, dtype=ef.dtype, device=ef.device)
    dense[idx.long()] = torch.mean(vals, dim=0)
    return vals, idx, dense


def compress(ef, t: int, cfg: CompressorConfig, backend=None) -> Tuple:
    """Compress worker-stacked EF gradients ``ef`` (n, size) at step ``t``.

    backend: a resolved KernelBackend; None resolves "auto" for ef's device.

    Returns (values, indices, dense_mean):
      values:     (n, k) per-worker entries at the shared index set
                  (local_topk: each worker's own set)
      indices:    chunked: (n_chunks,) or (n_chunks, topm) per-chunk
                  offsets (local_topk: with a leading worker axis); exact:
                  (k,) offsets into the tensor
      dense_mean: (size,) dense reconstruction of the reduced gradient ĝ
    """
    if ef.dim() != 2:
        raise ValueError(f"ef must be (n_workers, size), got {tuple(ef.shape)}")
    n, size = ef.shape
    if cfg.name == "none":
        return ef, torch.zeros((0,), dtype=torch.int32, device=ef.device), torch.mean(ef, dim=0)
    if cfg.exact:
        return _compress_exact(ef, t, cfg)
    if backend is None:
        from repro_torch.backends import resolve_backend  # backends import core

        backend = resolve_backend("auto", ef.device)
    idx = select_indices(ef, t, cfg, backend)
    vals = backend.gather(ef, idx, cfg.chunk, cfg.topm)
    if cfg.name == "local_topk":
        # every worker its own offsets: gather semantics (gradient build-up)
        dense_each = backend.scatter(vals, idx, cfg.chunk, size, cfg.topm)
        return vals, idx, torch.mean(dense_each, dim=0)
    # commutative reduce: the mean over the worker axis touches only k values
    dense = backend.scatter(torch.mean(vals, dim=0), idx, cfg.chunk, size, cfg.topm)
    return vals, idx, dense
