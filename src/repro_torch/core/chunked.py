"""Chunked sparsification primitives over the trailing axis: the plain versions.

The port of ``repro.core.chunked``. Every op chunks the LAST axis of an
arbitrarily batched tensor,

    x: (..., n)  ->  per-chunk results over (..., n_chunks[, topm])

so a flat buffer, a worker-stacked ``(G, size)`` tensor and a
layout-preserving ``(G, *param_shape)`` tensor are one call. These are the
ops of the ``"torch"`` backend: the reference on any device and the path of
a CPU run. The trailing axis is zero-padded to a chunk multiple, which is
select-safe (see ``pad_to_chunks``), and ``chunk_scatter`` slices the result
back to the requested size.

Tie order matches the JAX package: ``torch.argmax`` returns the first maximal
index like ``jnp.argmax``, and ``chunk_topm_indices`` takes m masked-argmax
passes (descending magnitude, ties to the lower offset, as
``jax.lax.top_k``) instead of ``torch.topk``, whose tie order is not
guaranteed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "num_chunks",
    "pad_to_chunks",
    "chunk_view",
    "chunk_argmax",
    "chunk_topm_indices",
    "chunk_gather",
    "chunk_scatter",
]


def num_chunks(n: int, chunk: int) -> int:
    """Number of chunks covering n elements (last chunk zero-padded)."""
    return -(-n // chunk)


def pad_to_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Zero-pad the trailing axis to a multiple of ``chunk``.

    A padded lane can win the arg-max only if its whole chunk is zero; the
    selected value is then 0 and the scatter writes 0, a no-op.
    """
    pad = (-x.shape[-1]) % chunk
    return F.pad(x, (0, pad)) if pad else x


def chunk_view(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(..., n) -> (..., n_chunks, chunk), zero-padding the trailing axis."""
    xp = pad_to_chunks(x, chunk)
    return xp.reshape(xp.shape[:-1] + (xp.shape[-1] // chunk, chunk))


def chunk_argmax(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per-chunk magnitude arg-max. (..., n) -> (..., n_chunks) int32."""
    return torch.argmax(chunk_view(x, chunk).abs(), dim=-1).to(torch.int32)


def chunk_topm_indices(x: torch.Tensor, chunk: int, m: int) -> torch.Tensor:
    """Per-chunk top-m magnitude offsets. (..., n) -> (..., n_chunks, m) int32."""
    mag = chunk_view(x, chunk).abs()
    picks = []
    for _ in range(m):
        ij = torch.argmax(mag, dim=-1, keepdim=True)
        picks.append(ij)
        mag = mag.scatter(-1, ij, -1.0)  # below every magnitude
    return torch.cat(picks, dim=-1).to(torch.int32)


def chunk_gather(
    x: torch.Tensor, idx: torch.Tensor, chunk: int, topm: Optional[int] = None
) -> torch.Tensor:
    """Values of (..., n) ``x`` at per-chunk offsets ``idx``.

    idx broadcasts against x's leading dims (a shared leader set against
    worker-stacked data) and ends in (..., n_chunks) or, for top-m,
    (..., n_chunks, topm). ``topm=None`` infers a top-m tail from
    ``idx.dim() > x.dim()``; pass it explicitly when that is ambiguous.
    """
    c = chunk_view(x, chunk)
    if topm is None:
        topm = idx.shape[-1] if idx.dim() > x.dim() else 1
    i = idx[..., None] if topm == 1 else idx
    lead = torch.broadcast_shapes(c.shape[:-2], i.shape[:-2])
    c = c.expand(lead + c.shape[-2:])
    i = i.expand(lead + i.shape[-2:])
    out = torch.gather(c, -1, i.long())
    return out[..., 0] if topm == 1 else out


def _scatter_one(vals: torch.Tensor, idx: torch.Tensor, chunk: int) -> torch.Tensor:
    """Broadcast (vals, idx) over (..., n_chunks) -> dense (..., n_chunks*chunk)."""
    shape = torch.broadcast_shapes(idx.shape, vals.shape)
    lanes = torch.arange(chunk, dtype=torch.int32, device=vals.device)
    z = torch.where(lanes == idx[..., None], vals[..., None], 0.0)
    return z.expand(shape + (chunk,)).reshape(shape[:-1] + (shape[-1] * chunk,))


def chunk_scatter(
    vals: torch.Tensor, idx: torch.Tensor, chunk: int, size: int, topm: int = 1
) -> torch.Tensor:
    """Dense (..., size) with per-chunk ``vals`` at ``idx``, zeros elsewhere.

    vals and idx broadcast against each other; for topm > 1 both end in
    (..., n_chunks, topm) and the entries are summed in order. Writes into
    the zero-padded tail chunk are dropped by the slice to ``size``.
    """
    if topm == 1:
        out = _scatter_one(vals, idx, chunk)
    else:
        out = _scatter_one(vals[..., 0], idx[..., 0], chunk)
        for j in range(1, topm):
            out = out + _scatter_one(vals[..., j], idx[..., j], chunk)
    return out[..., :size]
