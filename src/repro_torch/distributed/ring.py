"""Explicit CLT-k all-reduce on ``torch.distributed``: the port of
``repro.distributed.ring``, the paper's Remark 3 (CLT-k "naturally extends
to ring all-reduce settings") with real collectives between processes.

Each rank of a process group holds ITS worker's gradient and residue, and
the only collectives of a compressed tensor are

    broadcast(offsets)        the leader's int32 per-chunk index set, O(k)
    all_reduce(values) / n    the k-element compressed all-reduce, constant in n

In the reference both are ``psum`` inside ``shard_map`` (the index set as a
masked sum). Here only the leader's rank (``t mod n``) forms ``ef = m + g``
and selects (``backend.select_indices``: the ``chunk_argmax`` kernel, or
``chunk_topm`` for top-m > 1), then every rank runs the fused Eq. 5 update
(``backend.ef_update``: the ``ef_update`` kernel, vals and m' in one pass)
and scatters the worker-mean values into ĝ (``chunk_scatter``). The
reference selects on every device and keeps the leader's; the indices are
the same, and so are m' and the values, bit for bit, as the stacked reduce's
(``core.scalecom``); ĝ differs from the stacked worker mean only by the
collective's summation order. The reference ring always selects top-1
(``chunk_argmax``, whatever ``cfg.topm`` says); this one honours top-m, as
the reference's stacked reduce does.

The ring calls only ``broadcast`` and ``all_reduce``, which every
``torch.distributed`` backend implements for CUDA tensors, and never moves a
tensor off its device. ``sent`` counts the payload bytes this process has put
into collectives as their source (module state, as ``fused_reduce.routes``
is): values on every rank, offsets on the leader, dense tensors through
``all_reduce_mean``. Averaged over the ranks it equals the plan's
per-worker bytes (``core.plan``: 4k + 4k/n per compressed tensor, 4 x size
per dense one).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.backends import resolve_backend
from repro_torch.core.chunked import num_chunks
from repro_torch.core.compressors import CompressorConfig

__all__ = ["clt_ring_reduce", "make_ring_reducer", "all_reduce_mean", "sent", "reset_sent"]

# payload bytes this process has put into collectives as their source
sent = {"values": 0, "indices": 0, "dense": 0}


def reset_sent() -> None:
    """Set every count of ``sent`` to 0."""
    for key in sent:
        sent[key] = 0


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks (a dense all-reduce, then a
    division by n), counted under ``sent["dense"]``."""
    out = x.clone(memory_format=torch.contiguous_format)
    sent["dense"] += out.numel() * out.element_size()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / group.size()


def clt_ring_reduce(
    g_local: torch.Tensor,
    m_local: torch.Tensor,
    t: int,
    cfg: CompressorConfig,
    beta: float,
    group,
    backend=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor through Algorithm 1 with one ScaleCom worker per rank of
    ``group`` (n = ``group.size()`` workers, the leader is rank ``t mod n``).

    g_local/m_local: this rank's fp32 gradient and residue in the plan's
    trailing-axis work view ((size,) for the flat layout; chunks run along
    the last axis). ``backend``: a KernelBackend or its name; None resolves
    "auto" for the tensors' device. Returns (ghat, m_new): ghat identical on
    every rank.
    """
    if cfg.name != "clt_k" or cfg.exact:
        raise ValueError(
            f"clt_ring_reduce runs chunked clt_k (CLT-k's shared leader index set is "
            f"what makes the all-reduce O(k)); got compressor {cfg.name!r}"
            + (" with exact=True" if cfg.exact else "")
        )
    if g_local.shape != m_local.shape or g_local.dim() == 0:
        raise ValueError(
            f"g_local and m_local must share one shape of at least one axis, got "
            f"{tuple(g_local.shape)} and {tuple(m_local.shape)}"
        )
    if g_local.dtype != torch.float32 or m_local.dtype != torch.float32:
        raise ValueError(f"g_local/m_local must be float32, got {g_local.dtype} / {m_local.dtype}")
    backend = resolve_backend(backend or "auto", g_local.device)
    n, me = group.size(), dist.get_rank(group)
    leader = int(t) % n
    chunk, topm, size = cfg.chunk, cfg.topm, g_local.shape[-1]
    if me == leader:
        idx = backend.select_indices(m_local + g_local, chunk, topm).contiguous()
        sent["indices"] += idx.numel() * idx.element_size()
    else:
        tail = () if topm == 1 else (topm,)
        idx = torch.empty(tuple(g_local.shape[:-1]) + (num_chunks(size, chunk),) + tail,
                          dtype=torch.int32, device=g_local.device)
    # O(k) index broadcast from the leader's rank
    dist.broadcast(idx, src=dist.get_process_group_ranks(group)[leader], group=group)
    m_new, vals = backend.ef_update(m_local, g_local, idx, beta, chunk, topm)
    vals = vals.contiguous()
    sent["values"] += vals.numel() * vals.element_size()
    # the compressed all-reduce: k values, constant in n
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    ghat = backend.scatter(vals / n, idx, chunk, size, topm)
    return ghat, m_new


def make_ring_reducer(group, cfg: CompressorConfig, beta: float, backend=None):
    """``reducer(g_row, m_row, t) -> (ghat_row, m_new_row)`` over this rank's
    (1, size) rows, as the reference's ``per_device`` maps a worker-stacked
    (n, size) tensor one row per device."""

    def reducer(g_row: torch.Tensor, m_row: torch.Tensor, t: int):
        if g_row.dim() != 2 or g_row.shape[0] != 1:
            raise ValueError(f"reducer takes this rank's (1, size) row, got {tuple(g_row.shape)}")
        ghat, m_new = clt_ring_reduce(g_row[0], m_row[0], t, cfg, beta, group, backend)
        return ghat[None], m_new[None]

    return reducer
