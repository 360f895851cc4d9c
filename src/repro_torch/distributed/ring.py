"""ScaleCom's reduce on ``torch.distributed``: the port of
``repro.distributed.ring``, the paper's Remark 3 (CLT-k "naturally extends
to ring all-reduce settings") with real collectives between processes, and
what the reference's sharded step runs for the other compressors and for
hierarchical groups.

Each rank of a process group holds ITS worker's gradient and residue.
``ring_reduce`` runs one tensor through Algorithm 1 with the collectives of
its compressor (n = ``group.size()`` workers; the leader is rank ``t mod
n``):

  clt_k       ``clt_ring_reduce``: the leader forms ``ef = m + g`` and selects
              (``backend.select_indices``: the ``chunk_argmax`` kernel, or
              ``chunk_topm`` for top-m > 1); broadcast(offsets), O(k); every
              rank runs the fused Eq. 5 update (``backend.ef_update``: the
              ``ef_update`` kernel, vals and m' in one pass);
              all_reduce(values) / n, constant in n; ĝ by ``chunk_scatter``.
  true_topk   the paper's oracle: a dense all_reduce(ef) / n first (counted
              under ``sent["oracle"]``, outside the payload: the plan bills
              true_topk as clt_k), then as clt_k with the leader selecting
              on that worker mean.
  random_k    every rank draws the shared offsets itself
              (``core.compressors.select_indices``, seeded by t), so
              nothing but the values moves.
  local_topk  every rank selects on its own ef and updates with its own
              offsets; all_gather(offsets) and all_gather(values), then ĝ is
              the mean over ranks of each rank's scattered values (the
              reference's union average), in rank order.

The offsets, m' and the values are bit for bit the stacked reduce's
(``core.scalecom``); ĝ differs from the stacked worker mean only by the
collective's summation order (local_topk's not at all: it averages the
gathered rows as the stacked reduce does). true_topk's leader selects on a
mean summed in the collective's order: where a chunk's top two magnitudes
lie within that rounding, its offset may differ from the stacked one. The
reference ring always selects top-1 (``chunk_argmax``, whatever
``cfg.topm`` says); this one honours top-m, as the reference's stacked
reduce does.

Hierarchical groups (``make_hierarchy``): with ``groups=G`` the world's n
ranks form G groups of n/G consecutive ranks, the reference's
``_group_fold``. ``group_fold`` averages a tensor over the rank's own group
(an all_gather, then the stacked fold's mean over the gathered rows, so
every rank of a group holds the stacked step's bits), and the compressor's
reduce runs over the inter group: the G ranks at the same position in each
group, whose leader is group ``t mod G``.

The ring calls ``broadcast``, ``all_reduce`` and ``all_gather``, which gloo
(the one backend that runs several ranks on one card) takes for CUDA
tensors (``tools/gloo_cuda_probe.py`` checks it on the card), and never
moves a tensor off its device. ``sent`` counts the bytes this process has
put into collectives as their source (module state, as
``fused_reduce.routes`` is): values on every rank, offsets on the leader
(local_topk: on every rank), dense tensors through ``all_reduce_mean``.
Those three are the payload (``payload_sent``): averaged over the ranks it
equals the plan's per-worker bytes (``core.plan``: 4k + 4k/G per clt_k
or true_topk tensor, 4k + 4k for local_topk, 4k for random_k, 4 x size per
dense one). Outside the payload, ``"oracle"`` counts true_topk's dense
all-reduce of ef, ``"intra"`` the rank's own rows into ``group_fold`` and
``"stats"`` the all-reduce of ef that ``compute_stats`` needs for
contraction gamma.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.backends import resolve_backend
from repro_torch.core.chunked import num_chunks
from repro_torch.core.compressors import CompressorConfig, select_indices

__all__ = [
    "Hierarchy", "all_reduce_mean", "clt_ring_reduce", "group_fold", "make_hierarchy",
    "make_ring_reducer", "payload_sent", "reset_sent", "ring_reduce", "sent",
]

# bytes this process has put into collectives as their source
sent = {"values": 0, "indices": 0, "dense": 0, "oracle": 0, "intra": 0, "stats": 0}
# the keys the plan's per-worker bytes bill
PAYLOAD = ("values", "indices", "dense")


def reset_sent() -> None:
    """Set every count of ``sent`` to 0."""
    for key in sent:
        sent[key] = 0


def payload_sent() -> int:
    """The payload bytes of ``sent``: values, offsets and dense tensors."""
    return sum(sent[key] for key in PAYLOAD)


def all_reduce_mean(x: torch.Tensor, group, kind: str = "dense") -> torch.Tensor:
    """The mean of ``x`` over the group's ranks (a dense all-reduce, then a
    division by n), its bytes counted under ``sent[kind]``."""
    out = x.clone(memory_format=torch.contiguous_format)
    sent[kind] += out.numel() * out.element_size()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / group.size()


def all_gather_rows(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in the group's rank order (one
    ``all_gather`` into a list, which every torch version's gloo takes; its
    ``all_gather_into_tensor`` wants another output shape from version to
    version); this rank's ``x`` counted under ``sent[kind]``."""
    x = x.contiguous()
    rows = [torch.empty_like(x) for _ in range(group.size())]
    sent[kind] += x.numel() * x.element_size()
    dist.all_gather(rows, x, group=group)
    return torch.stack(rows)


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """This rank's place among G groups of n/G consecutive ranks.

    size:    n/G, the ranks a group averages densely
    index:   this rank's group, which is its residue row
    intra:   the process group of this rank's group
    inter:   the process group of the G ranks at this rank's position in
             each group, where the compressor's reduce runs
    """

    size: int
    index: int
    intra: Any
    inter: Any


# (id of the world, G) -> (the world, its Hierarchy): built once per world
_HIERARCHIES: dict = {}


def make_hierarchy(world, groups: int) -> Hierarchy:
    """This rank's two process groups for ``groups`` = G groups over the
    ``world`` group's n ranks (the reference's ``_group_fold``: group i is
    ranks i*n/G .. (i+1)*n/G - 1).

    ``dist.new_group`` is collective: every rank of the world calls this,
    with the same G, and creates every subgroup in the same order, its own
    or not. The result is cached per world and G, so later calls create
    nothing. A G that does not divide n raises ValueError.
    """
    n = world.size()
    if groups < 1 or n % groups:
        raise ValueError(
            f"{n} workers not divisible into {groups} groups: a world of {n} ranks, one "
            f"worker each, needs n % groups == 0 (n={n}, G={groups})")
    hit = _HIERARCHIES.get((id(world), groups))
    if hit is not None and hit[0] is world:
        return hit[1]
    ranks = dist.get_process_group_ranks(world)
    me, size = dist.get_rank(world), n // groups
    intra = inter = None
    for i in range(groups):
        pg = dist.new_group([ranks[i * size + j] for j in range(size)])
        if me // size == i:
            intra = pg
    for j in range(size):
        pg = dist.new_group([ranks[i * size + j] for i in range(groups)])
        if me % size == j:
            inter = pg
    h = Hierarchy(size=size, index=me // size, intra=intra, inter=inter)
    _HIERARCHIES[(id(world), groups)] = (world, h)
    return h


def group_fold(x: torch.Tensor, h: Hierarchy) -> torch.Tensor:
    """The mean of ``x`` over this rank's group: the group's rows gathered
    (``sent["intra"]`` counts this rank's) and averaged as
    ``core.scalecom._group_fold`` averages the stacked rows, so every rank
    of the group holds the same bits. A group of one rank returns ``x``."""
    if h.size == 1:
        return x
    rows = all_gather_rows(x, h.intra, "intra")
    return torch.mean(rows[None], dim=1)[0]


def _check_rows(g_local: torch.Tensor, m_local: torch.Tensor) -> None:
    if g_local.shape != m_local.shape or g_local.dim() == 0:
        raise ValueError(
            f"g_local and m_local must share one shape of at least one axis, got "
            f"{tuple(g_local.shape)} and {tuple(m_local.shape)}"
        )
    if g_local.dtype != torch.float32 or m_local.dtype != torch.float32:
        raise ValueError(f"g_local/m_local must be float32, got {g_local.dtype} / {m_local.dtype}")


def _leader_offsets(ef, t: int, cfg: CompressorConfig, group, backend) -> torch.Tensor:
    """The leader's (rank ``t mod n``) offsets of ``ef``, on every rank: it
    selects, then one O(k) broadcast (counted under ``sent["indices"]`` on
    the leader). ``ef`` is read on the leader only."""
    n, me = group.size(), dist.get_rank(group)
    leader = int(t) % n
    if me == leader:
        idx = backend.select_indices(ef, cfg.chunk, cfg.topm).contiguous()
        sent["indices"] += idx.numel() * idx.element_size()
    else:
        tail = () if cfg.topm == 1 else (cfg.topm,)
        idx = torch.empty(tuple(ef.shape[:-1]) + (num_chunks(ef.shape[-1], cfg.chunk),) + tail,
                          dtype=torch.int32, device=ef.device)
    dist.broadcast(idx, src=dist.get_process_group_ranks(group)[leader], group=group)
    return idx


def _shared_reduce(g_local, m_local, idx, cfg: CompressorConfig, beta: float, group, backend):
    """Eq. 5 at offsets every rank holds, then the compressed all-reduce:
    k values (``sent["values"]``), constant in n; ĝ by the scatter."""
    m_new, vals = backend.ef_update(m_local, g_local, idx, beta, cfg.chunk, cfg.topm)
    vals = vals.contiguous()
    sent["values"] += vals.numel() * vals.element_size()
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    ghat = backend.scatter(vals / group.size(), idx, cfg.chunk, g_local.shape[-1], cfg.topm)
    return ghat, m_new


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
    _check_rows(g_local, m_local)
    backend = resolve_backend(backend or "auto", g_local.device)
    ef = m_local + g_local if dist.get_rank(group) == int(t) % group.size() else g_local
    idx = _leader_offsets(ef, t, cfg, group, backend)
    return _shared_reduce(g_local, m_local, idx, cfg, beta, group, backend)


def _true_topk_reduce(g_local, m_local, t, cfg, beta, group, backend):
    """The oracle: a dense all_reduce(ef) / n (``sent["oracle"]``, 4 x size
    a rank), the leader's offsets of that mean, then as clt_k."""
    mean = all_reduce_mean(m_local + g_local, group, "oracle")
    idx = _leader_offsets(mean, t, cfg, group, backend)
    return _shared_reduce(g_local, m_local, idx, cfg, beta, group, backend)


def _random_k_reduce(g_local, m_local, t, cfg, beta, group, backend):
    """The shared draw of step t on every rank (no offsets move), then as
    clt_k."""
    idx = select_indices(g_local[None], t, cfg, backend)
    return _shared_reduce(g_local, m_local, idx, cfg, beta, group, backend)


def _local_topk_reduce(g_local, m_local, t, cfg, beta, group, backend):
    """Each rank's own offsets and Eq. 5; all_gather of every rank's
    offsets and values (4k + 4k a rank, ``sent["indices"]`` and
    ``sent["values"]``); ĝ the mean over the gathered rows scattered, as
    the stacked reduce's union average."""
    del t
    idx = backend.select_indices(m_local + g_local, cfg.chunk, cfg.topm)
    m_new, vals = backend.ef_update(m_local, g_local, idx, beta, cfg.chunk, cfg.topm)
    idx_all = all_gather_rows(idx, group, "indices")
    vals_all = all_gather_rows(vals, group, "values")
    dense = backend.scatter(vals_all, idx_all, cfg.chunk, g_local.shape[-1], cfg.topm)
    return torch.mean(dense, dim=0), m_new


_RING = {
    "true_topk": _true_topk_reduce,
    "random_k": _random_k_reduce,
    "local_topk": _local_topk_reduce,
}


def ring_reduce(
    g_local: torch.Tensor,
    m_local: torch.Tensor,
    t: int,
    cfg: CompressorConfig,
    beta: float,
    group,
    backend=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``clt_ring_reduce`` for any chunked compressor (see the module
    docstring for each one's collectives): (ghat, m_new) from this rank's
    fp32 gradient and residue rows, ghat identical on every rank. The exact
    path and "none" raise ValueError."""
    if cfg.name == "clt_k" and not cfg.exact:
        return clt_ring_reduce(g_local, m_local, t, cfg, beta, group, backend)
    if cfg.name not in _RING or cfg.exact:
        raise ValueError(
            f"ring_reduce runs chunked clt_k, true_topk, local_topk or random_k; got "
            f"compressor {cfg.name!r}" + (" with exact=True" if cfg.exact else ""))
    _check_rows(g_local, m_local)
    backend = resolve_backend(backend or "auto", g_local.device)
    return _RING[cfg.name](g_local, m_local, t, cfg, beta, group, backend)


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
