"""ScaleCom's reduce on ``torch.distributed``: the port of
``repro.distributed.ring``, the paper's Remark 3 (CLT-k "naturally extends
to ring all-reduce settings") with real collectives between processes, and
what the reference's sharded step runs for the other compressors, the
exact path, hierarchical groups and buckets.

Each rank of a process group holds ITS worker's gradient and residue.
``ring_steps`` runs one tensor through Algorithm 1 with the collectives of
its compressor (n = ``group.size()`` workers; the leader is rank ``t mod
n``):

  clt_k       the leader forms ``ef = m + g`` and selects
              (``backend.select_indices``: the ``chunk_argmax`` kernel, or
              ``chunk_topm`` for top-m > 1); broadcast(offsets), O(k); every
              rank runs the fused Eq. 5 update (``backend.ef_update``: the
              ``ef_update`` kernel, vals and m' in one pass);
              all_reduce(values) / n, constant in n; ĝ by ``chunk_scatter``.
              ``fused``: the leader's select and update are one launch
              (``backend.fused_select_update``, the fused reduce's one-row
              variant); the other ranks update at the offsets they receive.
  true_topk   the paper's oracle: a dense all_reduce(ef) / n first (counted
              under ``sent["oracle"]``, outside the payload: the plan bills
              true_topk as clt_k), then as clt_k with the leader selecting
              on that worker mean (fused: the mean is the launch's key).
  random_k    every rank draws the shared offsets itself
              (``core.compressors.select_indices``, seeded by t), so
              nothing but the values moves.
  local_topk  every rank selects on its own ef and updates with its own
              offsets; all_gather(offsets) and all_gather(values), then ĝ is
              the mean over ranks of each rank's scattered values (the
              reference's union average), in rank order.
  exact       (``comp.exact``, the dense top-k analysis path) the same
              collectives over k = ``exact_k`` offsets into the whole
              tensor, picked by the stacked path's top-k
              (``compressors._top_k``): the leader's own top-k (true_topk:
              of the oracle's mean), the shared draw (random_k) or each
              rank's own (local_topk); Eq. 5 against each rank's own dense
              contribution.

``ring_steps`` is a generator: it yields each round of collectives it
needs (``Collective``) and takes their results back. ``Flight`` issues the
rounds of several tensors together, packing the ones it may into one call
(the reference's all-reduce combiner), with blocking calls or
``async_op=True``; ``ring_reduce`` drives one tensor with blocking calls,
and ``training.train_step`` one tensor after another, or bucket by bucket.

The offsets, m' and the values are bit for bit the stacked reduce's
(``core.scalecom``); ĝ differs from the stacked worker mean only by the
collective's summation order (local_topk's not at all: it averages the
gathered rows as the stacked reduce does), and a packed all-reduce sums in
yet another order. true_topk's leader selects on a mean summed in the
collective's order: where a chunk's top two magnitudes lie within that
rounding, its offset may differ from the stacked one. The reference ring
always selects top-1 (``chunk_argmax``, whatever ``cfg.topm`` says); this
one honours top-m, as the reference's stacked reduce does.

Hierarchical groups (``make_hierarchy``): with ``groups=G`` the world's n
ranks form G groups of n/G consecutive ranks, the reference's
``_group_fold``. ``group_fold`` averages a tensor over the rank's own group
(an all_gather, then the stacked fold's mean over the gathered rows, so
every rank of a group holds the stacked step's bits), and the compressor's
reduce runs over the inter group: the G ranks at the same position in each
group, whose leader is group ``t mod G``.

The ring calls ``broadcast``, ``all_reduce`` and ``all_gather``, which gloo
(the one backend that runs several ranks on one card) takes for CUDA
tensors, blocking or async (``tools/gloo_cuda_probe.py`` checks both on the
card), and never moves a tensor off its device. ``sent`` counts the bytes
this process has put into collectives as their source (module state, as
``fused_reduce.routes`` is): values on every rank, offsets on the leader
(local_topk: on every rank), dense tensors through ``all_reduce_mean``.
Those three are the payload (``payload_sent``): averaged over the ranks it
equals the plan's per-worker bytes (``core.plan``: 4k + 4k/G per clt_k
or true_topk tensor, 4k + 4k for local_topk, 4k for random_k, 4 x size per
dense one). Outside the payload, ``"oracle"`` counts true_topk's dense
all-reduce of ef, ``"intra"`` the rank's own rows into ``group_fold``,
``"stats"`` the all-reduce of ef that ``compute_stats`` needs for
contraction gamma and ``"telemetry"`` what the taps send (that all-reduce,
when only they need it, and the taps' own).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.backends import resolve_backend
from repro_torch.core import compressors
from repro_torch.core.chunked import num_chunks
from repro_torch.core.compressors import CompressorConfig, exact_k, random_draw, select_indices
from repro_torch.core.filter import lowpass_update

__all__ = [
    "Collective", "Flight", "Hierarchy", "all_reduce_mean", "clt_ring_reduce", "drive",
    "group_fold", "make_hierarchy", "make_ring_reducer", "payload_sent", "reset_sent",
    "ring_reduce", "ring_steps", "sent",
]

# bytes this process has put into collectives as their source
sent = {"values": 0, "indices": 0, "dense": 0, "oracle": 0, "intra": 0, "stats": 0,
        "telemetry": 0}
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


def group_fold(x: torch.Tensor, h: Hierarchy):
    """The mean of ``x`` over this rank's group, as a round generator
    (``Flight``): the group's rows gathered (``sent["intra"]`` counts this
    rank's) and averaged as ``core.scalecom._group_fold`` averages the
    stacked rows, so every rank of the group holds the same bits. A group of
    one rank returns ``x``."""
    if h.size == 1:
        return x
    (rows,) = yield [Collective("all_gather", x, h.intra, "intra")]
    return torch.mean(rows[None], dim=1)[0]


def _check_rows(g_local: torch.Tensor, m_local: torch.Tensor) -> None:
    if g_local.shape != m_local.shape or g_local.dim() == 0:
        raise ValueError(
            f"g_local and m_local must share one shape of at least one axis, got "
            f"{tuple(g_local.shape)} and {tuple(m_local.shape)}"
        )
    if g_local.dtype != torch.float32 or m_local.dtype != torch.float32:
        raise ValueError(f"g_local/m_local must be float32, got {g_local.dtype} / {m_local.dtype}")


@dataclasses.dataclass(eq=False)
class Collective:
    """One collective that a tensor's reduce asks for (``Flight`` issues it).

    op:      "all_reduce" (a sum), "broadcast" or "all_gather"
    tensor:  this rank's input: for a broadcast the source's data, and on
             every other rank a tensor of its shape and dtype
    group:   the process group
    kind:    the ``sent`` key its bytes count under (a broadcast's on the
             source only)
    src:     a broadcast's source, as a rank of ``group``
    pack:    whether a bucket may lay it end to end with its others of the
             same op, group, source, dtype and kind and make one call of
             them. A packed all-reduce sums each element in an order set by
             its place in the buffer, so only the payload and the taps are
             packed; the oracle's and the stats' all-reduces of ef keep
             their own calls, whose sums are the unbucketed step's bits.

    Its result is the sum, the source's tensor, or the (n, *shape) rows.
    """

    op: str
    tensor: torch.Tensor
    group: Any
    kind: str
    src: int = 0
    pack: bool = True


class _Call:
    """One ``torch.distributed`` call of one or more packed ``Collective``s."""

    def __init__(self, members: List[Collective], async_op: bool):
        c0 = members[0]
        self.members, self.op, n = members, c0.op, c0.group.size()
        me = dist.get_rank(c0.group)
        source = c0.op != "broadcast" or me == c0.src
        for c in members:
            if c.op != "broadcast" or me == c.src:
                sent[c.kind] += c.tensor.numel() * c.tensor.element_size()
        if len(members) > 1:
            total = sum(c.tensor.numel() for c in members)
            buf = (torch.cat([c.tensor.reshape(-1) for c in members]) if source else
                   torch.empty(total, dtype=c0.tensor.dtype, device=c0.tensor.device))
        elif c0.op == "all_reduce":
            buf = c0.tensor.clone(memory_format=torch.contiguous_format)  # summed in place
        else:
            buf = c0.tensor.contiguous()
        self.buf, self.rows = buf, None
        if c0.op == "all_reduce":
            self.work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=c0.group,
                                        async_op=async_op)
        elif c0.op == "broadcast":
            self.work = dist.broadcast(buf, src=dist.get_process_group_ranks(c0.group)[c0.src],
                                       group=c0.group, async_op=async_op)
        else:
            # a list, which every torch version's gloo takes (its
            # all_gather_into_tensor wants another output shape from version
            # to version)
            self.rows = [torch.empty_like(buf) for _ in range(n)]
            self.work = dist.all_gather(self.rows, buf, group=c0.group, async_op=async_op)

    def results(self) -> List[torch.Tensor]:
        """Each member's result, once the call is done (waits for it)."""
        if self.work is not None:
            self.work.wait()
        out = self.buf if self.rows is None else torch.stack(self.rows)
        if len(self.members) == 1:
            return [out]
        res, at = [], 0
        for c in self.members:
            size = c.tensor.numel()
            if self.rows is None:
                res.append(out[at:at + size].view(c.tensor.shape))
            else:
                res.append(out[:, at:at + size].reshape((out.shape[0],) + tuple(c.tensor.shape)))
            at += size
        return res


class Flight:
    """The reduce of one bucket's tensors, round of collectives by round.

    Each tensor's reduce is a generator (``ring_steps``, or a caller's
    steps around it) that yields a round, a list of ``Collective``, and is
    sent back their results in the same order, until it returns its
    outputs (kept in ``out``, in the generators' order). ``advance`` waits
    for the calls in flight, hands their results to the generators, runs
    each to its next round and issues the round of all of them together:
    the collectives that may be packed as one call per (op, group, source,
    dtype, kind) with their tensors laid end to end (the reference's
    all-reduce combiner, and DDP's buckets), the rest one call each, in
    the order the generators asked for them. With ``async_op`` every call
    returns at once and ``advance`` waits for it on its next call, when a
    later launch reads its result; else each call blocks. Every rank must
    hold the same generators in the same order, so that their calls match.
    """

    def __init__(self, steps, async_op: bool):
        self.steps = list(steps)
        self.out: list = [None] * len(self.steps)
        self.async_op = async_op
        self._done = [False] * len(self.steps)
        self._calls: Optional[list] = None  # the round in flight: [(_Call, [(gen, slot)])]
        self._started = False

    def advance(self) -> bool:
        """Run the generators one round on; True while calls are in flight."""
        got: list = [None] * len(self.steps)
        if self._started:
            for i, sizes in enumerate(self._sizes):
                got[i] = [None] * sizes
            for call, slots in self._calls:
                for (i, j), res in zip(slots, call.results()):
                    got[i][j] = res
        rounds = []
        for i, gen in enumerate(self.steps):
            req: list = []
            if not self._done[i]:
                try:
                    req = list(gen.send(got[i]) if self._started else next(gen))
                except StopIteration as stop:
                    self.out[i], self._done[i] = stop.value, True
            rounds.append(req)
        self._started = True
        self._sizes = [len(r) for r in rounds]
        packs: dict = {}
        for i, req in enumerate(rounds):
            for j, c in enumerate(req):
                key = ((c.op, id(c.group), c.src, c.tensor.dtype, c.kind) if c.pack
                       else (i, j))
                packs.setdefault(key, []).append((i, j, c))
        self._calls = [(_Call([c for _, _, c in members], self.async_op),
                        [(i, j) for i, j, _ in members]) for members in packs.values()]
        return bool(self._calls) or not all(self._done)


def drive(steps):
    """Run one tensor's reduce generator with blocking calls; its outputs."""
    flight = Flight([steps], async_op=False)
    while flight.advance():
        pass
    return flight.out[0]


def ring_steps(g_local, m_local, t: int, cfg: CompressorConfig, beta: float, group, backend,
               fused: bool = False):
    """Algorithm 1 for one tensor with the collectives of its compressor (the
    module docstring), as a generator of ``Collective`` rounds (``Flight``).

    g_local/m_local: this rank's fp32 gradient and residue in the plan's
    trailing-axis work view. ``fused`` (clt_k, true_topk): the leader's
    select and Eq. 5 update are one ``backend.fused_select_update``.
    Returns (ghat, m_new, vals, idx): ĝ, identical on every rank; this
    rank's new residue, its values and the offsets it updated at (exact:
    k offsets into the tensor).
    """
    n, me = group.size(), dist.get_rank(group)
    leader = int(t) % n
    chunk, topm, size = cfg.chunk, cfg.topm, g_local.shape[-1]
    if cfg.exact:
        return (yield from _exact_steps(g_local, m_local, t, cfg, beta, group))
    if cfg.name == "local_topk":
        idx = backend.select_indices(m_local + g_local, chunk, topm)
        m_new, vals = backend.ef_update(m_local, g_local, idx, beta, chunk, topm)
        idx_all, vals_all = yield [Collective("all_gather", idx, group, "indices"),
                                   Collective("all_gather", vals, group, "values")]
        dense = backend.scatter(vals_all, idx_all, chunk, size, topm)
        return torch.mean(dense, dim=0), m_new, vals, idx
    m_new = None
    if cfg.name == "random_k":
        idx = select_indices(g_local[None], t, cfg, backend)
    else:
        key = None
        if cfg.name == "true_topk":
            (total,) = yield [Collective("all_reduce", m_local + g_local, group, "oracle",
                                         pack=False)]
            key = total / n
        if me == leader and fused:
            idx, vals, m_new = backend.fused_select_update(m_local, g_local, beta, chunk, topm,
                                                           key)
        elif me == leader:
            idx = backend.select_indices(m_local + g_local if key is None else key, chunk, topm)
        else:
            tail = () if topm == 1 else (topm,)
            idx = torch.empty(tuple(g_local.shape[:-1]) + (num_chunks(size, chunk),) + tail,
                              dtype=torch.int32, device=g_local.device)
        (idx,) = yield [Collective("broadcast", idx, group, "indices", src=leader)]
    if m_new is None:
        m_new, vals = backend.ef_update(m_local, g_local, idx, beta, chunk, topm)
    (total,) = yield [Collective("all_reduce", vals, group, "values")]
    return backend.scatter(total / n, idx, chunk, size, topm), m_new, vals, idx


def _exact_steps(g_local, m_local, t: int, cfg: CompressorConfig, beta: float, group):
    """The exact path (``comp.exact``) on this rank's flat rows: k =
    ``exact_k`` offsets of a dense top-k (``compressors._top_k``, the
    stacked path's, ties to the lower offset). clt_k: the leader's own
    top-k, broadcast; true_topk: the top-k of the oracle's mean on the
    leader, broadcast; random_k: the shared draw; local_topk: each rank's
    own, all_gather of offsets and values. Then each rank's own dense
    contribution for Eq. 5, and ĝ from the all-reduced values (local_topk:
    the mean of the gathered rows scattered densely)."""
    n, me = group.size(), dist.get_rank(group)
    size = g_local.shape[-1]
    k = exact_k(size, cfg)
    ef = m_local + g_local
    if cfg.name == "local_topk":
        idx = compressors._top_k(ef.abs(), k)
        vals = ef[idx.long()]
        idx_all, vals_all = yield [Collective("all_gather", idx, group, "indices"),
                                   Collective("all_gather", vals, group, "values")]
        dense = torch.zeros((n, size), dtype=ef.dtype, device=ef.device)
        ghat = torch.mean(dense.scatter(1, idx_all.long(), vals_all), dim=0)
    else:
        if cfg.name == "random_k":
            idx = compressors._top_k(random_draw(t, (size,), ef.device), k)
        else:
            key = ef
            if cfg.name == "true_topk":
                (total,) = yield [Collective("all_reduce", ef, group, "oracle", pack=False)]
                key = total / n
            leader = int(t) % n
            idx = (compressors._top_k(key.abs(), k) if me == leader else
                   torch.empty(k, dtype=torch.int32, device=ef.device))
            (idx,) = yield [Collective("broadcast", idx, group, "indices", src=leader)]
        vals = ef[idx.long()]
        (total,) = yield [Collective("all_reduce", vals, group, "values")]
        ghat = torch.zeros(size, dtype=ef.dtype, device=ef.device)
        ghat[idx.long()] = total / n
    own = torch.zeros_like(ef).scatter(0, idx.long(), vals)
    return ghat, lowpass_update(m_local, g_local, own, beta), vals, idx


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
    return ring_reduce(g_local, m_local, t, cfg, beta, group, backend)


def ring_reduce(
    g_local: torch.Tensor,
    m_local: torch.Tensor,
    t: int,
    cfg: CompressorConfig,
    beta: float,
    group,
    backend=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``clt_ring_reduce`` for any compressor, chunked or exact (the module
    docstring gives each one's collectives), with blocking calls: (ghat,
    m_new) from this rank's fp32 gradient and residue rows, ghat identical
    on every rank. "none" raises ValueError."""
    if cfg.name not in ("clt_k", "true_topk", "random_k", "local_topk"):
        raise ValueError(f"ring_reduce runs clt_k, true_topk, local_topk or random_k; got "
                         f"compressor {cfg.name!r}")
    _check_rows(g_local, m_local)
    backend = resolve_backend(backend or "auto", g_local.device)
    return drive(ring_steps(g_local, m_local, t, cfg, beta, group, backend))[:2]


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
