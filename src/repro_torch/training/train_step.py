"""Train step: per-worker gradients + ScaleCom reduce + optimizer.

The port of ``repro.training.train_step``. Two variants:

  * **scalecom**: the paper's path. ``per_worker_grads`` takes every
    worker's gradient in one batched pass: ``torch.func.vmap`` of
    ``grad_and_value(model.loss)`` with the parameters shared and the batch
    split along its worker axis. That is the torch form of the JAX package's
    broadcast of the parameters to a worker axis under one vmapped
    ``value_and_grad``, because worker i's loss reads only its own copy.
    ``microbatches=M`` splits each worker's batch into M chunks taken one
    after another and accumulates their gradients in fp32, as the reference
    does in a ``lax.scan``. ``scalecom_reduce`` then runs Algorithm 1 once
    per step. ``per_worker_grads_loop`` (one ``torch.autograd.grad`` per
    worker) is the plain version the tests hold the batched pass against.
  * **dense**: the uncompressed baseline and the compression warm-up: one
    loss over the folded global batch, gradients reduced by the mean that
    the folding implies.

With ``group`` (a ``torch.distributed`` process group, the counterpart of
the reference's ``worker_axis``) each rank of the group is one worker: it
takes its row of the global batch and its own gradient, and the reduce runs
through real collectives (``repro_torch.distributed.ring``): a compressed
tensor through the compressor's reduce (``ring.ring_steps``: any
compressor, chunked or exact, fused or not), a dense one (and every
gradient of the dense mode) through an all-reduce and a division by n;
tensor by tensor, or bucket by bucket with packed async collectives. With
``ScaleComConfig.groups=G`` the world's ranks form G groups of n/G
(``ring.make_hierarchy``): each gradient is averaged over the rank's group
first (``ring.group_fold``), and the reduce runs across the groups, each
rank of a group holding a replica of the group's residue row. The
residues are this rank's row, or its group's, in any codec
(``shard_train_state``); params and optimizer state are replicated and
stay bitwise identical across ranks.

Batches arrive worker-stacked, as numpy arrays or tensors
({"tokens": (n, B, S), ...}), and are moved to the parameters' device here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.backends import FUSABLE_MODES, resolve_backend, resolve_fused
from repro_torch.core import overlap
from repro_torch.core import state as state_codecs
from repro_torch.core.metrics import hamming_distance_topk, spearman_rho, topk_overlap
from repro_torch.core.plan import plan_tensors
from repro_torch.core.scalecom import _SIMILARITY_KEYS, ScaleComConfig, _const, scalecom_reduce
from repro_torch.core.state import (
    ScaleComState, codec_key, codec_signature, init_state, require_codec, residue_signature,
)
from repro_torch.device import fp32_accumulation
from repro_torch.distributed.ring import (
    Collective, Flight, all_reduce_mean, drive, group_fold, make_hierarchy, ring_steps,
)
from repro_torch.kernels.fused_reduce import select_update_fits
from repro_torch.obs import taps
from repro_torch.optim.optimizer import Optimizer

__all__ = [
    "TrainState", "build_train_step", "init_train_state", "shard_train_state", "global_norm",
    "per_worker_grads", "per_worker_grads_loop", "dense_grads",
]


@dataclasses.dataclass
class TrainState:
    params: Dict
    opt_state: Dict
    sc_state: ScaleComState
    step: int = 0


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed in JAX's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree.leaves(grads)))


def _batch_on(batch, device: torch.device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _check_lead(batch, n_workers: int) -> Dict:
    """The batch leaves' shapes; raises unless each leads with ``n_workers``."""
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    if any(s[0] != n_workers for s in shapes.values()):
        raise ValueError(f"batch leaves {shapes} do not lead with {n_workers} workers")
    return shapes


def _with_grad(params):
    """Leaf tensors sharing the parameters' storage, with autograd on."""
    return tree.tree_map(lambda p: p.detach().requires_grad_(True), params)


def per_worker_grads(model, params, batch, n_workers: int, microbatches: int = 1):
    """(mean worker loss, {aux: (n,) per-worker values}, {path: (n, *shape)
    gradients}); the aux dict is the model's (``nll``, and the MoE losses).

    One vmapped pass over the workers per microbatch. With ``microbatches``
    M > 1, microbatch j is rows j*B/M .. (j+1)*B/M - 1 of every worker's
    batch; the gradients are summed in fp32 and divided by M, the loss is
    the mean of the M passes' loss sums over n, and each aux the mean of its
    M per-worker values.
    """
    shapes = _check_lead(batch, n_workers)
    # (params, one worker's batch) -> (grads, (loss, aux)), mapped over the workers
    batched = torch.func.vmap(torch.func.grad_and_value(model.loss, has_aux=True),
                              in_dims=(None, 0))
    if microbatches == 1:
        grads, (losses, auxs) = batched(params, batch)
        return torch.sum(losses) / n_workers, auxs, grads
    B = next(iter(shapes.values()))[1]
    if B % microbatches:
        raise ValueError(f"per-worker batch {B} is not divisible by microbatches={microbatches}")
    mbs = {k: v.reshape((n_workers, microbatches, B // microbatches) + tuple(v.shape[2:]))
           for k, v in batch.items()}
    acc = tree.tree_map(
        lambda p: torch.zeros((n_workers,) + tuple(p.shape), dtype=torch.float32,
                              device=p.device), params)
    loss_sums, aux_passes = [], []
    for j in range(microbatches):
        grads, (losses, auxs) = batched(params, {k: v[:, j] for k, v in mbs.items()})
        for a, g in zip(tree.leaves(acc), tree.leaves(grads)):
            a.add_(g.to(torch.float32))
        del grads
        loss_sums.append(torch.sum(losses))
        aux_passes.append(auxs)
    for a in tree.leaves(acc):
        a.div_(microbatches)
    auxs = {k: torch.mean(torch.stack([a[k] for a in aux_passes]), dim=0) for k in aux_passes[0]}
    return torch.mean(torch.stack(loss_sums)) / n_workers, auxs, acc


def per_worker_grads_loop(model, params, batch, n_workers: int):
    """``per_worker_grads`` as one ``torch.autograd.grad`` per worker: the
    plain version the batched pass is held against."""
    pg = _with_grad(params)
    flat = tree.leaves(pg)
    stacked = [torch.empty((n_workers,) + tuple(p.shape), dtype=p.dtype, device=p.device)
               for p in flat]
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    auxs = []
    for i in range(n_workers):
        loss, aux = model.loss(pg, {k: v[i] for k, v in batch.items()})
        for out, g in zip(stacked, torch.autograd.grad(loss, flat)):
            out[i].copy_(g)
        loss_sum += loss.detach()
        auxs.append({k: v.detach() for k, v in aux.items()})
    return (loss_sum / n_workers, {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]},
            tree.unflatten(params, stacked))


def dense_grads(model, params, batch):
    """(loss, aux, grads) of the loss over the folded global batch."""
    folded = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in batch.items()}
    pg = _with_grad(params)
    loss, aux = model.loss(pg, folded)
    grads = torch.autograd.grad(loss, tree.leaves(pg))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree.unflatten(params, list(grads)))


# the field each stochastically rounding codec draws its dither for
_DITHERED = {"bf16": "q", "fp8_ec": "c"}


def _row_dither(codec, path: str, t: int, rows: int, row: int, storage, device):
    """Row ``row`` of the dither the stacked reduce draws for ``(path, t)``
    over all ``rows`` residue rows, or None for a codec that rounds to
    nearest. Each rank draws the whole (rows, ...) stack and keeps its row:
    the draw is not row-addressable, and a rank that drew its own shape
    would not give the stacked step's codes."""
    field = _DITHERED.get(codec.name)
    if field is None:
        return None
    shape = codec.init(rows, storage, "meta")[field].shape
    return state_codecs.codec_dither(codec_key(path, t), shape, device)[row:row + 1]


@dataclasses.dataclass(frozen=True)
class _GroupCtx:
    """What every tensor of one group reduce shares."""

    codec: Any
    beta: float
    t: int
    backend: Any
    across: Any  # the process group the compressor's reduce runs over
    hierarchy: Any
    row: int  # this rank's residue row among the stacked step's
    fused: bool
    want_ef: bool  # the worker-mean EF, for contraction gamma (stats or taps)
    ef_kind: str  # the ``sent`` key its all-reduce counts under
    metrics_every: int


def _with_first(first: list, steps):
    """Run the round generator ``steps`` with the collectives ``first`` added
    to its first round; returns (what ``steps`` returns, their results)."""
    try:
        req = next(steps)
    except StopIteration as stop:
        return stop.value, (yield first)
    got = yield list(first) + list(req)
    head, got = got[:len(first)], got[len(first):]
    while True:
        try:
            req = steps.send(got)
        except StopIteration as stop:
            return stop.value, head
        got = yield req


def _leader_launches(comp, use_fused: bool) -> float:
    """Kernel launches of one compressed tensor's group reduce on the leader
    rank (the ``fused_launches`` tap): the select, Eq. 5 and the scatter; the
    select and Eq. 5 in one where fused; no select for random_k; none on the
    exact path."""
    if comp.exact:
        return 0.0
    if use_fused and select_update_fits(comp.chunk, comp.topm):
        return 2.0
    return 2.0 if comp.name == "random_k" else 3.0


def _leaf_taps(plan, ctx: _GroupCtx, ef, ef_mean, vals, idx, ghat, m_new, new_enc,
               use_fused: bool):
    """One tensor's taps over the group, under ``core.scalecom._tap_execute``'s
    keys, the same values on every rank (a generator of one round). Shapes
    and the plan give the byte and build-up taps; two all-reduced squared
    norms the codec's roundtrip error; on sampled steps the rank holding
    worker 0's EF (rank 0 of the group) computes the Hamming, energy and
    Spearman taps against the worker mean and broadcasts them, and one
    all-reduce of every rank's unit EF u_i gives the pairwise cosine
    distance, 1 - (|sum u_i|^2 - sum |u_i|^2) / (n (n - 1)). Their bytes
    count under ``sent["telemetry"]``."""
    comp, dev, n = plan.comp, ghat.device, ctx.across.size()
    taps.tap("fused", _const(1.0 if use_fused else 0.0, dev), path=plan.path,
             compressor=comp.name)
    taps.tap("fused_launches", _const(_leader_launches(comp, use_fused), dev), path=plan.path)
    if comp.name == "local_topk":
        index_bytes = 4.0 * idx.numel()
    elif comp.name == "random_k":
        index_bytes = 0.0
    else:
        index_bytes = 4.0 * idx.numel() / n
    labels = dict(path=plan.path, compressor=comp.name)
    taps.tap("bytes_measured", _const(4.0 * vals.numel() + index_bytes, dev), **labels)
    taps.tap("bytes_planned", _const(plan.bytes_payload, dev), **labels)
    taps.tap("buildup_nnz", torch.count_nonzero(ghat).to(torch.float32), path=plan.path)
    taps.tap("buildup_k", _const(plan.k, dev), path=plan.path)
    m_row = m_new.reshape((1,) + plan.storage)
    decoded = ctx.codec.decode(new_enc, plan.storage)
    norms = torch.stack([torch.sum((decoded - m_row) ** 2), torch.sum(m_row ** 2)])
    calls = [Collective("all_reduce", norms, ctx.across, "telemetry")]
    similarity = ctx.metrics_every > 0 and n >= 2
    sampled = similarity and ctx.t % ctx.metrics_every == 0
    if sampled:
        x, y = ef.reshape(-1), ef_mean.reshape(-1)
        u = x / torch.clamp_min(torch.linalg.norm(x), 1e-30)
        calls.append(Collective("all_reduce", torch.cat([u, torch.sum(u * u)[None]]),
                                ctx.across, "telemetry"))
        k = max(1, min(plan.k, x.numel()))
        mine = (torch.stack([hamming_distance_topk(x, y, k), topk_overlap(x, y, k),
                             spearman_rho(x, y)]) if dist.get_rank(ctx.across) == 0 else
                torch.empty(3, dtype=torch.float32, device=dev))
        calls.append(Collective("broadcast", mine, ctx.across, "telemetry", src=0))
    got = yield calls
    taps.tap("codec_roundtrip_err",
             torch.sqrt(got[0][0]) / torch.clamp_min(torch.sqrt(got[0][1]), 1e-30),
             path=plan.path, codec=ctx.codec.name)
    if similarity:
        if sampled:
            s = got[1][:-1]
            report = [1.0 - (torch.sum(s * s) - got[1][-1]) / (n * (n - 1))] + list(got[2])
        else:
            report = [_const(0.0, dev) for _ in _SIMILARITY_KEYS]
        taps.tap("similarity_sampled", _const(1.0 if sampled else 0.0, dev), path=plan.path)
        for name, value in zip(_SIMILARITY_KEYS, report):
            taps.tap(name, value, path=plan.path)


def _leaf_steps(plan, g: torch.Tensor, enc, ctx: _GroupCtx):
    """One tensor of the group reduce as a round generator (``ring.Flight``):
    with ``hierarchy`` the mean over the rank's own group first
    (``ring.group_fold``); a dense
    tensor's all-reduce, or the compressor's reduce (``ring.ring_steps``)
    with the worker-mean EF's all-reduce beside its first round when stats
    or taps want it; m' coded with the rank's row of the stacked draw; the
    taps. Returns (ghat leaf, new encoding or None, (sq_err, sq_all) or
    None)."""
    n = ctx.across.size()
    gw = g[0].to(torch.float32)
    if ctx.hierarchy is not None:
        gw = yield from group_fold(gw, ctx.hierarchy)
    if plan.dense:
        (total,) = yield [Collective("all_reduce", gw, ctx.across, "dense")]
        return (total / n).reshape(plan.shape).to(g.dtype), None, None
    comp = plan.comp
    m = ctx.codec.decode(enc, plan.storage).reshape(plan.work)
    work = gw.reshape(plan.work)
    use_fused = ctx.fused and not comp.exact and comp.name in FUSABLE_MODES
    steps = ring_steps(work, m, ctx.t, comp, ctx.beta, ctx.across, ctx.backend, use_fused)
    ef = ef_mean = None
    if ctx.want_ef:
        ef = m + work
        out, (total,) = yield from _with_first(
            [Collective("all_reduce", ef, ctx.across, ctx.ef_kind, pack=False)], steps)
        ef_mean = (total / n).reshape(plan.shape)
    else:
        out = yield from steps
    ghat, m_new, vals, idx = out
    new_enc = ctx.codec.encode(
        m_new.reshape((1,) + plan.storage), plan.storage,
        key=_row_dither(ctx.codec, plan.path, ctx.t, plan.groups, ctx.row, plan.storage,
                        g.device))
    ghat = ghat.reshape(plan.shape)
    sums = None
    if ctx.want_ef:
        sums = (torch.sum((ef_mean - ghat) ** 2), torch.sum(ef_mean**2))
        taps.tap("contraction_gamma", sums[0] / torch.clamp_min(sums[1], 1e-30), path=plan.path)
    if taps.active():
        yield from _leaf_taps(plan, ctx, ef, ef_mean, vals, idx, ghat, m_new, new_enc, use_fused)
    return ghat.to(g.dtype), new_enc, sums


def _group_reduce(grads, sc_state: ScaleComState, sc_cfg: ScaleComConfig, group, hierarchy,
                  compute_stats: bool, buckets: Any = False):
    """Algorithm 1 over this rank's (1, *shape) gradients with real
    collectives: the plan (``core.plan.plan_tensors`` at n = group.size()
    workers, G = ``sc_cfg.groups`` or n) sends a compressed tensor through
    the compressor's reduce (``ring.ring_steps``) and a dense one through an
    all-reduce, over the whole group, or with ``hierarchy`` over its inter
    group after a mean over the rank's own group. The rank's residue row is
    decoded, and m' encoded with the rank's row of the stacked draw.

    ``buckets`` (``core.overlap.resolve_buckets``; None/"auto" reads
    $SCALECOM_TORCH_BUCKET_MB): unbucketed, the tensors run one after
    another in leaf order, each collective a blocking call of its own.
    Bucketed, each bucket of the plan's schedule (``core.plan.
    plan_buckets``) is one ``ring.Flight``: its payload goes out packed,
    one call per round and kind (offsets, values, dense tensors), every
    call async and waited for only where a later launch reads it, and the
    buckets advance round by round in schedule order (``overlap.
    run_buckets``: on the side stream with ``overlap``), so one bucket's
    collectives are in flight while another's kernels run. Offsets and m'
    are the unbucketed step's bits; ĝ sums its packed values in another
    order.

    Returns (ghat, new_state, stats): stats holds the plan's
    ``comm_bytes_per_worker`` and ``comm_bytes_dense`` as the stacked
    reduce's do, with ``compute_stats`` ``contraction_gamma`` from the
    worker-mean EF (one all-reduce of ef per tensor, ``sent["stats"]``),
    and with ``sc_cfg.telemetry`` the taps as ``"obs/<key>"`` entries, as
    ``scalecom_reduce`` returns them."""
    with taps.collect() if sc_cfg.telemetry else contextlib.nullcontext() as collected:
        ghat, new_state, stats = _group_reduce_body(grads, sc_state, sc_cfg, group, hierarchy,
                                                    compute_stats, buckets, collected)
    for key in sorted(collected or ()):
        stats[f"obs/{key}"] = collected[key]
    return ghat, new_state, stats


def _group_reduce_body(grads, sc_state, sc_cfg, group, hierarchy, compute_stats, buckets,
                       collected):
    n = group.size()
    codec = require_codec(sc_cfg.residue_dtype)
    flat = tree.flatten_with_path(grads)
    # bare residue paths: the rows are this rank's, checked below
    plans = plan_tensors(tuple((p, tuple(g.shape[1:]), n) for p, g in flat), sc_cfg,
                         frozenset(sc_state.residues))
    for plan in plans:
        if plan.dense:
            continue
        want = codec_signature(sc_cfg.residue_dtype, 1, plan.storage)
        (_, got), = residue_signature({plan.path: sc_state.residues[plan.path]})
        if got != want:
            raise ValueError(f"residue {plan.path!r} holds {got}, want this rank's row {want} "
                             f"(shard_train_state)")
    device = flat[0][1].device
    ctx = _GroupCtx(
        codec=codec, beta=sc_cfg.beta, t=sc_state.t,
        backend=resolve_backend(sc_cfg.backend, device),
        across=group if hierarchy is None else hierarchy.inter, hierarchy=hierarchy,
        row=dist.get_rank(group) if hierarchy is None else hierarchy.index,
        fused=resolve_fused(sc_cfg.fused), want_ef=compute_stats or sc_cfg.telemetry,
        ef_kind="stats" if compute_stats else "telemetry", metrics_every=sc_cfg.metrics_every)
    steps = [_leaf_steps(plan, g, sc_state.residues.get(path), ctx)
             for plan, (path, g) in zip(plans, flat)]
    schedule = overlap.resolve_buckets(buckets, sc_cfg, plans)
    results: list = [None] * len(flat)
    if schedule is None:
        for i, one in enumerate(steps):
            results[i] = drive(one)
    else:
        for b in schedule:
            if taps.active():
                taps.tap("bucket_staged_leaves", _const(len(b.leaf_ids), device),
                         bucket=b.index, overlap=sc_cfg.overlap)
                taps.tap("bucket_bytes_dense", _const(b.bytes_dense, device), bucket=b.index)
                taps.tap("bucket_bytes_payload", _const(b.bytes_payload, device),
                         bucket=b.index)
        flights = {b.index: Flight([steps[i] for i in b.leaf_ids], async_op=True)
                   for b in schedule}
        live, caller = schedule, None
        while live:
            busy = set()

            def advance(b):
                if flights[b.index].advance():
                    busy.add(b.index)

            caller = overlap.run_buckets(live, advance, device, sc_cfg.overlap) or caller
            live = tuple(b for b in live if b.index in busy)
        for b in schedule:
            for i, out in zip(b.leaf_ids, flights[b.index].out):
                results[i] = out
        if caller is not None:
            overlap.hand_over([results, collected], caller)
    new_residues = dict(sc_state.residues)
    ghat_leaves = []
    sq_err = sq_all = 0.0
    for plan, (ghat, new_enc, sums) in zip(plans, results):
        ghat_leaves.append(ghat)
        if new_enc is not None:
            new_residues[plan.path] = new_enc
        if sums is not None:
            sq_err = sq_err + sums[0]
            sq_all = sq_all + sums[1]
    stats = {"comm_bytes_per_worker": sum(p.bytes_payload for p in plans),
             "comm_bytes_dense": sum(p.bytes_dense for p in plans)}
    if compute_stats:
        stats["contraction_gamma"] = sq_err / torch.clamp_min(torch.as_tensor(sq_all), 1e-30)
    return (tree.unflatten(grads, ghat_leaves),
            ScaleComState(residues=new_residues, t=sc_state.t + 1), stats)


def _group_mean(loss: torch.Tensor, auxs: Dict, group) -> Tuple[torch.Tensor, Dict]:
    """The loss and each aux averaged over the group's ranks, in one
    all-reduce (a metric, not gradient payload: not counted)."""
    keys = list(auxs)
    both = torch.stack([loss.reshape(())] + [torch.mean(auxs[k]) for k in keys])
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
    both = both / group.size()
    return both[0], {k: both[i + 1] for i, k in enumerate(keys)}


def build_train_step(
    model,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    sc_cfg: ScaleComConfig,
    *,
    n_workers: int,
    mode: str = "scalecom",  # scalecom | dense
    microbatches: int = 1,
    grad_clip: Optional[float] = None,
    compute_stats: bool = False,
    buckets: Any = None,
    group=None,
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, Any]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``buckets`` is the launch granularity of the ScaleCom reduce
    (``scalecom_reduce(buckets=...)``): None/"auto" reads
    $SCALECOM_TORCH_BUCKET_MB at each step; an explicit value wins.

    ``microbatches=M`` splits each worker's batch into M chunks with fp32
    gradient accumulation (``per_worker_grads``): activation memory scales
    with about 1/M, the accumulators add one fp32 copy of the per-worker
    gradients, and the reduce still runs once per step. The dense step
    takes the whole folded batch at once, as in the reference.

    The step updates ``state.params`` and ``state.opt_state`` in place (see
    ``repro_torch.optim``) and returns a new ``TrainState`` holding them.
    Metric values are 0-d tensors (or floats) left on the device: reading
    one waits for the step to finish.

    ``group``: a ``torch.distributed`` process group whose ranks are the
    ``n_workers`` workers, one each (``n_workers`` must equal
    ``group.size()``). Each rank passes the same global batch and the state
    ``shard_train_state`` gave it, trains on its row and gets ĝ through the
    collectives of ``repro_torch.distributed.ring``; the loss and aux
    metrics are averaged over the ranks, so they equal the stacked step's.
    With ``sc_cfg.groups=G`` the group is the world of the hierarchy: this
    call builds (or takes from the cache) the rank's two process groups
    (``ring.make_hierarchy``, collective: every rank builds its steps in
    the same order), and the world must divide into G groups. The group
    step runs every configuration the stacked one does: each compressor,
    codec and exact path, ``groups``, ``compute_stats``, the fused reduce
    (the leader's select and Eq. 5 in one ``fused_select_update`` launch;
    the worker mean is the all-reduce's), ``telemetry`` (the same
    ``"obs/<key>"`` taps, the same on every rank) and ``buckets`` (packed,
    async collectives, bucket by bucket; see ``_group_reduce``). The dense
    mode stays one all-reduce over the whole group.
    """
    if mode not in ("scalecom", "dense"):
        raise ValueError(f"mode must be 'scalecom' or 'dense', got {mode!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if group is not None:
        if n_workers != group.size():
            raise ValueError(
                f"a train step over a process group runs one worker per rank: n_workers "
                f"({n_workers}) must equal group.size() ({group.size()})")
        rank = dist.get_rank(group)
        hierarchy = None if sc_cfg.groups is None else make_hierarchy(group, sc_cfg.groups)
    # fp32 GEMMs without TF32, bf16 and fp16 ones accumulating in fp32, as
    # the JAX package's matmuls do whatever the model's compute dtype
    fp32_accumulation()

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        device = tree.leaves(state.params)[0].device
        batch = _batch_on(batch, device)
        if group is not None:
            _check_lead(batch, n_workers)
            batch = {k: v[rank:rank + 1] for k, v in batch.items()}
        if mode == "scalecom" and group is not None:
            loss, auxs, gpw = per_worker_grads(model, state.params, batch, 1, microbatches)
            ghat, sc_state, stats = _group_reduce(gpw, state.sc_state, sc_cfg, group, hierarchy,
                                                  compute_stats, buckets)
            del gpw
        elif mode == "scalecom":
            loss, auxs, gpw = per_worker_grads(model, state.params, batch, n_workers,
                                               microbatches)
            ghat, sc_state, stats = scalecom_reduce(
                gpw, state.sc_state, sc_cfg, compute_stats=compute_stats, buckets=buckets
            )
            del gpw
        else:
            loss, auxs, ghat = dense_grads(model, state.params, batch)
            if group is not None:
                ghat = tree.tree_map(lambda g: all_reduce_mean(g, group), ghat)
            sc_state = ScaleComState(residues=state.sc_state.residues, t=state.sc_state.t + 1)
            stats = {}
        if group is not None:
            loss, auxs = _group_mean(loss, auxs, group)

        gnorm = global_norm(ghat)
        if grad_clip is not None:
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            ghat = tree.tree_map(lambda g: g * scale, ghat)

        lr = schedule(state.step)
        params, opt_state = optimizer.update(ghat, state.opt_state, state.params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   **{k: torch.mean(v) for k, v in auxs.items()}, **stats}
        return TrainState(params, opt_state, sc_state, state.step + 1), metrics

    return train_step


def init_train_state(model, optimizer: Optimizer, sc_cfg: ScaleComConfig,
                     generator: torch.Generator, *, n_workers: int,
                     device="cuda") -> TrainState:
    """Random parameters from ``generator`` on ``device``, optimizer state and
    zero ScaleCom residues."""
    params = model.init(generator, device)
    sc_state = init_state(
        params, sc_cfg.n_workers(n_workers), sc_cfg.residue_dtype, sc_cfg.min_size,
        sc_cfg.layout,
    )
    return TrainState(params, optimizer.init(params), sc_state, 0)


def shard_train_state(state: TrainState, rank: int, world: int,
                      groups: Optional[int] = None) -> TrainState:
    """Rank ``rank``'s share of a worker-stacked TrainState over ``world``
    ranks: its own row of every field of every residue encoding (with
    ``groups=G``, the row of its group, ``rank // (world // G)``, of G
    rows), and copies of the replicated params and optimizer state (so a
    step on the share leaves ``state`` as it was). The step counter and
    ScaleCom ``t`` carry over."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in [0, {world})")
    if groups is not None and (groups < 1 or world % groups):
        raise ValueError(f"{world} workers not divisible into {groups} groups: a world of "
                         f"{world} ranks needs world % groups == 0 (G={groups})")
    rows = world if groups is None else groups
    row = rank if groups is None else rank // (world // groups)
    residues = {}
    for path, enc in state.sc_state.residues.items():
        if any(v.shape[0] != rows for v in enc.values()):
            raise ValueError(
                f"residue {path!r} must hold rows of {rows} workers in every field, got "
                f"{ {k: tuple(v.shape) for k, v in enc.items()} }")
        residues[path] = {k: v[row:row + 1].clone() for k, v in enc.items()}
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
    return TrainState(tree.tree_map(copy, state.params), tree.tree_map(copy, state.opt_state),
                      ScaleComState(residues=residues, t=state.sc_state.t), state.step)
