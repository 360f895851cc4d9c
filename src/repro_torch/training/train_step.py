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

With ``mesh`` (a grid of process groups) the step is the sharded one,
under the reference's ``tp`` policy or its ``fsdp`` one (``policy=``):
see ``build_train_step``.

Batches arrive worker-stacked, as numpy arrays or tensors
({"tokens": (n, B, S), ...}), and are moved to the parameters' device here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.backends import FUSABLE_MODES, resolve_backend, resolve_fused
from repro_torch.core import overlap
from repro_torch.core import state as state_codecs
from repro_torch.core.metrics import hamming_distance_topk, spearman_rho, topk_overlap
from repro_torch.core import compressors
from repro_torch.core.filter import lowpass_update
from repro_torch.core.plan import _even, first_holder, plan_shards, plan_tensors
from repro_torch.core.scalecom import _SIMILARITY_KEYS, ScaleComConfig, _const, scalecom_reduce
from repro_torch.core.state import (
    ScaleComState, codec_key, codec_signature, init_state, require_codec, resolve_layout,
    residue_signature,
)
from repro_torch.device import fp32_accumulation
from repro_torch.distributed import fsdp, slices, tensor_parallel
from repro_torch.distributed.ring import (
    Collective, Flight, all_reduce_mean, drive, group_fold, make_hierarchy, ring_rounds,
    ring_steps,
)
from repro_torch.distributed.sharding import shard_of, specs_for_axes, split_axes
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


def per_worker_grads(model, params, batch, n_workers: int, microbatches: int = 1, tp=None,
                     data_group=None):
    """(mean worker loss, {aux: (n,) per-worker values}, {path: (n, *shape)
    gradients}); the aux dict is the model's (``nll``, and the MoE losses).
    ``tp`` goes to ``model.loss`` (the tensor-parallel pass), and so does
    ``data_group`` (the ``fsdp`` step's: each worker's batch split over a
    pod's data ranks, which MoE layers route as one batch).

    One vmapped pass over the workers per microbatch. With ``microbatches``
    M > 1, microbatch j is rows j*B/M .. (j+1)*B/M - 1 of every worker's
    batch; the gradients are summed in fp32 and divided by M, the loss is
    the mean of the M passes' loss sums over n, and each aux the mean of its
    M per-worker values.
    """
    shapes = _check_lead(batch, n_workers)
    # (params, one worker's batch) -> (grads, (loss, aux)), mapped over the workers
    kw = {k: v for k, v in (("tp", tp), ("data_group", data_group)) if v is not None}
    loss_fn = functools.partial(model.loss, **kw) if kw else model.loss
    batched = torch.func.vmap(torch.func.grad_and_value(loss_fn, has_aux=True),
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


def dense_grads(model, params, batch, tp=None, data_group=None):
    """(loss, aux, grads) of the loss over the folded global batch; ``tp``
    goes to ``model.loss``. With ``data_group`` the batch is this rank's
    row of the global one, each rank of the group holding one, and the pass
    routes MoE tokens over the global batch (``Model.loss(data_group=)``):
    the ranks' mean is the global pass's."""
    folded = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in batch.items()}
    pg = _with_grad(params)
    kw = {k: v for k, v in (("tp", tp), ("data_group", data_group)) if v is not None}
    loss, aux = model.loss(pg, folded, **kw)
    grads = torch.autograd.grad(loss, tree.leaves(pg))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree.unflatten(params, list(grads)))


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


def _payload_bytes(comp, n_vals: int, n_idx: int, n: int) -> float:
    """The per-worker wire bytes of a payload of ``n_vals`` values and
    ``n_idx`` offsets over n workers, as the stacked reduce's
    ``bytes_measured`` tap counts them: each worker's values, and its
    own offsets (local_topk), none (random_k) or its 1/n of the leader's."""
    if comp.name == "local_topk":
        index_bytes = 4.0 * n_idx
    elif comp.name == "random_k":
        index_bytes = 0.0
    else:
        index_bytes = 4.0 * n_idx / n
    return 4.0 * n_vals + index_bytes


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
    labels = dict(path=plan.path, compressor=comp.name)
    taps.tap("bytes_measured", _const(_payload_bytes(comp, vals.numel(), idx.numel(), n), dev),
             **labels)
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
        key=state_codecs.row_dither(ctx.codec.name, codec_key(plan.path, ctx.t), plan.groups,
                                    ctx.row, plan.storage, g.device))
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


def _run_steps(steps: list, schedule, device, sc_cfg: ScaleComConfig, collected) -> list:
    """Each tensor's round generator run to its end; their results in leaf
    order. Unbucketed (``schedule`` None): one after another in leaf order,
    each collective a blocking call (``ring.drive``). Bucketed: the bucket
    taps, then each bucket one async ``ring.Flight``, the buckets advanced
    round by round in schedule order (``overlap.run_buckets``: on the side
    stream with ``sc_cfg.overlap``, whose results, and the taps in
    ``collected``, are handed over to the caller's stream)."""
    results: list = [None] * len(steps)
    if schedule is None:
        for i, one in enumerate(steps):
            results[i] = drive(one)
        return results
    for b in schedule:
        if taps.active():
            taps.tap("bucket_staged_leaves", _const(len(b.leaf_ids), device),
                     bucket=b.index, overlap=sc_cfg.overlap)
            taps.tap("bucket_bytes_dense", _const(b.bytes_dense, device), bucket=b.index)
            taps.tap("bucket_bytes_payload", _const(b.bytes_payload, device), bucket=b.index)
    flights = {b.index: Flight([steps[i] for i in b.leaf_ids], async_op=True) for b in schedule}
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
    return results


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
    results = _run_steps(steps, overlap.resolve_buckets(buckets, sc_cfg, plans), device, sc_cfg,
                         collected)
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


# -- the tensor-parallel step ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _TPLayout:
    """The model's leaves on this rank of a grid under a ``policy``:
    logical shapes and specs in leaf order, the dim each leaf splits over
    the model axis (None: not split there), and the model axis that the
    pass takes (``Model.loss(..., tp=axis)``).

    ``tp``: a (data, model) grid; a worker is the ranks of one data index,
    and a leaf is cut over "model" at most. ``fsdp``: a (pod, data, model)
    grid; a worker is a pod, its batch split over "data", and a leaf is cut
    over "model" and its "embed" dim over "data" (``pieces``: the pod's
    (data, model) plane holds every block)."""

    mesh: Any
    policy: str
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    specs: Tuple[Tuple, ...]
    dims: Tuple[Optional[int], ...]
    axis: tensor_parallel.ModelAxis

    @property
    def data(self):
        return self.mesh.group("data")

    @property
    def worker_axis(self) -> str:
        return "pod" if self.policy == "fsdp" else "data"

    @property
    def workers(self):
        """The group the compressor's reduce runs over: one rank a worker."""
        return self.mesh.group(self.worker_axis)

    @property
    def row(self) -> int:
        """This rank's worker: its residue row among the stacked step's."""
        return self.mesh.index(self.worker_axis)

    @property
    def batch_group(self):
        """The ranks that split the global batch, one share each, in its
        order: the data group (``tp``), the (pod, data) plane (``fsdp``)."""
        return self.mesh.group(("pod", "data")) if self.policy == "fsdp" else self.data

    @property
    def split_axes(self) -> Tuple[str, ...]:
        return ("data", "model") if self.policy == "fsdp" else ("model",)

    @functools.cached_property
    def pieces(self) -> slices.Pieces:
        """The groups a worker's blocks lie over."""
        return slices.grid_pieces(self.mesh, self.split_axes)

    @property
    def parts(self) -> int:
        return math.prod(size for _, size in self.pieces.axes)

    @property
    def piece_index(self) -> int:
        """This rank's index in ``pieces.group``."""
        i = 0
        for a, size in self.pieces.axes:
            i = i * size + self.mesh.index(a)
        return i

    def slice(self, i: int) -> slices.Slice:
        """Leaf ``i``'s block on this rank."""
        return slices.block_of(self.shapes[i], self.specs[i], self.mesh, self.split_axes)


def _tp_layout(abstract, axes, mesh, policy: str = "tp") -> _TPLayout:
    """The layout of a parameter tree (tensors or ``meta`` shapes, logical)
    with its logical ``axes`` on this rank of ``mesh``, under ``policy``'s
    specs (``tp`` or ``fsdp``)."""
    spec_tree = specs_for_axes(abstract, axes, policy, mesh)
    specs = tree.leaves(spec_tree)
    flat = tree.flatten_with_path(abstract)
    split = mesh.shape["model"] > 1
    dims = tuple(_split_dim(s) if split else None for s in specs)
    axis = tensor_parallel.ModelAxis(mesh.group("model"), mesh.index("model"),
                                     mesh.shape["model"],
                                     split_axes(spec_tree, axes) if split else frozenset())
    return _TPLayout(mesh, policy, tuple(p for p, _ in flat),
                     tuple(tuple(x.shape) for _, x in flat), tuple(specs), dims, axis)


def _split_dim(spec) -> Optional[int]:
    return next((d for d, ax in enumerate(spec) if ax == "model"), None)


_GRIDS = {"tp": ("data", "model"), "fsdp": ("pod", "data", "model")}


def _tp_check(model, mesh, n_workers: int, group, policy: str, sc_cfg=None) -> None:
    """Raises, naming it, for what the sharded step does not run."""
    if group is not None:
        raise ValueError("pass the grid as mesh= (its worker axis is the workers' group), "
                         "not group= as well")
    if policy not in _GRIDS:
        raise ValueError(f"policy must be 'tp' or 'fsdp' (the reference's sharded train "
                         f"policies), got {policy!r}")
    grid = _GRIDS[policy]
    if tuple(mesh.axis_names) != grid or mesh.groups is None:
        if policy == "tp" and tuple(mesh.axis_names) == _GRIDS["fsdp"]:
            raise ValueError(f"a (pod, data, model) grid {mesh.shape} runs policy='fsdp' (pods "
                             f"the workers); the tp step takes a (data, model) grid")
        if policy == "fsdp" and tuple(mesh.axis_names) == _GRIDS["tp"]:
            raise ValueError(f"fsdp with its workers on 'data' ({mesh.shape}) is dense-only in "
                             f"the reference (its train_step: fsdp-sharded params with per-rank "
                             f"workers take mode='dense'); the fsdp step takes a (pod, data, "
                             f"model) grid whose pods are the workers")
        raise ValueError(f"the {policy} step takes a {grid} grid of process groups "
                         f"(launch.mesh.make_test_mesh), got {mesh.shape}")
    axis = _GRIDS[policy][0]
    if n_workers != mesh.shape[axis]:
        raise ValueError(f"n_workers ({n_workers}) must equal the grid's {axis} size "
                         f"({mesh.shape[axis]}): the ranks of one {axis} index are one worker")
    if policy == "fsdp" and sc_cfg is not None:
        for what, on in (("groups", sc_cfg.groups is not None),
                         ("telemetry", sc_cfg.telemetry)):
            if on:
                raise ValueError(f"{what} under the fsdp step is ROADMAP Queue 1 sharded-step "
                                 f"item 3b, not ported yet")


@dataclasses.dataclass(frozen=True)
class _TPCtx:
    """What every tensor of one tensor-parallel reduce shares."""

    codec: str
    layout: str  # the residues' chunk layout, resolved
    beta: float
    t: int
    backend: Any
    fused: bool
    across: Any  # the workers' group, or with groups its inter group: the compressor's reduce
    hierarchy: Any
    row: int  # this rank's residue row among the stacked step's
    pieces: Any  # slices.Pieces: the groups a worker's blocks lie over
    index: int  # this rank's index in pieces.group
    want_ef: bool  # the worker-mean EF, for contraction gamma (stats or taps)
    ef_kind: str  # the ``sent`` key its all-reduce counts under
    metrics_every: int

    @property
    def model(self):
        """The group of every rank of a worker's blocks (``tp``: the model
        group), over which a tensor's blocks and parts are gathered."""
        return self.pieces.group

    @property
    def parts(self) -> int:
        return math.prod(size for _, size in self.pieces.axes)


def _call(c: Collective):
    """One collective as a round generator: its result."""
    (got,) = yield [c]
    return got


def _one_round(steps):
    """Generators of at most one round each, run side by side as exactly one
    round (an empty one where none of them yields): their results."""
    out: list = [None] * len(steps)
    live, calls = [], []
    for i, one in enumerate(steps):
        try:
            req = list(next(one))
        except StopIteration as stop:
            out[i] = stop.value
            continue
        live.append((i, one, len(req)))
        calls += req
    got = yield calls
    at = 0
    for i, one, size in live:
        try:
            one.send(got[at:at + size])
        except StopIteration as stop:
            out[i] = stop.value
        else:
            raise RuntimeError("a step of more than one round in _one_round")
        at += size
    return out


def _idle(rounds: int):
    """``rounds`` rounds without a collective: a rank with no part of a
    tensor keeps its rounds in step with the ranks that have one."""
    for _ in range(rounds):
        yield []


def _model_gather(x: torch.Tensor, dim: int, group):
    """Every model rank's ``x`` concatenated along ``dim`` in rank order (a
    round: one all-gather, the model axis's count)."""
    rows = yield from _call(Collective("all_gather", x.contiguous(), group, "model"))
    return rows.movedim(0, dim).flatten(dim, dim + 1)


def _assemble(x: torch.Tensor, sl: slices.Slice, pieces):
    """The logical tensor from every rank's block ``x`` (``sl`` this
    rank's): a round of one all-gather over ``pieces.group`` (the model
    axis's count), none for a tensor that is not cut. One cut over the
    whole group is a concatenation; else each block is written at its
    logical place (blocks held by several ranks alike)."""
    if not sl.cuts:
        return x.reshape(sl.shape)
    if len(sl.cuts) == 1 and len(pieces.axes) == 1:
        return (yield from _model_gather(x.reshape(sl.local_shape), sl.dim, pieces.group))
    rows = yield from _call(Collective("all_gather", x.reshape(-1).contiguous(), pieces.group,
                                       "model"))
    out = torch.empty(sl.shape, dtype=x.dtype, device=x.device)
    for j in range(rows.shape[0]):
        b = sl.at(pieces.coords(j))
        b.cut(out).copy_(rows[j].view(b.local_shape))
    return out


def _gather_parts(part: torch.Tensor, sizes, group):
    """The flat concatenation of every model rank's ``part`` (``sizes[i]``
    elements on rank i): padded to the longest, one all-gather (a round)."""
    width = max(sizes)
    flat = part.reshape(-1)
    if flat.numel() < width:
        flat = torch.cat([flat, flat.new_zeros(width - flat.numel())])
    rows = yield from _call(Collective("all_gather", flat, group, "model"))
    return torch.cat([rows[i, :n] for i, n in enumerate(sizes)])


def _gather_cols(part: torch.Tensor, sizes, group):
    """``_gather_parts`` of (n, sizes[i]) columns: the (n, sum(sizes))
    concatenation along the last dim."""
    n = part.shape[0]
    flat = yield from _gather_parts(part.t().contiguous(), [s * n for s in sizes], group)
    return flat.reshape(-1, n).t()


def _stat_sums(ef: torch.Tensor, ghat: torch.Tensor, ctx: _TPCtx):
    """(||ef_mean - ĝ||², ||ef_mean||²) over this rank's elements, and
    ef_mean: the worker-mean EF all-reduced over the compressor's group
    (a round; ``sent[ctx.ef_kind]``, its own call in a bucket)."""
    total = yield from _call(Collective("all_reduce", ef, ctx.across, ctx.ef_kind, pack=False))
    ef_mean = total / ctx.across.size()
    return torch.stack([torch.sum((ef_mean - ghat) ** 2), torch.sum(ef_mean**2)]), ef_mean


def _tp_draw(sp, sl: slices.Slice, ctx: _TPCtx, device) -> torch.Tensor:
    """random_k's offsets at this rank's chunks: the draw over the logical
    tensor's work view (``compressors.random_offsets``), the rows of the
    rank's chunks ("local": its block's, "part": its range's)."""
    plan = sp.plan
    whole = compressors.random_offsets(ctx.t, plan.comp, plan.work, device)
    tail = tuple(whole.shape[len(plan.work):])  # (topm,) past top-1
    if sp.route == "part":  # its range of chunks (flat) or of rows (rowwise)
        lo, hi = sp.bounds[ctx.index]
        return whole.flatten(0, max(0, len(plan.work) - 2))[lo:hi]
    if len(plan.work) == 1:  # flat: the block's runs of whole chunks
        return whole[sl.unit_ids(plan.comp.chunk, device)].contiguous()
    last = len(plan.shape) - 1
    rows = sl.rows().cut(whole)  # rowwise: the block's rows
    if sl.cuts[-1][0] < last:  # whole rows
        return rows.contiguous()
    _, _, _, i = sl.cuts[-1]  # runs of whole chunks a row
    per = sp.local_shape[-1] // plan.comp.chunk
    return rows.narrow(last, i * per, per).contiguous()


def _tp_run(sp, sl, work: torch.Tensor, m: torch.Tensor, ctx: _TPCtx):
    """The compressor's reduce (``ring.ring_steps``) over the compressor's
    group on this rank's rows ``work`` of the logical work view, as a round
    generator: (ĝ, m', the stats' partial sums or None, the payload's
    per-worker bytes, ef_mean or None)."""
    comp = sp.plan.comp
    draw = _tp_draw(sp, sl, ctx, work.device) if comp.name == "random_k" else None
    ghat, m_new, vals, idx = yield from ring_steps(
        work, m, ctx.t, comp, ctx.beta, ctx.across, ctx.backend,
        ctx.fused and comp.name in FUSABLE_MODES, draw=draw)
    sums = ef_mean = None
    if ctx.want_ef:
        sums, ef_mean = yield from _stat_sums(m + work, ghat, ctx)
    return (ghat, m_new, sums, _payload_bytes(comp, vals.numel(), idx.numel(), ctx.across.size()),
            ef_mean)


def _tp_exact_steps(sp, sl, gw: torch.Tensor, m: torch.Tensor, ctx: _TPCtx):
    """The exact path (``comp.exact``) for this rank's slice, as a round
    generator: the logical EF gathered over the blocks' ranks (``ctx.
    pieces``: the model group under ``tp``), the dense top-k of ``exact_k``
    over it (``compressors._top_k``, ties to the lower logical offset, as
    ``ring._exact_steps`` and the stacked path take it), and the offsets
    and values over the compressor's group in this rank's range of the k
    (``sp.bounds``), the ranges gathered back over the blocks' ranks.
    clt_k: the leader's top-k; true_topk: the top-k of the oracle's mean
    (all-reduced part by part: the slice, or of a tensor that other ranks
    hold alike a range of it); random_k: the shared draw; local_topk: each
    rank's own, all_gathered. A rank with an empty range, or no leader's
    gather to join, yields an empty round in its place. Returns (ĝ slice,
    m' slice, the stats' partial sums or None, the k logical offsets this
    rank updated at, the payload's per-worker bytes, ef_mean or None)."""
    plan, comp = sp.plan, sp.plan.comp
    model, group = ctx.model, ctx.across
    n, me, size, k = group.size(), dist.get_rank(group), plan.size, plan.k
    lo, hi = sp.bounds[ctx.index]
    sizes = [b - a for a, b in sp.bounds]
    ef = m + gw
    dev = ef.device
    def mine(x):  # the logical tensor, flat -> this rank's slice
        return sl.cut(x.reshape(plan.shape))

    if not sp.unique:  # replicated, or held alike by other ranks: its own part is a range
        ranges = _even(size, ctx.parts)
        a, b = ranges[ctx.index]

        def own(x):  # the logical tensor -> its own elements
            return x.reshape(-1)[a:b]

        def whole(x_own):
            return _gather_parts(x_own, [hi_ - lo_ for lo_, hi_ in ranges], model)

        ef_whole = (yield from _assemble(ef, sl, ctx.pieces)).reshape(-1)
        own_ef = own(ef_whole)
    else:
        def own(x):
            return mine(x).reshape(-1)

        def whole(x_own):
            x = yield from _assemble(x_own, sl, ctx.pieces)
            return x.reshape(-1)

        ef_whole = yield from whole(ef)
        own_ef = ef.reshape(-1)

    if comp.name == "local_topk":
        idx = compressors._top_k(ef_whole.abs(), k)
        vals = ef_whole[idx.long()]
        if hi > lo:
            got_idx, got_vals = yield [Collective("all_gather", idx[lo:hi], group, "indices"),
                                       Collective("all_gather", vals[lo:hi], group, "values")]
        else:
            yield []
            got_idx = idx.new_zeros((n, 0))
            got_vals = vals.new_zeros((n, 0))
        cols_idx = yield from _gather_cols(got_idx, sizes, model)
        cols_vals = yield from _gather_cols(got_vals, sizes, model)
        dense = torch.zeros((n, size), dtype=ef.dtype, device=dev)
        ghat = torch.mean(dense.scatter(1, cols_idx.long(), cols_vals), dim=0)
    else:
        if comp.name == "random_k":
            idx = compressors._top_k(compressors.random_draw(ctx.t, (size,), dev), k)
        else:
            leader = int(ctx.t) % n
            key = ef_whole
            if comp.name == "true_topk":
                total = yield from _call(Collective("all_reduce", own_ef, group, "oracle",
                                                    pack=False))
                if me == leader:
                    key = yield from whole(total / n)
                else:
                    yield []
            part = (compressors._top_k(key.abs(), k)[lo:hi] if me == leader else
                    torch.empty(hi - lo, dtype=torch.int32, device=dev))
            if hi > lo:
                part = yield from _call(Collective("broadcast", part, group, "indices",
                                                   src=leader))
            else:
                yield []
            idx = yield from _gather_parts(part, sizes, model)
        vals = ef_whole[idx.long()]
        total = vals[lo:hi]
        if hi > lo:
            total = yield from _call(Collective("all_reduce", total, group, "values"))
        else:
            yield []
        ghat = torch.zeros(size, dtype=ef.dtype, device=dev)
        ghat[idx.long()] = yield from _gather_parts(total / n, sizes, model)
    own_dense = torch.zeros(size, dtype=ef.dtype, device=dev).scatter(0, idx.long(), vals)
    m_new = lowpass_update(m, gw, mine(own_dense), ctx.beta)
    sums = ef_mean = None
    if ctx.want_ef:
        sums, ef_mean = yield from _stat_sums(own_ef, own(ghat), ctx)
    return (mine(ghat), m_new, sums, idx, _payload_bytes(comp, hi - lo, hi - lo, n), ef_mean)


def _tp_taps(sp, sl, ctx: _TPCtx, ef, ef_mean, whole, lift, ghat, m_new, new_enc, sums,
             payload: float, use_fused: bool):
    """One tensor's taps on the grid, under ``core.scalecom._tap_execute``'s
    keys, as a generator of two rounds: each value the stacked step's for
    the logical tensor, the same on every rank. ``ef`` and ``m_new`` are
    this rank's slices (a replicated tensor's whole), ``ghat`` its slice of
    ĝ, ``ef_mean`` the worker-mean EF over the elements it reduced (its
    part; ``lift`` gathers the parts into the logical tensor, ``whole`` the
    slices), ``sums`` their contraction sums, ``payload`` its share of the
    per-worker bytes.

    Round 1 all-reduces over the blocks' ranks (the model group under
    ``tp``; the model axis's count) this rank's share of bytes_measured and
    of the contraction sums, and of its block the nonzeros of ĝ and the
    codec roundtrip's two squared norms (a block that other ranks hold
    alike counted on the first of them, ``ShardPlan.first``); on sampled
    steps it gathers the logical EF and worker mean.
    Round 2 all-reduces the squared norms over the compressor's group, and
    on sampled steps, as the group step does, the unit EFs for the
    pairwise cosine, and broadcasts the Hamming, energy and Spearman taps
    that the group's rank 0 computes from the logical tensors
    (``sent["telemetry"]``). ``fused_launches`` is the leader's launches
    (``_leader_launches``), where the stacked step taps its one fused
    launch: 2 on the fused_select_update route, not 1, and 2 for random_k,
    not 3."""
    plan, comp, dev = sp.plan, sp.plan.comp, ghat.device
    n = ctx.across.size()
    taps.tap("fused", _const(1.0 if use_fused else 0.0, dev), path=plan.path,
             compressor=comp.name)
    taps.tap("fused_launches", _const(_leader_launches(comp, use_fused), dev), path=plan.path)
    decoded = slices.decode(ctx.codec, new_enc, sl, ctx.layout)
    m_row = m_new.reshape(decoded.shape)
    counted = sp.first  # a block other ranks hold alike: counted once
    zero = _const(0.0, dev)
    mine = torch.stack([
        _const(payload, dev),
        torch.count_nonzero(ghat).to(torch.float32) if counted else zero,
        torch.sum((decoded - m_row) ** 2) if counted else zero,
        torch.sum(m_row**2) if counted else zero,
        *(sums if sums is not None else (zero, zero))])
    similarity = ctx.metrics_every > 0 and n >= 2
    sampled = similarity and ctx.t % ctx.metrics_every == 0
    first = [_call(Collective("all_reduce", mine, ctx.model, "model"))]
    if sampled:
        first += [whole(ef), lift(ef_mean)]
    got = yield from _one_round(first)
    total = got[0]
    labels = dict(path=plan.path, compressor=comp.name)
    taps.tap("bytes_measured", total[0], **labels)
    taps.tap("bytes_planned", _const(plan.bytes_payload, dev), **labels)
    taps.tap("buildup_nnz", total[1], path=plan.path)
    taps.tap("buildup_k", _const(plan.k, dev), path=plan.path)
    taps.tap("contraction_gamma", total[4] / torch.clamp_min(total[5], 1e-30), path=plan.path)
    calls = [Collective("all_reduce", total[2:4], ctx.across, "telemetry")]
    if sampled:
        x, y = got[1], got[2]
        u = x / torch.clamp_min(torch.linalg.norm(x), 1e-30)
        calls.append(Collective("all_reduce", torch.cat([u, torch.sum(u * u)[None]]),
                                ctx.across, "telemetry"))
        k = max(1, min(plan.k, x.numel()))
        ranked = (torch.stack([hamming_distance_topk(x, y, k), topk_overlap(x, y, k),
                               spearman_rho(x, y)]) if dist.get_rank(ctx.across) == 0 else
                  torch.empty(3, dtype=torch.float32, device=dev))
        calls.append(Collective("broadcast", ranked, ctx.across, "telemetry", src=0))
    got = yield calls
    taps.tap("codec_roundtrip_err",
             torch.sqrt(got[0][0]) / torch.clamp_min(torch.sqrt(got[0][1]), 1e-30),
             path=plan.path, codec=ctx.codec)
    if similarity:
        if sampled:
            s = got[1][:-1]
            report = [1.0 - (torch.sum(s * s) - got[1][-1]) / (n * (n - 1))] + list(got[2])
        else:
            report = [_const(0.0, dev) for _ in _SIMILARITY_KEYS]
        taps.tap("similarity_sampled", _const(1.0 if sampled else 0.0, dev), path=plan.path)
        for name, value in zip(_SIMILARITY_KEYS, report):
            taps.tap(name, value, path=plan.path)


def _tp_leaf_steps(sp, g: torch.Tensor, enc, ctx: _TPCtx, sl: slices.Slice):
    """One tensor of the tensor-parallel reduce on this rank (``ShardPlan``
    ``sp``) as a round generator (``ring.Flight``): every collective of the
    data axis and of the model axis, the codec's amax gather included, is a
    yielded ``Collective``. Every rank of the grid yields the same number
    of rounds for a tensor, and in each round the same collectives over
    each of its groups (a rank with no part of the tensor yields empty
    rounds in place of its reduce's), so the calls of a bucket's packed
    rounds match on every rank. With a hierarchy the gradient is averaged
    over the rank's group first (``ring.group_fold``, on the slice); the
    taps last (``_tp_taps``) when they are collected. Returns (ĝ of its
    slice, its new residue slice or None, the stats' partial sums or
    None)."""
    plan = sp.plan
    n = ctx.across.size()
    gw = g[0].to(torch.float32)
    if ctx.hierarchy is not None:
        gw = yield from group_fold(gw, ctx.hierarchy)
    if sp.route == "dense":
        total = yield from _call(Collective("all_reduce", gw, ctx.across, "dense"))
        return (total / n).to(g.dtype), None, None
    model, index = ctx.model, ctx.index

    def whole(x):  # this rank's slice -> the logical tensor, flat (a round where cut)
        x = yield from _assemble(x, sl, ctx.pieces)
        return x.reshape(-1)

    def mine(x):  # the logical tensor, flat -> this rank's slice
        return sl.cut(x.reshape(plan.shape)).contiguous()

    if sp.route == "part":  # every rank's elements of the logical tensor, in order
        ranges = [(lo * sp.unit, min(hi * sp.unit, plan.size)) for lo, hi in sp.bounds]
        sizes = [max(0, b - a) for a, b in ranges]
        start = ranges[index][0]
    if plan.dense:  # replicated: its element range, gathered
        gw_whole = yield from whole(gw)
        total = yield from _call(Collective("all_reduce", gw_whole[start:start + sizes[index]],
                                            ctx.across, "dense"))
        ghat = yield from _gather_parts(total / n, sizes, model)
        return mine(ghat).to(g.dtype), None, None
    m = slices.decode(ctx.codec, enc, sl, ctx.layout).reshape(sp.local_shape)
    if sp.route == "exact":
        ghat, m_new, sums, _, payload, ef_mean = yield from _tp_exact_steps(sp, sl, gw, m, ctx)

        def lift(y):  # ef_mean over the rank's own elements -> the logical tensor
            if not sp.unique:
                return _gather_parts(y, [b - a for a, b in _even(plan.size, ctx.parts)], model)
            return whole(y)
    elif sp.route == "local":
        ghat, m_new, sums, payload, ef_mean = yield from _tp_run(
            sp, sl, gw.reshape(sp.work), m.reshape(sp.work), ctx)
        lift = whole
    else:  # "part": this rank's units of the logical tensor, then every rank's parts
        gw_whole = yield from whole(gw)
        m_whole = yield from whole(m)
        part = gw_whole[start:start + sizes[index]]
        m_part = m_whole[start:start + sizes[index]]
        if part.numel():
            ghat, m_new, sums, payload, ef_mean = yield from _tp_run(
                sp, sl, part.reshape(sp.work), m_part.reshape(sp.work), ctx)
        else:
            yield from _idle(ring_rounds(plan.comp) + ctx.want_ef)
            ghat, m_new, sums, payload, ef_mean = part, m_part, None, 0.0, part
        ghat = mine((yield from _gather_parts(ghat, sizes, model)))
        m_new = mine((yield from _gather_parts(m_new, sizes, model)))

        def lift(y):
            return _gather_parts(y, sizes, model)
    store = (1,) + tuple(enc["q"].shape[1:])
    dtype, device = g.dtype, g.device
    if not taps.active():
        # read no more: freed before the encode's full-size temporaries (at a
        # vocabulary table's slice, each is GBs)
        g = gw = m = gw_whole = m_whole = part = m_part = None
    dither = slices.row_dither(ctx.codec, codec_key(plan.path, ctx.t), plan.groups, ctx.row, sl,
                               ctx.layout, device)
    new_enc = yield from slices.encode_steps(ctx.codec, m_new.reshape(store), sl, ctx.layout,
                                             dither, ctx.pieces)
    if taps.active():
        use_fused = ctx.fused and sp.route != "exact" and plan.comp.name in FUSABLE_MODES
        yield from _tp_taps(sp, sl, ctx, m + gw, ef_mean, whole, lift, ghat, m_new, new_enc, sums,
                            payload, use_fused)
    return ghat.reshape(sp.local_shape).to(dtype), new_enc, sums


def _tp_reduce(grads, sc_state: ScaleComState, sc_cfg: ScaleComConfig, layout: _TPLayout,
               hierarchy=None, compute_stats: bool = False, buckets: Any = False,
               consume: bool = False):
    """Algorithm 1 over this rank's (1, *slice) gradients on a grid (``tp``:
    (data x model), the workers on "data"; ``fsdp``: (pod x data x model),
    the workers on "pod"): the plan of each logical tensor (``plan_tensors``
    at n = the workers, G = ``sc_cfg.groups`` or n) mapped onto the rank's
    block (``plan_shards`` over ``layout.pieces``: the model group, or the
    pod's (data, model) plane), each tensor's part reduced over the
    workers' group (with ``hierarchy``: a mean over the rank's group, then
    the compressor's reduce over its inter group), the parts of a "part"
    tensor gathered over the blocks' ranks, the exact path's offsets and
    values in ranges of its k; the rank's residue slice decoded and m'
    encoded in any codec (``distributed.slices``).

    ``buckets`` (``core.overlap.resolve_buckets``; None/"auto" reads
    $SCALECOM_TORCH_BUCKET_MB): the schedule of the logical plans, the
    stacked step's, the same on every rank. Unbucketed, each tensor's round
    generator (``_tp_leaf_steps``) runs in leaf order with blocking calls.
    Bucketed, each bucket is one async ``ring.Flight`` advanced round by
    round as the group step's are (``_run_steps``; on the side stream with
    ``overlap``): the payload, the taps and the gathers of both axes go
    packed, one call per round, group and kind, while the oracle's and the
    stats' all-reduces keep their own calls. Offsets and m' are the
    unbucketed step's bits; ĝ sums its packed values in another order.

    Returns (ghat, new_state, stats): ``comm_bytes_per_worker`` and
    ``comm_bytes_dense`` are the logical plan's (the stacked step's),
    ``comm_bytes_per_shard`` this rank's share of the first, and with
    ``compute_stats`` ``contraction_gamma`` over the logical tensors (each
    rank's partial sums over the elements it reduces, summed over the
    blocks' ranks in one all-reduce). With ``sc_cfg.telemetry`` the taps come back
    as ``"obs/<key>"`` entries under the stacked reduce's keys, each the
    stacked step's value for the logical tensor and the same on every rank
    (``_tp_taps``; ``fused_launches`` counts the leader's launches), and
    ĝ, m' and the offsets are the bits of telemetry off.

    ``consume``: ``grads`` is the step's own tree, whose leaves the reduce
    sets to None once it holds them, so that each slice is freed when its
    tensor is reduced: at the reduce's end a rank holds ĝ and no second
    copy of the gradient (a full-width slice's worth less at the peak)."""
    with taps.collect() if sc_cfg.telemetry else contextlib.nullcontext() as collected:
        ghat, new_state, stats = _tp_reduce_body(grads, sc_state, sc_cfg, layout, hierarchy,
                                                 compute_stats, buckets, collected, consume)
    for key in sorted(collected or ()):
        stats[f"obs/{key}"] = collected[key]
    return ghat, new_state, stats


def _drop_leaves(t) -> None:
    """Every leaf of a tree of dicts and lists set to None, in place."""
    for k in (t if isinstance(t, dict) else range(len(t))):
        if isinstance(t[k], (dict, list)):
            _drop_leaves(t[k])
        else:
            t[k] = None


def _tp_reduce_body(grads, sc_state, sc_cfg, layout, hierarchy, compute_stats, buckets,
                    collected, consume):
    n = layout.workers.size()
    flat = tree.flatten_with_path(grads)
    if tuple(p for p, _ in flat) != layout.paths:
        raise ValueError("the gradient tree's leaves are not the model's")
    plans = plan_tensors(tuple((p, s, n) for p, s in zip(layout.paths, layout.shapes)), sc_cfg,
                         frozenset(sc_state.residues))
    shards = plan_shards(plans, layout.specs, layout.parts, layout.piece_index,
                         layout.pieces.axes)
    codec, lay = sc_cfg.residue_dtype, resolve_layout(sc_cfg.layout)
    for i, (sp, (path, g)) in enumerate(zip(shards, flat)):
        if tuple(g.shape[1:]) != sp.local_shape:
            raise ValueError(f"gradient {path!r} is {tuple(g.shape[1:])}, this rank's slice of "
                             f"{sp.plan.shape} is {sp.local_shape} (shard_train_state)")
        if not sp.plan.dense:
            enc = sc_state.residues[path]
            got = tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in enc.items()))
            want = slices.signature(codec, layout.slice(i), lay)
            if got != want:
                raise ValueError(f"residue {path!r} holds {got}, want this rank's {codec} slice "
                                 f"{want} (shard_train_state)")
    device = flat[0][1].device
    ctx = _TPCtx(codec=codec, layout=lay, beta=sc_cfg.beta, t=sc_state.t,
                 backend=resolve_backend(sc_cfg.backend, device), fused=resolve_fused(sc_cfg.fused),
                 across=layout.workers if hierarchy is None else hierarchy.inter,
                 hierarchy=hierarchy, row=layout.row if hierarchy is None else hierarchy.index,
                 pieces=layout.pieces, index=layout.piece_index,
                 want_ef=compute_stats or sc_cfg.telemetry,
                 ef_kind="stats" if compute_stats else "telemetry",
                 metrics_every=sc_cfg.metrics_every)
    steps = [_tp_leaf_steps(sp, g, sc_state.residues.get(path), ctx, layout.slice(i))
             for i, (sp, (path, g)) in enumerate(zip(shards, flat))]
    paths = [p for p, _ in flat]
    flat = g = None  # each leaf now lives in its tensor's generator (and in grads)
    if consume:
        _drop_leaves(grads)
    results = _run_steps(steps, overlap.resolve_buckets(buckets, sc_cfg, plans), device, sc_cfg,
                         collected)
    new_residues = dict(sc_state.residues)
    ghat_leaves, sums = [], []
    for path, (ghat, new_enc, part) in zip(paths, results):
        ghat_leaves.append(ghat)
        if new_enc is not None:
            new_residues[path] = new_enc
        if part is not None:
            sums.append(part)
    stats = {"comm_bytes_per_worker": sum(p.bytes_payload for p in plans),
             "comm_bytes_dense": sum(p.bytes_dense for p in plans),
             "comm_bytes_per_shard": sum(sp.bytes_payload for sp in shards)}
    if compute_stats:
        total = (torch.sum(torch.stack(sums), dim=0) if sums else
                 torch.zeros(2, dtype=torch.float32, device=device))
        total = tensor_parallel.all_reduce(total, layout.pieces.group)
        stats["contraction_gamma"] = total[0] / torch.clamp_min(total[1], 1e-30)
    return (tree.unflatten(grads, ghat_leaves),
            ScaleComState(residues=new_residues, t=sc_state.t + 1), stats)


def _tp_global_norm(ghat, layout: _TPLayout) -> torch.Tensor:
    """``global_norm`` of the logical gradient from this rank's blocks: a
    cut leaf's sum of squares all-reduced over the blocks' ranks (the model
    group under ``tp``; one call for all of them, a block that other ranks
    hold alike counted on the first of them), an uncut leaf's counted once;
    summed in leaf order."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in tree.leaves(ghat)]
    cut = [(i, sl) for i, sl in enumerate(map(layout.slice, range(len(sq)))) if sl.cuts]
    if cut:
        coords = {a: layout.mesh.index(a) for a, _ in layout.pieces.axes}
        mine = torch.stack([sq[i] if first_holder(sl.axes, coords) else torch.zeros_like(sq[i])
                            for i, sl in cut])
        total = tensor_parallel.all_reduce(mine, layout.pieces.group)
        for j, (i, _) in enumerate(cut):
            sq[i] = total[j]
    return torch.sqrt(sum(sq))


class _OnBlocks:
    """``model`` whose loss takes this rank's ``fsdp`` blocks: each leaf
    gathered over the pod's data ranks first (``distributed.fsdp.
    gather_params``, ``specs`` in leaf order), so that the pass runs on the
    ``tp`` slices and the gradients come back as blocks, summed over the
    data ranks."""

    def __init__(self, model, specs, data_group):
        self.model, self.specs, self.data_group = model, specs, data_group

    def loss(self, params, batch, **kw):
        return self.model.loss(fsdp.gather_params(params, self.specs, self.data_group), batch,
                               **kw)


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
    mesh=None,
    policy: str = "tp",
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

    ``mesh``: a grid of process groups (``launch.mesh.make_test_mesh``),
    the sharded step, the counterpart of the reference's step under its
    ``policy``. ``policy="tp"`` (the default, as the reference's
    ``RunConfig.sharding_policy``) takes a (data, model) grid: the ranks
    of one data index are one of the ``n_workers`` (= the data size)
    workers and take the same row of the batch; each holds its slice of
    every parameter, optimizer leaf and of its worker's residues
    (``shard_train_state(state, mesh=..., axes=...)``). The pass splits
    attention's heads, the MLP's hidden units, MoE's experts (or each
    expert's hidden units), RWKV-6's heads, the RG-LRU's channels and the
    vocabulary over the model group (``distributed.tensor_parallel``); the reduce plans each
    logical tensor and runs over the data group on the rank's part of it
    (``_tp_reduce``); the loss and auxs are averaged over the data group;
    ``grad_norm`` is the logical gradient's; the dense mode all-reduces
    each slice over the data group. It runs what the reference's sharded
    step runs: every compressor, chunked or exact, fused or not, every
    residue codec (``distributed.slices``), ``groups`` (the hierarchies of
    every data line, built on every rank: ``ring.make_hierarchy(lines=)``),
    ``compute_stats``, ``buckets`` (the logical plans' schedule, each
    bucket's collectives of both axes packed and async, as the group
    step's; see ``_tp_reduce``), ``telemetry`` (the stacked step's
    ``"obs/<key>"`` taps for the logical tensors, the same on every rank
    of the grid) and ``mode="dense"``, for every family of the registry
    (the encoder-decoder's encoder and cross-attention split as the
    decoder's self-attention); a vocabulary the model size does not divide
    stays whole on every rank.

    ``policy="fsdp"`` takes a (pod, data, model) grid: the reference's
    setting for its biggest archs on two pods (``repro/launch/dryrun.py``
    ``default_settings``), in which each pod is one of the ``n_workers``
    (= the pod size) workers. A rank takes its data index's share of its
    pod's rows of the batch, and holds its block of every parameter,
    optimizer leaf and of its pod's residue row under the fsdp specs: cut
    over "model" as under ``tp`` and on the "embed" dim over "data"
    (``shard_train_state(..., policy="fsdp")``). The pass gathers each
    parameter's blocks over the pod's data ranks first
    (``distributed.fsdp``: the gradients come back reduce-scattered,
    summed over them, and are divided by the data size: the worker's
    gradient), MoE layers route the pod's rows as one batch
    (``per_worker_grads(data_group=)``), and the compressor's reduce runs
    across the pods on the rank's block (``_tp_reduce``: blocks, parts and
    fp8 scales over the pod's (data, model) plane). The dense mode
    all-reduces each block over the pods after the data ranks' sum, and
    routes MoE tokens over the (pod, data) plane. It runs every
    compressor, the exact path, every residue codec, ``compute_stats`` and
    ``buckets``; ``groups``, ``telemetry`` and ``microbatches`` > 1 raise
    (ROADMAP Queue 1 sharded-step item 3b). The reference marks fsdp with
    per-rank workers (its workers on "data") dense-only: a (data, model)
    grid with ``policy="fsdp"`` raises, as does any other grid.
    """
    if mode not in ("scalecom", "dense"):
        raise ValueError(f"mode must be 'scalecom' or 'dense', got {mode!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if mesh is not None:
        _tp_check(model, mesh, n_workers, group, policy, sc_cfg)
        if policy == "fsdp" and microbatches > 1:
            raise ValueError("microbatches under the fsdp step is ROADMAP Queue 1 sharded-step "
                             "item 3b, not ported yet")
        layout = _tp_layout(model.abstract_params(), model.logical_axes(), mesh, policy)
        row = layout.row
        hierarchy = (None if sc_cfg.groups is None else
                     make_hierarchy(layout.workers, sc_cfg.groups, lines=mesh.lines("data")))
        fsdp_ = policy == "fsdp"
        share = mesh.shape["data"] if fsdp_ else 1  # the worker's batch split over "data"
        loss_model = _OnBlocks(model, layout.specs, layout.data) if fsdp_ else model
    elif group is not None:
        if n_workers != group.size():
            raise ValueError(
                f"a train step over a process group runs one worker per rank: n_workers "
                f"({n_workers}) must equal group.size() ({group.size()})")
        rank = dist.get_rank(group)
        hierarchy = None if sc_cfg.groups is None else make_hierarchy(group, sc_cfg.groups)
    # fp32 GEMMs without TF32, bf16 and fp16 ones accumulating in fp32, as
    # the JAX package's matmuls do whatever the model's compute dtype
    fp32_accumulation()

    def update(state: TrainState, ghat, gnorm, loss, auxs, sc_state, stats):
        """Clip, the optimizer's update and the metrics: the new state."""
        if grad_clip is not None:
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            ghat = tree.tree_map(lambda g: g * scale, ghat)
        lr = schedule(state.step)
        params, opt_state = optimizer.update(ghat, state.opt_state, state.params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   **{k: torch.mean(v) for k, v in auxs.items()}, **stats}
        return TrainState(params, opt_state, sc_state, state.step + 1), metrics

    def tp_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        device = tree.leaves(state.params)[0].device
        batch = _batch_on(batch, device)
        shapes = _check_lead(batch, n_workers)
        batch = {k: v[row:row + 1] for k, v in batch.items()}
        if share > 1:  # this data rank's rows of its pod's
            B = next(iter(shapes.values()))[1]
            if B % share:
                raise ValueError(f"per-worker batch {B} is not divisible by the grid's data "
                                 f"size {share}")
            d = mesh.index("data")
            batch = {k: v[:, d * (B // share):(d + 1) * (B // share)] for k, v in batch.items()}
        if mode == "scalecom":
            loss, auxs, gpw = per_worker_grads(loss_model, state.params, batch, 1, microbatches,
                                               tp=layout.axis,
                                               data_group=layout.data if share > 1 else None)
            if share > 1:  # the gathers' backward summed the data ranks' gradients
                for g in tree.leaves(gpw):
                    g.div_(share)
            ghat, sc_state, stats = _tp_reduce(gpw, state.sc_state, sc_cfg, layout, hierarchy,
                                               compute_stats, buckets, consume=True)
            del gpw
        else:
            loss, auxs, ghat = dense_grads(loss_model, state.params, batch, tp=layout.axis,
                                           data_group=layout.batch_group)
            ghat = tree.tree_map(lambda g: all_reduce_mean(g, layout.workers) / share, ghat)
            sc_state = ScaleComState(residues=state.sc_state.residues, t=state.sc_state.t + 1)
            stats = {}
        loss, auxs = _group_mean(loss, auxs, layout.batch_group)
        return update(state, ghat, _tp_global_norm(ghat, layout), loss, auxs, sc_state, stats)

    if mesh is not None:
        return tp_step

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
            loss, auxs, ghat = dense_grads(model, state.params, batch, data_group=group)
            if group is not None:
                ghat = tree.tree_map(lambda g: all_reduce_mean(g, group), ghat)
            sc_state = ScaleComState(residues=state.sc_state.residues, t=state.sc_state.t + 1)
            stats = {}
        if group is not None:
            loss, auxs = _group_mean(loss, auxs, group)
        return update(state, ghat, global_norm(ghat), loss, auxs, sc_state, stats)

    return train_step


def init_train_state(model, optimizer: Optimizer, sc_cfg: ScaleComConfig,
                     generator: torch.Generator, *, n_workers: int,
                     device="cuda", mesh=None, policy: str = "tp") -> TrainState:
    """Random parameters from ``generator`` on ``device``, optimizer state and
    zero ScaleCom residues.

    With ``mesh`` (a (data, model) grid, or for ``policy="fsdp"`` a (pod,
    data, model) one): this rank's share for the sharded step, without the
    stacked state: the rank's blocks of the parameters under ``policy``'s
    specs (``Model.init(mesh=...)``: each layer cut as it is drawn,
    the same draws on every rank for the same generator state, so the
    slices are the whole init's), the optimizer state on the slices, and a
    zero residue slice in ``sc_cfg.residue_dtype``'s codec, every field
    (``distributed.slices``), for every tensor whose logical size reaches
    ``min_size``."""
    params = model.init(generator, device, mesh=mesh, policy=policy)
    if mesh is not None:
        layout = _tp_layout(model.abstract_params(), model.logical_axes(), mesh, policy)
        lay = resolve_layout(sc_cfg.layout)
        dev = tree.leaves(params)[0].device
        residues = {p: slices.init(sc_cfg.residue_dtype, layout.slice(i), lay, dev)
                    for i, p in enumerate(layout.paths)
                    if math.prod(layout.shapes[i]) >= sc_cfg.min_size}
        return TrainState(params, optimizer.init(params), ScaleComState(residues, 0), 0)
    sc_state = init_state(
        params, sc_cfg.n_workers(n_workers), sc_cfg.residue_dtype, sc_cfg.min_size,
        sc_cfg.layout,
    )
    return TrainState(params, optimizer.init(params), sc_state, 0)


def shard_train_state(state: TrainState, rank: Optional[int] = None,
                      world: Optional[int] = None, groups: Optional[int] = None, *,
                      mesh=None, axes=None, policy: str = "tp") -> TrainState:
    """Rank ``rank``'s share of a worker-stacked TrainState over ``world``
    ranks: its own row of every field of every residue encoding (with
    ``groups=G``, the row of its group, ``rank // (world // G)``, of G
    rows), and copies of the replicated params and optimizer state (so a
    step on the share leaves ``state`` as it was). The step counter and
    ScaleCom ``t`` carry over.

    With ``mesh`` (a (data, model) grid of process groups) and the model's
    logical ``axes`` instead: this rank's share for the tensor-parallel
    step (``build_train_step(mesh=...)``): its slice under the ``tp``
    specs (``distributed.sharding``) of every parameter and optimizer leaf,
    and of its worker's residue row (with ``groups=G``, the row of its
    group, ``data index // (data size // G)``, of G rows), every field of
    any codec cut to the slice (``distributed.slices.cut``: the codes at
    the slice's logical positions, fp8's flat scales whole). With
    ``policy="fsdp"`` and a (pod, data, model) grid: its block under the
    ``fsdp`` specs (cut over "model" and, on "embed", over "data") of every
    leaf, and of its pod's residue row (a pod is one worker)."""
    if mesh is not None:
        if rank is not None or world is not None:
            raise ValueError("a grid's share takes mesh=, axes= and groups, not rank or world")
        return _shard_tp_state(state, mesh, axes, groups, policy)
    if rank is None or world is None:
        raise ValueError("shard_train_state takes rank and world, or mesh= and axes=")
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


def _shard_tp_state(state: TrainState, mesh, axes, groups: Optional[int],
                    policy: str = "tp") -> TrainState:
    if axes is None:
        raise ValueError("a grid's share needs the model's logical axes (Model.logical_axes())")
    specs = specs_for_axes(state.params, axes, policy, mesh)
    by_path = dict(tree.flatten_with_path(specs))
    shapes = {p: tuple(x.shape) for p, x in tree.flatten_with_path(state.params)}
    worker = "pod" if policy == "fsdp" else "data"
    split = ("data", "model") if policy == "fsdp" else ("model",)
    n = mesh.shape[worker]
    if groups is not None and (groups < 1 or n % groups):
        raise ValueError(f"{n} workers not divisible into {groups} groups: a grid of {n} {worker} "
                         f"ranks needs n % groups == 0 (G={groups})")
    rows = n if groups is None else groups
    row = mesh.index(worker) if groups is None else mesh.index(worker) // (n // groups)

    def shard(tree_):
        return tree.unflatten(tree_, [shard_of(x, by_path[p], mesh)
                                      for p, x in tree.flatten_with_path(tree_)])

    opt_state = {}
    for key, val in state.opt_state.items():
        same = isinstance(val, dict) and [p for p, _ in tree.flatten_with_path(val)] == list(
            shapes)
        opt_state[key] = shard(val) if same else (
            tree.tree_map(torch.clone, val) if isinstance(val, dict) else val)
    residues = {}
    for path, enc in state.sc_state.residues.items():
        if any(v.shape[0] != rows for v in enc.values()):
            raise ValueError(f"residue {path!r} must hold rows of {rows} workers, got "
                             f"{ {k: tuple(v.shape) for k, v in enc.items()} }")
        sl = slices.block_of(shapes[path], by_path[path], mesh, split)
        residues[path] = slices.cut(slices.codec_name(enc),
                                    {k: v[row:row + 1] for k, v in enc.items()}, sl,
                                    slices.infer_layout(enc, shapes[path]))
    return TrainState(shard(state.params), opt_state,
                      ScaleComState(residues=residues, t=state.sc_state.t), state.step)
