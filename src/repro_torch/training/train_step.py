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
tensor through ``ring_reduce`` (any chunked compressor), a dense one (and
every gradient of the dense mode) through an all-reduce and a division by
n. With ``ScaleComConfig.groups=G`` the world's ranks form G groups of n/G
(``ring.make_hierarchy``): each gradient is averaged over the rank's group
first (``ring.group_fold``), and the reduce runs across the groups, each
rank of a group holding a replica of the group's residue row. The residues
are this rank's row, or its group's, in any codec (``shard_train_state``);
params and optimizer state are replicated and stay bitwise identical
across ranks.

Batches arrive worker-stacked, as numpy arrays or tensors
({"tokens": (n, B, S), ...}), and are moved to the parameters' device here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.backends import resolve_backend, resolve_fused
from repro_torch.core import overlap
from repro_torch.core import state as state_codecs
from repro_torch.core.plan import plan_tensors
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import (
    ScaleComState, codec_key, codec_signature, init_state, require_codec, residue_signature,
)
from repro_torch.distributed.ring import all_reduce_mean, group_fold, make_hierarchy, ring_reduce
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


# what a group step runs, named by every refusal of what it does not
GROUP_SUPPORTED = ("compressor clt_k, true_topk, local_topk, random_k (chunked) or none, "
                   "every residue codec, groups, compute_stats; unfused, unbucketed, "
                   "no telemetry, no exact path")


def _require_group_support(sc_cfg: ScaleComConfig, buckets: Any) -> None:
    """Raise ValueError, naming ``GROUP_SUPPORTED``, for what of this
    configuration a group step does not run. Reads $SCALECOM_TORCH_FUSED
    and $SCALECOM_TORCH_BUCKET_MB for their "auto"."""
    comp = sc_cfg.compressor
    if comp.exact:
        refused = f"compressor {comp.name!r} with exact=True"
    elif resolve_fused(sc_cfg.fused):
        refused = "the fused reduce (its worker mean is inside one launch)"
    elif isinstance(buckets, (tuple, list)) or overlap.resolve_bucket_bytes(
            buckets, sc_cfg.bucket_bytes) is not None:
        refused = f"buckets={buckets!r}"
    elif sc_cfg.telemetry:
        refused = "telemetry"
    else:
        return
    raise ValueError(f"a train step over a process group does not run {refused}; "
                     f"it runs {GROUP_SUPPORTED}")


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


def _group_reduce(grads, sc_state: ScaleComState, sc_cfg: ScaleComConfig, group, hierarchy,
                  compute_stats: bool):
    """Algorithm 1 over this rank's (1, *shape) gradients with real
    collectives: the plan (``core.plan.plan_tensors`` at n = group.size()
    workers, G = ``sc_cfg.groups`` or n) sends a compressed tensor through
    ``ring_reduce`` and a dense one through ``all_reduce_mean``, over the
    whole group, or with ``hierarchy`` over its inter group after
    ``group_fold`` has averaged every gradient over the rank's own group.
    The rank's residue row is decoded, and m' encoded with the rank's row of
    the stacked draw. Returns (ghat, new_state, stats), stats holding the
    plan's ``comm_bytes_per_worker`` and ``comm_bytes_dense`` as the stacked
    reduce's do, and with ``compute_stats`` ``contraction_gamma`` from the
    worker-mean EF (one all-reduce of ef per tensor, ``sent["stats"]``)."""
    n = group.size()
    codec = require_codec(sc_cfg.residue_dtype)
    flat = tree.flatten_with_path(grads)
    # bare residue paths: the rows are this rank's, checked below
    plans = plan_tensors(tuple((p, tuple(g.shape[1:]), n) for p, g in flat), sc_cfg,
                         frozenset(sc_state.residues))
    device = flat[0][1].device
    backend = resolve_backend(sc_cfg.backend, device)
    across = group if hierarchy is None else hierarchy.inter
    row = dist.get_rank(group) if hierarchy is None else hierarchy.index
    t = sc_state.t
    new_residues = dict(sc_state.residues)
    ghat_leaves = []
    sq_err = sq_all = 0.0
    for plan, (path, g) in zip(plans, flat):
        gw = g[0].to(torch.float32)
        if hierarchy is not None:
            gw = group_fold(gw, hierarchy)
        if plan.dense:
            ghat_leaves.append(all_reduce_mean(gw, across).reshape(plan.shape).to(g.dtype))
            continue
        enc = sc_state.residues[path]
        want = codec_signature(sc_cfg.residue_dtype, 1, plan.storage)
        (_, got), = residue_signature({path: enc})
        if got != want:
            raise ValueError(f"residue {path!r} holds {got}, want this rank's row {want} "
                             f"(shard_train_state)")
        m = codec.decode(enc, plan.storage).reshape(plan.work)
        work = gw.reshape(plan.work)
        ghat, m_new = ring_reduce(work, m, t, plan.comp, sc_cfg.beta, across, backend)
        new_residues[path] = codec.encode(
            m_new.reshape((1,) + plan.storage), plan.storage,
            key=_row_dither(codec, path, t, plan.groups, row, plan.storage, device))
        ghat = ghat.reshape(plan.shape)
        if compute_stats:
            ef_mean = all_reduce_mean(m + work, across, "stats").reshape(plan.shape)
            sq_err = sq_err + torch.sum((ef_mean - ghat) ** 2)
            sq_all = sq_all + torch.sum(ef_mean**2)
        ghat_leaves.append(ghat.to(g.dtype))
    stats = {"comm_bytes_per_worker": sum(p.bytes_payload for p in plans),
             "comm_bytes_dense": sum(p.bytes_dense for p in plans)}
    if compute_stats:
        stats["contraction_gamma"] = sq_err / torch.clamp_min(torch.as_tensor(sq_all), 1e-30)
    return (tree.unflatten(grads, ghat_leaves),
            ScaleComState(residues=new_residues, t=t + 1), stats)


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
    the same order), and the world must divide into G groups. The dense
    mode stays one all-reduce over the whole group. A configuration outside
    ``GROUP_SUPPORTED`` raises ValueError.
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
        _require_group_support(sc_cfg, buckets)
        rank = dist.get_rank(group)
        hierarchy = None if sc_cfg.groups is None else make_hierarchy(group, sc_cfg.groups)
    # The JAX package trains in full fp32 (compute_dtype="float32"); TF32
    # would keep about three decimal digits in the card's matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        device = tree.leaves(state.params)[0].device
        batch = _batch_on(batch, device)
        if group is not None:
            _require_group_support(sc_cfg, buckets)  # "auto" reads env now
            _check_lead(batch, n_workers)
            batch = {k: v[rank:rank + 1] for k, v in batch.items()}
        if mode == "scalecom" and group is not None:
            loss, auxs, gpw = per_worker_grads(model, state.params, batch, 1, microbatches)
            ghat, sc_state, stats = _group_reduce(gpw, state.sc_state, sc_cfg, group, hierarchy,
                                                  compute_stats)
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
