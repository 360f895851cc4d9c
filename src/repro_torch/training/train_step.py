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

Batches arrive worker-stacked, as numpy arrays or tensors
({"tokens": (n, B, S), ...}), and are moved to the parameters' device here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import ScaleComState, init_state
from repro_torch.optim.optimizer import Optimizer

__all__ = [
    "TrainState", "build_train_step", "init_train_state", "global_norm", "per_worker_grads",
    "per_worker_grads_loop", "dense_grads",
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
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    if any(s[0] != n_workers for s in shapes.values()):
        raise ValueError(f"batch leaves {shapes} do not lead with {n_workers} workers")
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
    """
    if mode not in ("scalecom", "dense"):
        raise ValueError(f"mode must be 'scalecom' or 'dense', got {mode!r}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    # The JAX package trains in full fp32 (compute_dtype="float32"); TF32
    # would keep about three decimal digits in the card's matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        device = tree.leaves(state.params)[0].device
        batch = _batch_on(batch, device)
        if mode == "scalecom":
            loss, auxs, gpw = per_worker_grads(model, state.params, batch, n_workers,
                                               microbatches)
            ghat, sc_state, stats = scalecom_reduce(
                gpw, state.sc_state, sc_cfg, compute_stats=compute_stats, buckets=buckets
            )
            del gpw
        else:
            loss, auxs, ghat = dense_grads(model, state.params, batch)
            sc_state = ScaleComState(residues=state.sc_state.residues, t=state.sc_state.t + 1)
            stats = {}

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
