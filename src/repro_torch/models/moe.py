"""Mixture-of-Experts FFN: top-k routing with capacity, scatter-based dispatch.

The port of ``repro.models.moe``. A softmax router picks each token's top-k
experts and renormalises their gates; a stable argsort gives every (token,
choice) its position in its expert's buffer; choices past the capacity go to
one sink row at ``E * capacity`` and are dropped (the residual connection
carries their activations). The experts are SwiGLU MLPs stacked on an expert
axis, (E, D, F) and (E, F, D).

Every op is out of place (``index_add``, ``scatter``, ``scatter_add``,
``gather``): the per-worker gradient pass runs this function under
``torch.func.vmap``, which refuses an in-place write of batched values into a
buffer made inside the function, and ``bincount`` (its size depends on the
data).

Auxiliary losses: the GShard load-balance loss and the ST-MoE router z-loss,
with the share of dropped choices, as the reference reports them.

Mixed precision as the reference places it: the router's logits, its
softmax and gates and the aux losses in fp32; the dispatch buffer, the
expert einsums and the combine weights in the compute dtype.

Under a model axis (``tp``, the reference's ``tp`` policy, whose specs put
``experts`` over "model", or, where the model size does not divide the
experts, each expert's ``mlp`` columns) every rank routes every token, as
the router is replicated: the choices, capacities, slots and aux losses
are the same on every rank. A rank runs its own experts' rows of the
dispatch buffer (or every expert on its own hidden columns), and the
weighted outputs are summed over the group. The dispatch's input and the
combine weights enter through ``copy``: their cotangents from one rank's
experts are a part, and the sum makes the router's gradient (replicated)
whole and the same on every rank.

A dense pass split over data ranks (``data_group``: the group step's and
the tensor-parallel step's dense mode, each rank one row of the global
batch) routes as the reference's pass over the folded global batch does:
the capacity counts every rank's tokens, a choice's place in its expert
follows the choices of the lower ranks' tokens (their counts, exchanged
over the group), and the load-balance loss takes the global share routed
to each expert. Each rank computes its own tokens; the mean over the ranks
of its loss, aux and gradients is the global pass's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import common

Tensor = torch.Tensor

__all__ = ["init_moe", "moe_ffn"]


def init_moe(cfg, store: common.ParamStore, stacked: int = 0):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    store.dense("router", (D, E), ("embed", None), scale=0.02, stacked=stacked)
    store.dense("expert_gate", (E, D, Fd), ("experts", "embed", "mlp"), stacked=stacked)
    store.dense("expert_up", (E, D, Fd), ("experts", "embed", "mlp"), stacked=stacked)
    store.dense("expert_down", (E, Fd, D), ("experts", "mlp", "embed"), stacked=stacked)


def _positions_in_expert(expert_ids: Tensor, n_experts: int) -> Tensor:
    """For a flat (N,) expert assignment, the occurrence rank of each entry
    within its expert, in stable order. Returns int32 (N,)."""
    n = expert_ids.shape[0]
    ids = expert_ids.long()
    order = torch.argsort(ids, stable=True)
    sorted_ids = torch.gather(ids, 0, order)
    # start offset of each expert in the sorted stream
    counts = torch.zeros(n_experts, dtype=torch.int64, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=ids.device) - torch.gather(starts, 0, sorted_ids)
    pos = torch.zeros(n, dtype=torch.int64, device=ids.device).scatter(0, order, pos_sorted)
    return pos.to(torch.int32)


class _DataSum(torch.autograd.Function):
    """The sum of an integer tensor over a data group (no gradient), under
    autograd, ``torch.func`` and remat's replays."""

    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _DataSum.apply(x, group), in_dims[0]


def _global_counts(flat_e: Tensor, n_experts: int, group) -> Tensor:
    """(ranks, E): each data rank's count of choices per expert."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    mine = torch.zeros(n_experts, dtype=torch.int64, device=flat_e.device).scatter_add(
        0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.int64))
    table = torch.zeros((n, n_experts), dtype=torch.int64, device=flat_e.device)
    return _DataSum.apply(table.index_copy(0, torch.tensor([rank], device=flat_e.device),
                                           mine[None]), group)


def moe_ffn(cfg, p: Dict[str, Tensor], x: Tensor, *, dtype: torch.dtype,
            tp=None, data_group=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, D) -> (B, S, D) in ``dtype`` and the aux dict
    (``moe_lb_loss``, ``moe_z_loss``, ``moe_dropped_frac``), in fp32.

    ``tp`` (a ``tensor_parallel.ModelAxis``): the expert leaves are this
    rank's slices, (E/M, D, F) and (E/M, F, D) where it splits
    ``experts``, else (E, D, F/M) and (E, F/M, D) where it splits ``mlp``;
    with neither split everything runs whole. ``data_group``: the data
    ranks of a dense pass over the global batch (module docstring)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_topk
    T = B * S
    xt = x.reshape(T, D)
    by_expert = tp and tp.over("experts")
    part = by_expert or (tp and tp.over("mlp"))

    logits = (xt @ p["router"].to(dtype)).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choice = torch.topk(probs, K, dim=-1)  # (T, K)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    flat_e = choice.reshape(-1)  # (T*K,)
    pos = _positions_in_expert(flat_e, E).long()
    routed = None
    if data_group is None:
        capacity = max(8, int(cfg.capacity_factor * T * K / E))
        keep = pos < capacity
    else:  # the global batch's routing: the lower data ranks' tokens come first
        counts = _global_counts(flat_e, E, data_group)
        n, rank = counts.shape[0], dist.get_rank(data_group)
        capacity = max(8, int(cfg.capacity_factor * n * T * K / E))
        keep = pos + torch.sum(counts[:rank], dim=0)[flat_e] < capacity
        routed = torch.sum(counts, dim=0).to(torch.float32) / (n * T * K)
    # the overflow choices all land in the sink row E * capacity
    slot = torch.where(keep, flat_e * capacity + pos, torch.full_like(pos, E * capacity))

    # dispatch: (E*C + 1, D) buffers, the last row the dropped-choice sink
    xd = xt if part is None else part.copy(xt)
    buf = torch.zeros((E * capacity + 1, D), dtype=dtype, device=x.device).index_add(
        0, slot, xd.repeat_interleave(K, dim=0).to(dtype))
    rows = E * capacity
    if by_expert:
        # this rank's experts' rows; another rank's slots read the zero row
        rows = E // part.size * capacity
        slot = slot - part.index * rows
        slot = torch.where((slot >= 0) & (slot < rows), slot, torch.full_like(slot, rows))
        eb = buf[part.index * rows:(part.index + 1) * rows]
    else:
        eb = buf[:rows]
    eb = eb.reshape(-1, capacity, D)

    h_gate = torch.einsum("ecd,edf->ecf", eb, p["expert_gate"].to(dtype))
    h_up = torch.einsum("ecd,edf->ecf", eb, p["expert_up"].to(dtype))
    eo = torch.einsum("ecf,efd->ecd", F.silu(h_gate) * h_up, p["expert_down"].to(dtype))

    # combine: each (token, choice) slot's output, weighted by gate * keep
    flat_out = torch.cat([eo.reshape(rows, D), eo.new_zeros((1, D))], dim=0)
    per_choice = torch.index_select(flat_out, 0, slot).reshape(T, K, D)
    w = (gate_vals * keep.reshape(T, K)).to(dtype)
    if part is not None:
        w = part.copy(w)
    out = torch.einsum("tkd,tk->td", per_choice, w)
    if part is not None:
        out = part.reduce(out)

    # aux losses (fp32): load balance (GShard) and router z-loss (ST-MoE)
    me = torch.mean(probs, dim=0)  # (E,) mean router probability
    ce = routed if routed is not None else torch.zeros(
        E, dtype=torch.float32, device=x.device).scatter_add(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (T * K)  # share routed
    aux = {
        "moe_lb_loss": E * torch.sum(me * ce),
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_dropped_frac": 1.0 - torch.sum(keep) / (T * K),
    }
    return out.reshape(B, S, D), aux
