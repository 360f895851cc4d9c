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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common

Tensor = torch.Tensor

__all__ = ["init_moe", "moe_ffn"]


def init_moe(cfg, store: common.ParamStore, stacked: int = 0):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    store.dense("router", (D, E), scale=0.02, stacked=stacked)
    store.dense("expert_gate", (E, D, Fd), stacked=stacked)
    store.dense("expert_up", (E, D, Fd), stacked=stacked)
    store.dense("expert_down", (E, Fd, D), stacked=stacked)


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


def moe_ffn(cfg, p: Dict[str, Tensor], x: Tensor, *,
            dtype: torch.dtype) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, D) -> (B, S, D) in ``dtype`` and the aux dict
    (``moe_lb_loss``, ``moe_z_loss``, ``moe_dropped_frac``), in fp32."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_topk
    T = B * S
    xt = x.reshape(T, D)

    logits = (xt @ p["router"].to(dtype)).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choice = torch.topk(probs, K, dim=-1)  # (T, K)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    capacity = max(8, int(cfg.capacity_factor * T * K / E))
    flat_e = choice.reshape(-1)  # (T*K,)
    pos = _positions_in_expert(flat_e, E).long()
    keep = pos < capacity
    # the overflow choices all land in the sink row E * capacity
    slot = torch.where(keep, flat_e * capacity + pos, torch.full_like(pos, E * capacity))

    # dispatch: (E*C + 1, D) buffers, the last row the dropped-choice sink
    buf = torch.zeros((E * capacity + 1, D), dtype=dtype, device=x.device).index_add(
        0, slot, xt.repeat_interleave(K, dim=0).to(dtype))
    eb = buf[: E * capacity].reshape(E, capacity, D)

    h_gate = torch.einsum("ecd,edf->ecf", eb, p["expert_gate"].to(dtype))
    h_up = torch.einsum("ecd,edf->ecf", eb, p["expert_up"].to(dtype))
    eo = torch.einsum("ecf,efd->ecd", F.silu(h_gate) * h_up, p["expert_down"].to(dtype))

    # combine: each (token, choice) slot's output, weighted by gate * keep
    flat_out = torch.cat([eo.reshape(E * capacity, D), eo.new_zeros((1, D))], dim=0)
    per_choice = torch.index_select(flat_out, 0, slot).reshape(T, K, D)
    w = (gate_vals * keep.reshape(T, K)).to(dtype)
    out = torch.einsum("tkd,tk->td", per_choice, w)

    # aux losses (fp32): load balance (GShard) and router z-loss (ST-MoE)
    me = torch.mean(probs, dim=0)  # (E,) mean router probability
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (T * K)  # share routed
    aux = {
        "moe_lb_loss": E * torch.sum(me * ce),
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_dropped_frac": 1.0 - torch.sum(keep) / (T * K),
    }
    return out.reshape(B, S, D), aux
