"""RWKV-6 "Finch" blocks (arXiv:2404.05892): attention-free, data-dependent decay.

The port of ``repro.models.rwkv``: the block over a sequence
(``rwkv_block_train``, also prefill's) and over one token
(``rwkv_block_decode``, a decode step's). Time mix:

  * token shift with data-dependent interpolation (ddlerp) through five
    low-rank adapters (r, k, v, g, w), ``LORA_R`` wide;
  * a per-channel data-dependent decay ``w_t = exp(-exp(wd_t))``;
  * a per-head state S (hd x hd):  y_t = r_t · (S + u ⊙ k_t v_tᵀ),
                                   S  ← w_t ⊙ S + k_t v_tᵀ;
  * a per-head group norm (no mean subtracted) and the silu output gate.

Channel mix: r = σ(x_r W_r); out = r ⊙ (relu(x_k W_k)² W_v).

The recurrence is a Python loop over the sequence in fp32, every op out of
place, so ``torch.func.vmap`` over the workers takes it without a fallback.
Autograd keeps each step's state for the backward pass (the reference's
``lax.scan`` keeps its carries too); the bonus term is summed apart from
the state's, so no other (hd x hd) tensor of a step is kept.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common

Tensor = torch.Tensor

__all__ = ["LORA_R", "init_rwkv_block", "time_mix", "channel_mix", "rwkv_block_train",
           "rwkv_block_decode", "init_rwkv_state"]

LORA_R = 64  # low-rank adapter width for ddlerp and the decay


def init_rwkv_block(cfg, store: common.ParamStore, stacked: int = 0):
    D, Fd = cfg.d_model, cfg.d_ff
    hd = cfg.ssm_head_dim
    H = D // hd
    common.init_norm(cfg, store, "ln_tm", D, stacked=stacked)
    common.init_norm(cfg, store, "ln_cm", D, stacked=stacked)
    # time-mix projections
    for nm in ("tm_wr", "tm_wk", "tm_wv", "tm_wg"):
        store.dense(nm, (D, D), stacked=stacked)
    store.dense("tm_wo", (D, D), stacked=stacked)
    # ddlerp base mixers (5 interpolation targets: r, k, v, g, w)
    store.zeros("tm_mu", (5, D), stacked=stacked)
    store.dense("tm_lora_a", (5, D, LORA_R), scale=0.01, stacked=stacked)
    store.dense("tm_lora_b", (5, LORA_R, D), scale=0.01, stacked=stacked)
    # data-dependent decay
    store.zeros("tm_w0", (D,), stacked=stacked)
    store.dense("tm_wd_a", (D, LORA_R), scale=0.01, stacked=stacked)
    store.dense("tm_wd_b", (LORA_R, D), scale=0.01, stacked=stacked)
    store.zeros("tm_u", (H, hd), stacked=stacked)  # bonus
    store.ones("tm_gn", (D,), stacked=stacked)  # per-head group-norm scale
    # channel mix
    store.zeros("cm_mu", (2, D), stacked=stacked)
    store.dense("cm_wk", (D, Fd), stacked=stacked)
    store.dense("cm_wv", (Fd, D), stacked=stacked)
    store.dense("cm_wr", (D, D), stacked=stacked)


def _ddlerp(p, x: Tensor, x_prev: Tensor) -> Tuple[Tensor, ...]:
    """Data-dependent token-shift interpolation -> the 5 mixed inputs (r, k, v, g, w)."""
    xx = x_prev - x  # (B, S, D)
    mu = p["tm_mu"]  # (5, D)
    base = x[:, :, None, :] + xx[:, :, None, :] * mu  # (B, S, 5, D)
    adj = torch.tanh(torch.einsum("bsfd,fdr->bsfr", base, p["tm_lora_a"]))
    adj = torch.einsum("bsfr,frd->bsfd", adj, p["tm_lora_b"])
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (mu + adj)
    return tuple(mixed[:, :, i, :] for i in range(5))


def _shift(x: Tensor, x_last: Tensor) -> Tensor:
    """Token shift: the x_{t-1} sequence; ``x_last`` (B, D) is the carry-in token."""
    return torch.cat([x_last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def time_mix(cfg, p, x: Tensor, state: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, D); state: {"s": (B, H, hd, hd), "x_prev": (B, D)}."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    H = D // hd
    xr, xk, xv, xg, xw = _ddlerp(p, x, _shift(x, state["x_prev"]))
    r = (xr @ p["tm_wr"]).reshape(B, S, H, hd)
    k = (xk @ p["tm_wk"]).reshape(B, S, H, hd)
    v = (xv @ p["tm_wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["tm_wg"])
    wd = p["tm_w0"] + (xw @ p["tm_wd_a"]) @ p["tm_wd_b"]
    w = torch.exp(-torch.exp(wd)).reshape(B, S, H, hd)  # decay in (0, 1)
    u = p["tm_u"]  # (H, hd)
    s = state["s"]
    ys = []
    for t in range(S):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]  # (B, H, hd)
        # y_t = r·(S + u ⊙ k vᵀ) summed as r·S + (r·(u ⊙ k)) v: autograd then
        # keeps one (B, H, hd, hd) tensor a step (the state), not three
        bonus = torch.sum(rt * u * kt, dim=-1, keepdim=True) * vt
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s) + bonus)
        s = w[:, t, :, :, None] * s + kt[..., :, None] * vt[..., None, :]
    y = torch.stack(ys, dim=1)  # (B, S, H, hd)
    # per-head group norm
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    y = y.reshape(B, S, D) * p["tm_gn"]
    out = (y * g) @ p["tm_wo"]
    return out, {"s": s, "x_prev": x[:, -1, :]}


def channel_mix(cfg, p, x: Tensor, x_prev: Tensor) -> Tuple[Tensor, Tensor]:
    mu = p["cm_mu"]
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    r = torch.sigmoid(xr @ p["cm_wr"])
    return r * (k @ p["cm_wv"]), x[:, -1, :]


def rwkv_block_train(cfg, p, x: Tensor, state) -> Tuple[Tensor, Dict]:
    """The pre-norm time mix, then the pre-norm channel mix, each residual."""
    h, new_tm = time_mix(cfg, p, common.apply_norm(cfg, x, p, "ln_tm"), state["tm"])
    x = x + h
    h, cm_prev = channel_mix(cfg, p, common.apply_norm(cfg, x, p, "ln_cm"), state["cm_x_prev"])
    return x + h, {"tm": new_tm, "cm_x_prev": cm_prev}


def rwkv_block_decode(cfg, p, x: Tensor, state) -> Tuple[Tensor, Dict]:
    """One token x (B, 1, D): the block at S = 1, as the reference's."""
    return rwkv_block_train(cfg, p, x, state)


def init_rwkv_state(cfg, batch: int, device=None) -> Dict:
    D = cfg.d_model
    hd = cfg.ssm_head_dim
    H = D // hd
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"tm": {"s": zeros(batch, H, hd, hd), "x_prev": zeros(batch, D)},
            "cm_x_prev": zeros(batch, D)}
