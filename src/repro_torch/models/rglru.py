"""RG-LRU recurrent blocks of RecurrentGemma / Griffin (arXiv:2402.19427).

The port of ``repro.models.rglru``. One function serves training, prefill
and decode: ``rglru_block`` carries the hidden state ``h`` and the conv's
last W-1 inputs through any length, one token (S = 1) included. Recurrent block
(Griffin fig. 2):

    x -> [linear -> gelu]                              (gate branch)
    x -> [linear -> temporal conv1d (w=4) -> RG-LRU]   (recurrence branch)
    out = linear(gate ⊙ recurrence)

RG-LRU:  r_t = σ(W_a x_t),  i_t = σ(W_x x_t)
         a_t = exp(-c · softplus(Λ) · r_t)          (data-dependent decay)
         h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

Mixed precision as the reference places it: the gate, the input and the
conv in the compute dtype (``dtype``, each weight cast at use); ``r``,
``i``, the decay and the scan in fp32, the output cast back; the state
(``h`` and the conv's tail) fp32.

The recurrence is a first-order linear scan, computed here in ⌈log₂ S⌉
out-of-place rounds with the reference's combine (a1·a2, a2·b1 + b2): a
sequential loop would be thousands of launches at long sequence. Its sums
run in another order than ``lax.associative_scan``'s.

Under a model axis (``tp``, the reference's ``tp`` policy: "heads" over
"model") a rank runs its own channels: ``ln_rec`` whole, then one
``copy`` of the normed input feeding the four column-parallel products
(``rec_in_gate``, ``rec_in_x``, ``rec_wa``, ``rec_wx``), the depthwise conv,
the decay and the scan on the rank's columns of ``rec_conv``,
``rec_conv_b`` and ``rec_lambda`` (channel-local: no collective), and
``rec_out`` by rows, its product summed over the group.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common

Tensor = torch.Tensor

__all__ = ["init_rglru_block", "rglru_block", "init_rglru_state"]


def init_rglru_block(cfg, store: common.ParamStore, stacked: int = 0):
    D = cfg.d_model
    W = cfg.conv_width
    common.init_norm(cfg, store, "ln_rec", D, stacked=stacked)
    store.dense("rec_in_gate", (D, D), ("embed", "heads"), stacked=stacked)
    store.dense("rec_in_x", (D, D), ("embed", "heads"), stacked=stacked)
    store.dense("rec_conv", (W, D), (None, "heads"), scale=W**-0.5, stacked=stacked)
    store.zeros("rec_conv_b", (D,), ("heads",), stacked=stacked)
    store.dense("rec_wa", (D, D), ("embed", "heads"), scale=0.02, stacked=stacked)
    store.dense("rec_wx", (D, D), ("embed", "heads"), scale=0.02, stacked=stacked)
    store.zeros("rec_lambda", (D,), ("heads",), stacked=stacked)
    store.dense("rec_out", (D, D), ("heads", "embed"), stacked=stacked)


def _conv1d_causal(x: Tensor, w: Tensor, b: Tensor, tail: Tensor) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv as the reference sums it: shifted slices, tap by
    tap. x: (B, S, D), w: (W, D), tail: (B, W-1, D) carry-in."""
    W, S = w.shape[0], x.shape[1]
    xw = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, S+W-1, D)
    out = sum(xw[:, i : i + S, :] * w[i] for i in range(W)) + b
    return out, xw[:, xw.shape[1] - (W - 1) :, :]


def _rglru_scan(a: Tensor, bx: Tensor, h0: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + bx_t for every t, h_{-1} = h0. a/bx: (B, S, D) fp32.

    Hillis-Steele: after the round of offset d, position t holds the
    combine of positions t-2d+1 .. t; positions before 0 are the identity (1, 0).
    """
    # fold h0 into the first step
    bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None, :], bx[:, 1:]], dim=1)
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(bx[:, :-d], (0, 0, d, 0), value=0.0)
        a, bx = a_prev * a, a * b_prev + bx  # combine((a_prev, b_prev), (a, bx))
        d *= 2
    return bx


def rglru_block(cfg, p, x: Tensor, state: Dict[str, Tensor], *,
                dtype: torch.dtype, tp=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, D); state: {"h": (B, D), "conv": (B, W-1, D)}, fp32. Returns
    the residual x + out and the new state. With ``tp`` (a
    ``tensor_parallel.ModelAxis``) that splits "heads" the rank runs its
    D/M channels (module docstring) from its channels of ``state``, and
    the state it returns holds only those."""
    tp = tp and tp.over("heads")
    f32 = torch.float32
    xn = common.apply_norm(cfg, x, p, "ln_rec")
    h0, tail = state["h"], state["conv"]
    if tp is not None:
        xn = tp.copy(xn)
        h0, tail = tp.narrow(h0, -1), tp.narrow(tail, -1)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(xn @ p["rec_in_gate"].to(dtype), approximate="tanh")
    u, new_tail = _conv1d_causal(xn @ p["rec_in_x"].to(dtype), p["rec_conv"].to(dtype),
                                 p["rec_conv_b"].to(dtype), tail)
    r = torch.sigmoid((xn @ p["rec_wa"].to(dtype)).to(f32))
    i = torch.sigmoid((xn @ p["rec_wx"].to(dtype)).to(f32))
    a = torch.exp(-cfg.rglru_c * F.softplus(p["rec_lambda"].to(f32)) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.to(f32))
    h = _rglru_scan(a, bx, h0)
    out = (h.to(dtype) * gate) @ p["rec_out"].to(dtype)
    if tp is not None:
        out = tp.reduce(out)
    return x + out, {"h": h[:, -1, :], "conv": new_tail.to(f32)}


def init_rglru_state(cfg, batch: int, device=None) -> Dict[str, Tensor]:
    D, W = cfg.d_model, cfg.conv_width
    return {"h": torch.zeros((batch, D), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, W - 1, D), dtype=torch.float32, device=device)}
