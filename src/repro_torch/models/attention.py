"""Grouped-query attention: the port of ``repro.models.attention``.
Training and encoding (``attention_train``): causal or not, windowed or not,
self-attention with RoPE or without, and cross-attention over an encoder's
output (never causal, never rotated). Serving: ``init_cache``,
``attention_prefill`` (the full prompt, filling a cache) and
``attention_decode`` (one token against the cache).

Attention is einsum + masked softmax, masked with ``NEG_INF`` exactly as
the reference does. Mixed precision as there: the projections and the two
einsums run in the compute dtype (``dtype``, each weight cast at use), the
scores are cast to fp32 for the scale, mask and softmax, and the weights go
back to the compute dtype; caches hold the compute dtype. ``attention_core`` scans the queries in chunks of
``q_chunk`` = 512 (the reference's default), so at most one chunk's
(B, heads, q_chunk, T) scores exist at a time; in training each chunk's
body is rematerialised (``common.remat``, the reference's
``jax.checkpoint``), so the backward recomputes a chunk's scores instead
of keeping (B, heads, S, T). Prefill runs the same chunks under
``torch.inference_mode`` without remat. The reference pads the last chunk
with position -1 and masks it; the port slices it short, which gives the
real rows the same values. Every query and key position of
``attention_core`` is a real one (>= 0): only the causal and window
conditions mask there.

Cache layout, the reference's: {"k": (B, C, KV, hd), "v": (B, C, KV, hd),
"slot_pos": (C,) int32}, where ``slot_pos[j]`` is the absolute position held
in slot j (-1 = empty). Position p goes to slot p % C, so a cache of the
whole context holds position j in slot j and a window cache is a ring.
Decode masks by ``slot_pos``: empty slots (< 0), later positions and those
outside the window. Prefill and decode write the cache in place (a decode
step copies one token's K/V per layer, not the cache).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import common

Tensor = torch.Tensor

NEG_INF = -1e30

__all__ = ["NEG_INF", "init_attention", "attention_core", "attention_train", "init_cache",
           "attention_prefill", "attention_decode"]


def init_attention(cfg, store: common.ParamStore, stacked: int = 0, prefix: str = "attn"):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    store.dense(f"{prefix}_wq", (D, H * hd), stacked=stacked)
    store.dense(f"{prefix}_wk", (D, KV * hd), stacked=stacked)
    store.dense(f"{prefix}_wv", (D, KV * hd), stacked=stacked)
    store.dense(f"{prefix}_wo", (H * hd, D), stacked=stacked)
    if cfg.qkv_bias:
        store.zeros(f"{prefix}_bq", (H * hd,), stacked=stacked)
        store.zeros(f"{prefix}_bk", (KV * hd,), stacked=stacked)
        store.zeros(f"{prefix}_bv", (KV * hd,), stacked=stacked)


def _project_qkv(cfg, p, x, kv_x, positions, kv_positions, dtype, rope, prefix):
    B, S, _ = x.shape
    T = kv_x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p[f"{prefix}_wq"].to(dtype)
    k = kv_x @ p[f"{prefix}_wk"].to(dtype)
    v = kv_x @ p[f"{prefix}_wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"].to(dtype)
        k = k + p[f"{prefix}_bk"].to(dtype)
        v = v + p[f"{prefix}_bv"].to(dtype)
    q, k, v = q.reshape(B, S, H, hd), k.reshape(B, T, KV, hd), v.reshape(B, T, KV, hd)
    if rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def attention_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                   *, causal: bool, window: Optional[int], q_chunk: int = 512,
                   remat: bool = True) -> Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd); absolute positions (S,)/(T,),
    none negative. Returns (B, S, H, hd).

    Scans the queries in chunks of ``q_chunk`` (the last one sliced short),
    so at most a (B, heads, q_chunk, T) score tensor exists at a time. The
    scores and softmax are fp32, the output ``q``'s dtype. With
    ``remat`` each chunk's body is rematerialised (``common.remat``), so the
    backward recomputes a chunk's scores instead of keeping all of them."""
    S, H, hd = q.shape[1:]
    KV = k.shape[2]
    q_chunk = min(q_chunk, S)

    def body(qc, k, v, qp, k_pos):
        b, c = qc.shape[:2]
        qg = qc.reshape(b, c, KV, H // KV, hd)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).to(torch.float32) * hd**-0.5
        mask = None
        if causal:
            mask = k_pos[None, :] <= qp[:, None]
        if window is not None:
            near = (qp[:, None] - k_pos[None, :]) < window
            mask = near if mask is None else mask & near
        if mask is not None:  # unmasked (an encoder's), no (B, heads, c, T) copy is made
            s = torch.where(mask, s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(qc.dtype)
        return torch.einsum("bkgqt,btkd->bqkgd", w, v).reshape(b, c, H, hd)

    step = common.remat(body) if remat else body
    outs = [step(q[:, s0:s0 + q_chunk], k, v, q_pos[s0:s0 + q_chunk], k_pos)
            for s0 in range(0, S, q_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attention_train(cfg, p, x: Tensor, positions: Tensor, *, dtype: torch.dtype,
                    causal: bool = True,
                    window: Optional[int] = None, kv_x: Optional[Tensor] = None,
                    kv_positions: Optional[Tensor] = None, rope: bool = True,
                    prefix: str = "attn", remat: bool = True) -> Tensor:
    """Full-sequence attention (training, encoding). positions: (S,). With
    ``kv_x`` (B, T, D) and ``kv_positions`` (T,) it is cross-attention: K and V
    come from ``kv_x``, and it is never causal and never rotated. ``remat``
    rematerialises each query chunk (``attention_core``)."""
    cross = kv_x is not None
    kv_src = kv_x if cross else x
    kv_pos = kv_positions if cross else positions
    q, k, v = _project_qkv(cfg, p, x, kv_src, positions, kv_pos, dtype, rope and not cross,
                           prefix)
    out = attention_core(q, k, v, positions, kv_pos, causal=causal and not cross,
                         window=window, remat=remat)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p[f"{prefix}_wo"].to(dtype)


def init_cache(cfg, batch: int, capacity: int, dtype: torch.dtype,
               device=None) -> Dict[str, Tensor]:
    """An empty cache of ``capacity`` slots (``slot_pos`` -1), K and V in
    ``dtype`` (the compute dtype)."""
    kv = (batch, capacity, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "slot_pos": torch.full((capacity,), -1, dtype=torch.int32, device=device)}


def attention_prefill(cfg, p, x: Tensor, positions: Tensor, cache: Dict[str, Tensor], *,
                      dtype: torch.dtype, window: Optional[int] = None, rope: bool = True,
                      prefix: str = "attn") -> Tensor:
    """Full-sequence causal attention over the prompt x (B, S, D), writing the
    last min(C, S) positions' K/V into ``cache`` (capacity C) in place, at
    slots position % C. It runs under ``torch.inference_mode``: the query
    chunks alone bound its scores, with nothing to rematerialise."""
    q, k, v = _project_qkv(cfg, p, x, x, positions, positions, dtype, rope, prefix)
    out = attention_core(q, k, v, positions, positions, causal=True, window=window,
                         remat=False)
    B, S = x.shape[:2]
    C = cache["k"].shape[1]
    keep = min(C, S)
    pos_tail = positions[S - keep:].to(torch.int64)
    slots = torch.remainder(pos_tail, C)
    cache["k"].index_copy_(1, slots, k[:, S - keep:])
    cache["v"].index_copy_(1, slots, v[:, S - keep:])
    cache["slot_pos"].index_copy_(0, slots, pos_tail.to(torch.int32))
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p[f"{prefix}_wo"].to(dtype)


def attention_decode(cfg, p, x: Tensor, pos: int, cache: Dict[str, Tensor], *,
                     dtype: torch.dtype, window: Optional[int] = None, update_cache: bool = True,
                     rope: bool = True, causal: bool = True, prefix: str = "attn") -> Tensor:
    """One token x (B, 1, D) at absolute position ``pos`` (a Python int).

    With ``update_cache`` its K/V go into slot pos % C in place first; with
    ``update_cache=False`` (cross-attention) the cache is read only and
    ``causal=False`` attends to every filled slot (the encoder's memory)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    if update_cache:
        q, k_new, v_new = _project_qkv(cfg, p, x, x, pos_t, pos_t, dtype, rope, prefix)
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        cache["slot_pos"][slot] = pos
    else:
        q = x @ p[f"{prefix}_wq"].to(dtype)
        if cfg.qkv_bias:
            q = q + p[f"{prefix}_bq"].to(dtype)
        q = q.reshape(B, 1, H, hd)
        if rope:
            q = common.apply_rope(q, pos_t, cfg.rope_theta)
    k, v, spos = cache["k"], cache["v"], cache["slot_pos"]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).to(torch.float32) * hd**-0.5
    valid = spos >= 0
    if causal:
        valid = valid & (spos <= pos)
    if window is not None:
        valid = valid & ((pos - spos) < window)
    w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1).to(dtype)
    o = torch.einsum("bkgqt,btkd->bqkgd", w, v).reshape(B, 1, H * hd)
    return o @ p[f"{prefix}_wo"].to(dtype)
