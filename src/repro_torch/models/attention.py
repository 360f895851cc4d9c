"""Grouped-query attention for training: the port of
``repro.models.attention`` (``init_attention``, ``_project_qkv``,
``attention_core``, ``attention_train``): causal or not, windowed or not,
self-attention with RoPE or without, and cross-attention over an encoder's
output (never causal, never rotated).

Attention is plain einsum + masked softmax, masked with ``NEG_INF`` exactly
as ``attention_core`` does. The JAX package scans query chunks to bound
memory at long sequence; at the port's training lengths the full
(B, heads, S, T) score tensor fits, so it is computed at once. The port
pads no query chunk and keeps no cache, so every position is a real one
(>= 0) and only the causal and window conditions mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common

Tensor = torch.Tensor

NEG_INF = -1e30

__all__ = ["NEG_INF", "init_attention", "attention_core", "attention_train"]


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


def _project_qkv(cfg, p, x, kv_x, positions, kv_positions, rope, prefix):
    B, S, _ = x.shape
    T = kv_x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p[f"{prefix}_wq"]
    k = kv_x @ p[f"{prefix}_wk"]
    v = kv_x @ p[f"{prefix}_wv"]
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"]
        k = k + p[f"{prefix}_bk"]
        v = v + p[f"{prefix}_bv"]
    q, k, v = q.reshape(B, S, H, hd), k.reshape(B, T, KV, hd), v.reshape(B, T, KV, hd)
    if rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def attention_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                   *, causal: bool, window: Optional[int]) -> Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd); absolute positions (S,)/(T,),
    none negative. Returns (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).to(torch.float32) * hd**-0.5
    mask = None
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        near = (q_pos[:, None] - k_pos[None, :]) < window
        mask = near if mask is None else mask & near
    if mask is not None:  # unmasked (an encoder's), no (B, heads, S, T) copy is made
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w, v)
    return o.reshape(B, S, H, hd)


def attention_train(cfg, p, x: Tensor, positions: Tensor, *, causal: bool = True,
                    window: Optional[int] = None, kv_x: Optional[Tensor] = None,
                    kv_positions: Optional[Tensor] = None, rope: bool = True,
                    prefix: str = "attn") -> Tensor:
    """Full-sequence attention (training, encoding). positions: (S,). With
    ``kv_x`` (B, T, D) and ``kv_positions`` (T,) it is cross-attention: K and V
    come from ``kv_x``, and it is never causal and never rotated."""
    cross = kv_x is not None
    kv_src = kv_x if cross else x
    kv_pos = kv_positions if cross else positions
    q, k, v = _project_qkv(cfg, p, x, kv_src, positions, kv_pos, rope and not cross, prefix)
    out = attention_core(q, k, v, positions, kv_pos, causal=causal and not cross,
                         window=window)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p[f"{prefix}_wo"]
