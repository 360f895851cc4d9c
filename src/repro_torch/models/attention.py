"""Grouped-query causal attention for training: the port of
``repro.models.attention`` (``init_attention``, ``_project_qkv``,
``attention_core``, ``attention_train``).

Attention is plain einsum + masked softmax, masked with ``NEG_INF`` exactly
as ``attention_core`` does. The JAX package scans query chunks to bound
memory at long sequence; at the port's training lengths the full
(B, heads, S, S) score tensor is small, so it is computed at once.
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


def _project_qkv(cfg, p, x, positions, prefix):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p[f"{prefix}_wq"]
    k = x @ p[f"{prefix}_wk"]
    v = x @ p[f"{prefix}_wv"]
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"]
        k = k + p[f"{prefix}_bk"]
        v = v + p[f"{prefix}_bv"]
    q = common.apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = common.apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def attention_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                   *, causal: bool, window: Optional[int]) -> Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd); absolute positions (S,)/(T,).
    Returns (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).to(torch.float32) * hd**-0.5
    mask = (k_pos[None, :] >= 0) & (q_pos[:, None] >= 0)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", w, v)
    return o.reshape(B, S, H, hd)


def attention_train(cfg, p, x: Tensor, positions: Tensor, *, causal: bool = True,
                    window: Optional[int] = None, prefix: str = "attn") -> Tensor:
    """Full-sequence causal self-attention with RoPE. positions: (S,)."""
    q, k, v = _project_qkv(cfg, p, x, positions, prefix)
    out = attention_core(q, k, v, positions, positions, causal=causal, window=window)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p[f"{prefix}_wo"]
