"""Shared model pieces: parameter init, layernorm and RMSNorm, RoPE and
sinusoidal positions, the GELU and SwiGLU MLPs, embeddings and the chunked
cross-entropy.

The port of ``repro.models.common``. Parameters are
plain nested dicts of tensors with the JAX package's names and stacked
shapes, so a JAX parameter tree carries across (``models.convert``) and the
residue keys match.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = [
    "ParamStore",
    "layernorm",
    "rmsnorm",
    "init_norm",
    "apply_norm",
    "apply_rope",
    "sinusoidal_positions",
    "sinusoidal_positions_at",
    "gelu_mlp",
    "init_swiglu",
    "swiglu",
    "embed_tokens",
    "lm_logits",
    "chunked_xent",
]


class ParamStore:
    """Collects parameters during init, drawing from one explicit generator.

    Normal draws come from ``generator``, on the generator's device, and are
    then moved to ``device``: a CPU generator gives the same values whatever
    the device, a CUDA one draws on the card (no host draws to wait for).
    """

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.gen = generator
        self.device = device
        self.params: Dict[str, object] = {}

    def _full(self, shape, stacked: int):
        return ((stacked,) if stacked else ()) + tuple(shape)

    def dense(self, name, shape, scale: Optional[float] = None, stacked: int = 0):
        """Normal(0, scale) init; scale defaults to 1/sqrt(fan_in)."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in**-0.5
        full = self._full(shape, stacked)
        w = torch.randn(full, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device) * s
        self.params[name] = w.to(self.device)

    def zeros(self, name, shape, stacked: int = 0):
        full = self._full(shape, stacked)
        self.params[name] = torch.zeros(full, dtype=torch.float32, device=self.device)

    def ones(self, name, shape, stacked: int = 0):
        full = self._full(shape, stacked)
        self.params[name] = torch.ones(full, dtype=torch.float32, device=self.device)

    def subtree(self, name: str) -> "ParamStore":
        sub = ParamStore(self.gen, self.device)
        self.params[name] = sub.params
        return sub


def layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """fp32 layernorm with the biased variance, as the JAX package computes it."""
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """fp32 RMSNorm (a scale, no bias), as the JAX package computes it."""
    x = x.to(torch.float32)
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def init_norm(cfg, store: ParamStore, prefix: str, d: int, stacked: int = 0):
    """``cfg.norm``'s parameters: a scale, and for layernorm a bias."""
    store.ones(f"{prefix}_scale", (d,), stacked=stacked)
    if cfg.norm == "layernorm":
        store.zeros(f"{prefix}_bias", (d,), stacked=stacked)


def apply_norm(cfg, x: Tensor, p: Dict[str, Tensor], prefix: str) -> Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"])
    return rmsnorm(x, p[f"{prefix}_scale"])


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding over split halves. x: (..., S, heads, hd); positions: (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions[..., None].to(torch.float32) * freqs  # (S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(seq: int, d: int, device=None) -> Tensor:
    """(seq, d) fp32 table: sin of pos / 10000^(2i/d) in the first half, cos in
    the second, computed in float32 as the reference does."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions_at(pos: int, d: int, device=None) -> Tensor:
    """Row ``pos`` of ``sinusoidal_positions`` as (1, 1, d), bit for bit: the
    same float32 ops on one position. The position is filled on the device,
    so a decode step copies nothing from the host."""
    p = torch.full((1, 1), pos, dtype=torch.float32, device=device)
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = p / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


def init_gelu_mlp(store: ParamStore, d: int, f: int, stacked: int = 0):
    store.dense("mlp_up", (d, f), stacked=stacked)
    store.dense("mlp_down", (f, d), stacked=stacked)
    store.zeros("mlp_up_b", (f,), stacked=stacked)
    store.zeros("mlp_down_b", (d,), stacked=stacked)


def gelu_mlp(p: Dict[str, Tensor], x: Tensor) -> Tensor:
    """GELU MLP with biases; jax.nn.gelu's default is the tanh approximation."""
    h = F.gelu(x @ p["mlp_up"] + p["mlp_up_b"], approximate="tanh")
    return h @ p["mlp_down"] + p["mlp_down_b"]


def init_swiglu(store: ParamStore, d: int, f: int, stacked: int = 0):
    store.dense("mlp_gate", (d, f), stacked=stacked)
    store.dense("mlp_up", (d, f), stacked=stacked)
    store.dense("mlp_down", (f, d), stacked=stacked)


def swiglu(p: Dict[str, Tensor], x: Tensor) -> Tensor:
    """silu(x @ gate) * (x @ up) @ down, no biases."""
    return (F.silu(x @ p["mlp_gate"]) * (x @ p["mlp_up"])) @ p["mlp_down"]


def init_embeddings(cfg, store: ParamStore):
    store.dense("tok_embed", (cfg.vocab, cfg.d_model), scale=1.0)
    if not cfg.tie_embeddings:
        store.dense("lm_head", (cfg.d_model, cfg.vocab))


def embed_tokens(p, tokens: Tensor) -> Tensor:
    return p["tok_embed"][tokens.long()]


def lm_logits(p, x: Tensor) -> Tensor:
    w = p["lm_head"] if "lm_head" in p else p["tok_embed"].T
    return x @ w


def chunked_xent(p, h: Tensor, labels: Tensor, mask: Tensor, chunk: int) -> Tensor:
    """Mean token cross-entropy over sequence chunks of ``chunk`` positions,
    so only (B, chunk, V) logits exist at a time. Divides by sum(mask)."""
    S = h.shape[1]
    chunk = min(chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        logits = lm_logits(p, h[:, s0 : s0 + chunk]).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, s0 : s0 + chunk, None].long())[..., 0]
        total = total + torch.sum((logz - gold) * mask[:, s0 : s0 + chunk])
    return total / torch.clamp(torch.sum(mask), min=1.0)
