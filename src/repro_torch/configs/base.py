"""Architecture configuration: the port's own copy of the decoder-only fields.

Mirrors ``repro.configs.base.ArchConfig`` field by field for what the port's
models read: the dense decoders (layernorm + GELU MLP, or RMSNorm + SwiGLU)
and the top-k MoE decoders. The SSM, hybrid, encoder-decoder and VLM fields
wait for their model families (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyperparameters of a decoder-only transformer.

    arch_type: dense | moe (ssm | hybrid | vlm | audio are not ported)
    """

    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # MoE: n_experts > 0 makes every layer a top-moe_topk MoE FFN
    n_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytical parameter count of the layout the port builds: the
        final norm included, an RMSNorm a scale only."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        total = V * D * (1 if self.tie_embeddings else 2)
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        if self.n_experts:  # E SwiGLU experts and the router
            mlp = self.n_experts * 3 * D * F + D * self.n_experts
        elif self.norm == "layernorm":  # GELU MLP with biases
            mlp = 2 * D * F + F + D
        else:  # SwiGLU: gate, up, down
            mlp = 3 * D * F
        norms = 4 * D if self.norm == "layernorm" else 2 * D
        final = 2 * D if self.norm == "layernorm" else D
        return total + L * (attn + mlp + norms) + final

    def _layer_kinds(self) -> Tuple[str, ...]:
        if self.arch_type not in ("dense", "moe"):
            raise NotImplementedError(
                f"arch_type {self.arch_type!r}: only the dense and MoE decoders are "
                f"ported (ROADMAP Queue 1 item 17, the other archs)"
            )
        return ("moe" if self.n_experts else "attn",) * self.n_layers
