"""Architecture configuration: the port's own copy of ``repro.configs.base.ArchConfig``.

Mirrors the reference's dataclass field by field: the dense decoders
(layernorm + GELU MLP, or RMSNorm + SwiGLU), the top-k MoE decoders, the
RWKV-6 SSM, the RecurrentGemma hybrid (RG-LRU blocks and local attention),
the Whisper encoder-decoder and the InternVL2 vision prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyperparameters (transformer backbone granularity).

    arch_type: dense | moe | ssm | hybrid | vlm | audio
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
    sliding_window: Optional[int] = None  # applied to every attention layer if set
    # hybrid (RecurrentGemma): the repeating block pattern, e.g. ("rec", "rec", "attn")
    hybrid_pattern: Tuple[str, ...] = ()
    local_window: int = 2048  # the hybrid's local-attention window
    conv_width: int = 4  # temporal conv in the recurrent blocks
    rglru_c: float = 8.0
    # ssm (RWKV6)
    ssm_head_dim: int = 64
    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # stub frame-embedding count
    # vlm: stub patch-embedding count prepended to the text
    vision_tokens: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Parameters of the layout the port builds (the reference's abstract
        init, leaf for leaf): the final norms included, an RMSNorm a scale
        only. The reference's own ``param_count`` is approximate for the
        SSM, hybrid and encoder-decoder families and leaves out the final
        norm (ROADMAP Queue 3)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        norm = 2 * D if self.norm == "layernorm" else D
        total = V * D * (1 if self.tie_embeddings else 2) + norm  # embeddings, final norm
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        if self.n_experts:  # E SwiGLU experts and the router
            mlp = self.n_experts * 3 * D * F + D * self.n_experts
        elif self.norm == "layernorm":  # GELU MLP with biases
            mlp = 2 * D * F + F + D
        else:  # SwiGLU: gate, up, down
            mlp = 3 * D * F
        per_kind = {
            "attn": attn + mlp + 2 * norm,
            "moe": attn + mlp + 2 * norm,
            # RWKV-6: r, k, v, g, o and the channel-mix r (6 D^2), the channel
            # mix's k and v, five ddlerp adapters and the decay's (64 wide),
            # and per-channel mixers, decay base, bonus and group-norm scale
            "ssm": 6 * D * D + 2 * D * F + 12 * 64 * D + 10 * D + 2 * norm,
            # RG-LRU: in_gate, in_x, wa, wx, out (5 D^2), the conv and its
            # bias, lambda; then the SwiGLU MLP
            "rec": 5 * D * D + self.conv_width * D + 2 * D + mlp + 2 * norm,
        }
        total += sum(per_kind[k] for k in self._layer_kinds())
        if self.is_encdec:  # encoder layers and their final norm; cross-attention
            total += self.encoder_layers * per_kind["attn"] + norm + L * (attn + norm)
        return total

    def _layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds: the hybrid's pattern cut to n_layers; uniform otherwise."""
        if self.arch_type == "hybrid" and self.hybrid_pattern:
            reps = -(-self.n_layers // len(self.hybrid_pattern))
            return tuple((self.hybrid_pattern * reps)[: self.n_layers])
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        if self.n_experts:
            return ("moe",) * self.n_layers
        return ("attn",) * self.n_layers
