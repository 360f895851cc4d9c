"""The decoder-only transformers: ``Model.init`` and ``Model.loss``.

The port of the uniform-stack path of ``repro.models.transformer``: the
paper transformer (layernorm, GELU MLP with biases), the RMSNorm / SwiGLU
dense decoders (starcoder2, qwen2.5, phi3-medium, command-r-plus) and the
top-k MoE decoders (phi3.5-moe, kimi-k2), with GQA attention, RoPE and
optional qkv biases. Block parameters are stacked on a leading layer axis
under ``params["blocks"]`` like the JAX ``ParamStore`` layout; a Python loop
over layers takes the place of ``lax.scan``. Activation checkpointing is not
needed at the port's sizes. Decode, and the SSM / hybrid / encoder-decoder /
VLM families, are not ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, moe

Tensor = torch.Tensor

__all__ = ["Model", "build_model", "MOE_LB_COEF", "MOE_Z_COEF"]

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def _init_block(cfg: ArchConfig, store: common.ParamStore, kind: str, stacked: int):
    D, F = cfg.d_model, cfg.d_ff
    common.init_norm(cfg, store, "ln_attn", D, stacked=stacked)
    attn.init_attention(cfg, store, stacked=stacked)
    common.init_norm(cfg, store, "ln_mlp", D, stacked=stacked)
    if kind == "moe":
        moe.init_moe(cfg, store, stacked=stacked)
    elif cfg.norm == "layernorm":  # the paper transformer's GELU MLP
        common.init_gelu_mlp(store, D, F, stacked=stacked)
    else:
        common.init_swiglu(store, D, F, stacked=stacked)


def _block_train(cfg, p, x, positions, kind) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One block forward: pre-norm attention, then the pre-norm MLP (GELU,
    SwiGLU or the MoE FFN). Returns (x, aux); aux is empty but for MoE."""
    xn = common.apply_norm(cfg, x, p, "ln_attn")
    x = x + attn.attention_train(cfg, p, xn, positions, causal=True,
                                 window=cfg.sliding_window)
    xn = common.apply_norm(cfg, x, p, "ln_mlp")
    if kind == "moe":
        h, aux = moe.moe_ffn(cfg, p, xn)
        return x + h, aux
    if "mlp_gate" in p:
        return x + common.swiglu(p, xn), {}
    return x + common.gelu_mlp(p, xn), {}


@dataclasses.dataclass
class Model:
    """A decoder-only transformer computed in float32 (as the JAX CLI trains it)."""

    cfg: ArchConfig
    loss_chunk: int = 512

    def __post_init__(self):
        self.cfg._layer_kinds()  # raises for model families not ported

    def init(self, generator: torch.Generator,
             device: Union[str, torch.device] = "cuda") -> Dict:
        """Random parameters drawn from ``generator``, placed on ``device``."""
        cfg = self.cfg
        store = common.ParamStore(generator, resolve_device(device))
        common.init_embeddings(cfg, store)
        common.init_norm(cfg, store, "ln_final", cfg.d_model)
        _init_block(cfg, store.subtree("blocks"), cfg._layer_kinds()[0], stacked=cfg.n_layers)
        return store.params

    def loss(self, params, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean token cross-entropy of ``batch`` (tokens/labels/mask (B, S)),
        plus ``MOE_LB_COEF`` x the load-balance loss and ``MOE_Z_COEF`` x the
        router z-loss for MoE; the aux dict holds ``nll`` and each MoE aux
        averaged over the layers."""
        cfg = self.cfg
        kind = cfg._layer_kinds()[0]
        x = common.embed_tokens(params, batch["tokens"])
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        blocks = params["blocks"]
        auxs = []
        for layer in range(cfg.n_layers):
            x, aux = _block_train(cfg, {k: v[layer] for k, v in blocks.items()}, x, positions,
                                  kind)
            auxs.append(aux)
        aux_total = {k: torch.mean(torch.stack([a[k] for a in auxs])) for k in auxs[0]}
        x = common.apply_norm(cfg, x, params, "ln_final")
        mask = batch["mask"].to(torch.float32)
        nll = common.chunked_xent(params, x, batch["labels"], mask, self.loss_chunk)
        total = nll
        if "moe_lb_loss" in aux_total:
            total = total + MOE_LB_COEF * aux_total["moe_lb_loss"]
            total = total + MOE_Z_COEF * aux_total["moe_z_loss"]
        aux_total["nll"] = nll
        return total, aux_total


def build_model(cfg: ArchConfig, *, loss_chunk: int = 512) -> Model:
    return Model(cfg=cfg, loss_chunk=loss_chunk)
