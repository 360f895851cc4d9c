"""The dense transformer: ``Model.init`` and ``Model.loss``.

The port of the dense path of ``repro.models.transformer`` (the paper
transformer: layernorm, RoPE, qkv biases, GELU MLP, untied LM head). Block
parameters are stacked on a leading layer axis under ``params["blocks"]``
like the JAX ``ParamStore`` layout; a Python loop over layers takes the place
of ``lax.scan``. Activation checkpointing is not needed at the port's sizes.
Decode, and the MoE / SSM / hybrid / encoder-decoder / VLM families, are not
ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common

Tensor = torch.Tensor

__all__ = ["Model", "build_model"]


def _init_block(cfg: ArchConfig, store: common.ParamStore, stacked: int):
    D, F = cfg.d_model, cfg.d_ff
    common.init_norm(store, "ln_attn", D, stacked=stacked)
    attn.init_attention(cfg, store, stacked=stacked)
    common.init_norm(store, "ln_mlp", D, stacked=stacked)
    common.init_gelu_mlp(store, D, F, stacked=stacked)


def _block_train(cfg, p, x, positions):
    """One block forward: pre-norm attention, then pre-norm GELU MLP."""
    xn = common.apply_norm(x, p, "ln_attn")
    x = x + attn.attention_train(cfg, p, xn, positions, causal=True,
                                 window=cfg.sliding_window)
    xn = common.apply_norm(x, p, "ln_mlp")
    return x + common.gelu_mlp(p, xn)


@dataclasses.dataclass
class Model:
    """A dense transformer computed in float32 (as the JAX CLI trains it)."""

    cfg: ArchConfig
    loss_chunk: int = 512

    def __post_init__(self):
        self.cfg._layer_kinds()  # raises for model families not ported
        if self.cfg.norm != "layernorm":
            raise NotImplementedError(
                f"norm={self.cfg.norm!r}: only the layernorm + GELU-MLP paper "
                f"transformer is ported (ROADMAP Queue 1 item 17, the other archs)"
            )

    def init(self, generator: torch.Generator,
             device: Union[str, torch.device] = "cuda") -> Dict:
        """Random parameters drawn from ``generator``, placed on ``device``."""
        cfg = self.cfg
        store = common.ParamStore(generator, resolve_device(device))
        common.init_embeddings(cfg, store)
        common.init_norm(store, "ln_final", cfg.d_model)
        _init_block(cfg, store.subtree("blocks"), stacked=cfg.n_layers)
        return store.params

    def loss(self, params, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean token cross-entropy of ``batch`` (tokens/labels/mask (B, S))."""
        cfg = self.cfg
        x = common.embed_tokens(params, batch["tokens"])
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        blocks = params["blocks"]
        for layer in range(cfg.n_layers):
            x = _block_train(cfg, {k: v[layer] for k, v in blocks.items()}, x, positions)
        x = common.apply_norm(x, params, "ln_final")
        mask = batch["mask"].to(torch.float32)
        nll = common.chunked_xent(params, x, batch["labels"], mask, self.loss_chunk)
        return nll, {"nll": nll}


def build_model(cfg: ArchConfig, *, loss_chunk: int = 512) -> Model:
    return Model(cfg=cfg, loss_chunk=loss_chunk)
