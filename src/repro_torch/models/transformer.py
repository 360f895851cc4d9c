"""Every architecture of the registry as one ``Model``: ``Model.init`` and ``Model.loss``.

The port of the training path of ``repro.models.transformer``:

  * the uniform stacks under ``params["blocks"]``: the paper transformer
    (layernorm, GELU MLP with biases), the RMSNorm / SwiGLU dense decoders,
    the top-k MoE decoders, the RWKV-6 SSM (``models.rwkv``) and the VLM
    decoder, whose stub vision embeddings are prepended to the text with
    labels 0 and mask 0;
  * the hybrid (RecurrentGemma): whole ``hybrid_pattern`` units stacked under
    ``params["units"]["u{pos}_{kind}"]``, the layers left over un-stacked
    under ``params["tail"]["layer_{i}_{kind}"]``; ``rec`` layers are an
    RG-LRU block (``models.rglru``, residual inside) then the SwiGLU MLP,
    ``attn`` layers attend within ``local_window``;
  * the encoder-decoder (Whisper): an ``["encoder"]`` stack over stub frame
    embeddings, not causal, with its final norm inside the subtree, and a
    ``["decoder"]`` stack with cross-attention; both take sinusoidal
    positions and no RoPE.

Block parameters are stacked on a leading layer axis like the JAX
``ParamStore`` layout; a Python loop over layers takes the place of
``lax.scan``. Activation checkpointing is not needed at the port's sizes.
Decode is not ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, moe, rglru, rwkv

Tensor = torch.Tensor

__all__ = ["Model", "build_model", "MOE_LB_COEF", "MOE_Z_COEF"]

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def _init_block(cfg: ArchConfig, store: common.ParamStore, kind: str, stacked: int):
    D, F = cfg.d_model, cfg.d_ff
    if kind == "ssm":
        rwkv.init_rwkv_block(cfg, store, stacked=stacked)
        return
    if kind == "rec":
        rglru.init_rglru_block(cfg, store, stacked=stacked)
        common.init_norm(cfg, store, "ln_mlp", D, stacked=stacked)
        common.init_swiglu(store, D, F, stacked=stacked)
        return
    # attention-bearing kinds
    common.init_norm(cfg, store, "ln_attn", D, stacked=stacked)
    attn.init_attention(cfg, store, stacked=stacked)
    if kind == "encdec_dec":
        common.init_norm(cfg, store, "ln_cross", D, stacked=stacked)
        attn.init_attention(cfg, store, stacked=stacked, prefix="cross")
    common.init_norm(cfg, store, "ln_mlp", D, stacked=stacked)
    if kind == "moe":
        moe.init_moe(cfg, store, stacked=stacked)
    elif cfg.norm == "layernorm":  # the paper transformer's and Whisper's GELU MLP
        common.init_gelu_mlp(store, D, F, stacked=stacked)
    else:
        common.init_swiglu(store, D, F, stacked=stacked)


def _apply_mlp(cfg, p, x):
    xn = common.apply_norm(cfg, x, p, "ln_mlp")
    if "mlp_gate" in p:
        return x + common.swiglu(p, xn)
    return x + common.gelu_mlp(p, xn)


def _block_train(cfg, p, x, positions, kind, *, window, enc_out=None,
                 enc_pos=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One block forward. Returns (x, aux); aux is empty but for MoE."""
    if kind == "ssm":
        state = rwkv.init_rwkv_state(cfg, x.shape[0], x.device)
        x, _ = rwkv.rwkv_block_train(cfg, p, x, state)
        return x, {}
    if kind == "rec":
        state = rglru.init_rglru_state(cfg, x.shape[0], x.device)
        x, _ = rglru.rglru_block(cfg, p, x, state)
        return _apply_mlp(cfg, p, x), {}
    xn = common.apply_norm(cfg, x, p, "ln_attn")
    x = x + attn.attention_train(cfg, p, xn, positions, causal=kind != "enc", window=window,
                                 rope=kind not in ("enc", "encdec_dec"))  # enc-dec: sinusoidal
    if kind == "encdec_dec":
        xn = common.apply_norm(cfg, x, p, "ln_cross")
        x = x + attn.attention_train(cfg, p, xn, positions, kv_x=enc_out, kv_positions=enc_pos,
                                     prefix="cross")
    if kind == "moe":
        h, aux = moe.moe_ffn(cfg, p, common.apply_norm(cfg, x, p, "ln_mlp"))
        return x + h, aux
    return _apply_mlp(cfg, p, x), {}


def _layer(stacked: Dict[str, Tensor], i: int) -> Dict[str, Tensor]:
    """Layer ``i`` of a stack of layer-stacked parameters."""
    return {k: v[i] for k, v in stacked.items()}


def _hybrid_units(cfg) -> Tuple[int, Tuple[str, ...]]:
    """(whole pattern units, the kinds of the layers left over)."""
    n_units = cfg.n_layers // len(cfg.hybrid_pattern)
    return n_units, cfg._layer_kinds()[n_units * len(cfg.hybrid_pattern):]


@dataclasses.dataclass
class Model:
    """A model of the registry computed in float32 (as the JAX CLI trains it)."""

    cfg: ArchConfig
    loss_chunk: int = 512

    def init(self, generator: torch.Generator,
             device: Union[str, torch.device] = "cuda") -> Dict:
        """Random parameters drawn from ``generator``, placed on ``device``."""
        cfg = self.cfg
        store = common.ParamStore(generator, resolve_device(device))
        common.init_embeddings(cfg, store)
        common.init_norm(cfg, store, "ln_final", cfg.d_model)
        if cfg.is_encdec:
            enc = store.subtree("encoder")
            _init_block(cfg, enc, "enc", stacked=cfg.encoder_layers)
            common.init_norm(cfg, enc, "ln_enc_final", cfg.d_model)
            _init_block(cfg, store.subtree("decoder"), "encdec_dec", stacked=cfg.n_layers)
        elif cfg.arch_type == "hybrid":
            n_units, tail_kinds = _hybrid_units(cfg)
            units = store.subtree("units")
            for pos, kind in enumerate(cfg.hybrid_pattern):
                _init_block(cfg, units.subtree(f"u{pos}_{kind}"), kind, stacked=n_units)
            tail = store.subtree("tail")
            for i, kind in enumerate(tail_kinds):
                _init_block(cfg, tail.subtree(f"layer_{i}_{kind}"), kind, stacked=0)
        else:
            _init_block(cfg, store.subtree("blocks"), cfg._layer_kinds()[0],
                        stacked=cfg.n_layers)
        return store.params

    def _window(self, kind: str) -> Optional[int]:
        cfg = self.cfg
        if kind == "attn" and cfg.arch_type == "hybrid":
            return cfg.local_window
        return cfg.sliding_window

    def _embed_inputs(self, params, batch) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(hidden, positions, labels, mask), a VLM's vision prefix prepended."""
        x = common.embed_tokens(params, batch["tokens"])
        labels, mask = batch["labels"], batch["mask"].to(torch.float32)
        if self.cfg.arch_type == "vlm":
            vis = batch["vision"].to(torch.float32)  # (B, Tv, D) stub patch embeddings
            x = torch.cat([vis, x], dim=1)
            labels = torch.cat([torch.zeros(vis.shape[:2], dtype=labels.dtype,
                                            device=x.device), labels], dim=1)
            mask = torch.cat([torch.zeros(vis.shape[:2], dtype=torch.float32, device=x.device),
                              mask], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        return x, positions, labels, mask

    def _encode(self, params, frames: Tensor) -> Tuple[Tensor, Tensor]:
        """The Whisper encoder over stub frame embeddings. frames: (B, T, D)."""
        cfg = self.cfg
        T = frames.shape[1]
        x = frames.to(torch.float32) + common.sinusoidal_positions(T, cfg.d_model, frames.device)
        pos = torch.arange(T, dtype=torch.int32, device=frames.device)
        ep = params["encoder"]
        layers = {k: v for k, v in ep.items() if not k.startswith("ln_enc_final")}
        for i in range(cfg.encoder_layers):
            x, _ = _block_train(cfg, _layer(layers, i), x, pos, "enc", window=None)
        return common.apply_norm(cfg, x, ep, "ln_enc_final"), pos

    def loss(self, params, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean token cross-entropy of ``batch`` (tokens/labels/mask (B, S); a
        VLM's ``vision`` (B, Tv, D), an encoder-decoder's ``frames`` (B, T, D)),
        plus ``MOE_LB_COEF`` x the load-balance loss and ``MOE_Z_COEF`` x the
        router z-loss for MoE; the aux dict holds ``nll`` and each MoE aux
        averaged over the layers."""
        cfg = self.cfg
        auxs = []
        if cfg.is_encdec:
            enc_out, enc_pos = self._encode(params, batch["frames"])
            x = common.embed_tokens(params, batch["tokens"])
            x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
            labels, mask = batch["labels"], batch["mask"].to(torch.float32)
            for i in range(cfg.n_layers):
                x, _ = _block_train(cfg, _layer(params["decoder"], i), x, positions,
                                    "encdec_dec", window=cfg.sliding_window, enc_out=enc_out,
                                    enc_pos=enc_pos)
        else:
            x, positions, labels, mask = self._embed_inputs(params, batch)
            if cfg.arch_type == "hybrid":
                n_units, tail_kinds = _hybrid_units(cfg)
                for u in range(n_units):
                    for pos, kind in enumerate(cfg.hybrid_pattern):
                        x, _ = _block_train(cfg, _layer(params["units"][f"u{pos}_{kind}"], u),
                                            x, positions, kind, window=self._window(kind))
                for i, kind in enumerate(tail_kinds):
                    x, _ = _block_train(cfg, params["tail"][f"layer_{i}_{kind}"], x, positions,
                                        kind, window=self._window(kind))
            else:
                kind = cfg._layer_kinds()[0]
                for i in range(cfg.n_layers):
                    x, aux = _block_train(cfg, _layer(params["blocks"], i), x, positions, kind,
                                          window=self._window(kind))
                    auxs.append(aux)
        aux_total = {k: torch.mean(torch.stack([a[k] for a in auxs])) for k in
                     (auxs[0] if auxs else ())}
        x = common.apply_norm(cfg, x, params, "ln_final")
        nll = common.chunked_xent(params, x, labels, mask, self.loss_chunk)
        total = nll
        if "moe_lb_loss" in aux_total:
            total = total + MOE_LB_COEF * aux_total["moe_lb_loss"]
            total = total + MOE_Z_COEF * aux_total["moe_z_loss"]
        aux_total["nll"] = nll
        return total, aux_total


def build_model(cfg: ArchConfig, *, loss_chunk: int = 512) -> Model:
    return Model(cfg=cfg, loss_chunk=loss_chunk)
