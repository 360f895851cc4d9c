"""Every architecture of the registry as one ``Model``: training
(``Model.init``, ``Model.loss``) and serving (``init_decode_state``,
``prefill``, ``decode_step``).

The port of ``repro.models.transformer``:

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
``lax.scan``. Training keeps the reference's memory strategy: with
``Model.remat`` (on by default, as the reference's ``RunConfig.remat``)
each layer of a uniform stack, each encoder and decoder layer and each
whole hybrid unit is rematerialised (``common.remat``, the reference's
``jax.checkpoint``; the hybrid's tail layers are not, as there), so the
backward keeps each layer's inputs and recomputes one layer at a time.
Inside a layer attention scans 512-query chunks and the cross-entropy
``loss_chunk`` positions, each chunk rematerialised too. ``remat=False``
runs the same ops and keeps every activation; the tests hold the two
against each other bit for bit.

Mixed precision is the reference's: ``build_model`` takes
``compute_dtype`` (default ``"bfloat16"``) and ``param_dtype`` (default
``"float32"``), each one of ``"float32"``, ``"bfloat16"``, ``"float16"``.
Parameters are stored in the parameter dtype and cast to the compute dtype
where they are used; the residual stream, the attention caches and the
MoE dispatch are in the compute dtype; the norms, RoPE, the attention and
router softmaxes, the logits of the loss, RWKV-6's decay and recurrence
and the RG-LRU's gates and scan are fp32 islands, and the recurrent states
stay fp32. Under fp32 parameters each gradient is fp32 whatever the
compute dtype.

Serving keeps the reference's decode state, key for key and shape for
shape: ``{"kv"}`` (dense, MoE, VLM: caches stacked on the layer axis),
``{"ssm"}`` (RWKV-6 states stacked), ``{"units", "tail"}`` (the hybrid:
RG-LRU states and window caches stacked per unit position, a list for the
tail) and ``{"self", "cross"}`` (the encoder-decoder's self caches and the
cross caches built from the encoder). Every stacked leaf is a tensor of its
own (the reference's ``broadcast_to`` would be one shared view here), and
prefill and decode write it in place, layer by layer; both run under
``torch.inference_mode``. A decode step's ``pos`` is a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, moe, rglru, rwkv

Tensor = torch.Tensor

__all__ = ["Model", "build_model", "DTYPES", "MOE_LB_COEF", "MOE_Z_COEF"]

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


def _apply_mlp(cfg, p, x, dtype):
    xn = common.apply_norm(cfg, x, p, "ln_mlp")
    if "mlp_gate" in p:
        return x + common.swiglu(p, xn, dtype)
    return x + common.gelu_mlp(p, xn, dtype)


def _block_train(cfg, p, x, positions, kind, *, dtype, window, enc_out=None,
                 enc_pos=None, remat=True) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One block forward in ``dtype``. Returns (x, aux); aux is empty but
    for MoE. ``remat`` rematerialises attention's query chunks."""
    if kind == "ssm":
        state = rwkv.init_rwkv_state(cfg, x.shape[0], x.device)
        x, _ = rwkv.rwkv_block_train(cfg, p, x, state, dtype=dtype)
        return x, {}
    if kind == "rec":
        state = rglru.init_rglru_state(cfg, x.shape[0], x.device)
        x, _ = rglru.rglru_block(cfg, p, x, state, dtype=dtype)
        return _apply_mlp(cfg, p, x, dtype), {}
    xn = common.apply_norm(cfg, x, p, "ln_attn")
    x = x + attn.attention_train(cfg, p, xn, positions, dtype=dtype, causal=kind != "enc",
                                 window=window,
                                 rope=kind not in ("enc", "encdec_dec"),  # enc-dec: sinusoidal
                                 remat=remat)
    if kind == "encdec_dec":
        xn = common.apply_norm(cfg, x, p, "ln_cross")
        x = x + attn.attention_train(cfg, p, xn, positions, dtype=dtype, kv_x=enc_out,
                                     kv_positions=enc_pos, prefix="cross", remat=remat)
    if kind == "moe":
        h, aux = moe.moe_ffn(cfg, p, common.apply_norm(cfg, x, p, "ln_mlp"), dtype=dtype)
        return x + h, aux
    return _apply_mlp(cfg, p, x, dtype), {}


def _layer(stacked: Dict, i: int) -> Dict:
    """Layer ``i`` of a tree of layer-stacked tensors (views: a write into
    one goes into the stack)."""
    return tree.tree_map(lambda v: v[i], stacked)


def _stack(n: int, one: Dict) -> Dict:
    """``one`` stacked ``n`` times on a new leading axis, each leaf a new
    tensor: the reference's ``broadcast_to``, made real so that each layer
    writes its own slots."""
    return tree.tree_map(
        lambda x: x.expand((n,) + x.shape).clone(memory_format=torch.contiguous_format), one)


def _copy_into(dst: Dict, src: Dict) -> None:
    """Write the tree ``src`` into the tree of tensors (or views) ``dst``."""
    tree.tree_map(lambda d, s: d.copy_(s), dst, src)


def _hybrid_units(cfg) -> Tuple[int, Tuple[str, ...]]:
    """(whole pattern units, the kinds of the layers left over)."""
    n_units = cfg.n_layers // len(cfg.hybrid_pattern)
    return n_units, cfg._layer_kinds()[n_units * len(cfg.hybrid_pattern):]


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(name: str, what: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"{what} must be one of {', '.join(map(repr, DTYPES))}, got {name!r}")
    return DTYPES[name]


@dataclasses.dataclass
class Model:
    """A model of the registry: parameters in ``param_dtype``, computed in
    ``compute_dtype`` with the reference's fp32 islands (the module
    docstring); by default bf16 compute over fp32 parameters, as the
    reference's ``Model``."""

    cfg: ArchConfig
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    loss_chunk: int = 512
    decode_window: Optional[int] = None  # caps the dense decoders' caches to a ring (long_500k)
    remat: bool = True  # the reference's RunConfig.remat; False keeps every activation (tests)

    def init(self, generator: torch.Generator,
             device: Union[str, torch.device] = "cuda") -> Dict:
        """Random parameters drawn from ``generator`` in fp32, placed on
        ``device`` in ``param_dtype`` (``common.ParamStore``)."""
        cfg = self.cfg
        store = common.ParamStore(generator, resolve_device(device), self.param_dtype)
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
        dt = self.compute_dtype
        x = common.embed_tokens(params, batch["tokens"], dt)
        labels, mask = batch["labels"], batch["mask"].to(torch.float32)
        if self.cfg.arch_type == "vlm":
            vis = batch["vision"].to(dt)  # (B, Tv, D) stub patch embeddings
            x = torch.cat([vis, x], dim=1)
            labels = torch.cat([torch.zeros(vis.shape[:2], dtype=labels.dtype,
                                            device=x.device), labels], dim=1)
            mask = torch.cat([torch.zeros(vis.shape[:2], dtype=torch.float32, device=x.device),
                              mask], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        return x, positions, labels, mask

    def _step(self, body):
        """``body`` as one layer of a training pass: rematerialised
        (``common.remat``, the reference's ``jax.checkpoint``) with
        ``remat``, else as it is."""
        return common.remat(body) if self.remat else body

    def _encode(self, params, frames: Tensor) -> Tuple[Tensor, Tensor]:
        """The Whisper encoder over stub frame embeddings. frames: (B, T, D)."""
        cfg, dt = self.cfg, self.compute_dtype
        T = frames.shape[1]
        x = frames.to(dt) + common.sinusoidal_positions(T, cfg.d_model, frames.device).to(dt)
        pos = torch.arange(T, dtype=torch.int32, device=frames.device)
        ep = params["encoder"]
        layers = {k: v for k, v in ep.items() if not k.startswith("ln_enc_final")}
        step = self._step(lambda pl, x, pos: _block_train(cfg, pl, x, pos, "enc", dtype=dt,
                                                          window=None, remat=self.remat)[0])
        for i in range(cfg.encoder_layers):
            x = step(_layer(layers, i), x, pos)
        return common.apply_norm(cfg, x, ep, "ln_enc_final"), pos

    def loss(self, params, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean token cross-entropy of ``batch`` (tokens/labels/mask (B, S); a
        VLM's ``vision`` (B, Tv, D), an encoder-decoder's ``frames`` (B, T, D)),
        plus ``MOE_LB_COEF`` x the load-balance loss and ``MOE_Z_COEF`` x the
        router z-loss for MoE; the aux dict holds ``nll`` and each MoE aux
        averaged over the layers.

        With ``remat`` each layer (each whole hybrid unit; the hybrid's tail
        layers are not) is rematerialised, as are attention's query chunks
        and the cross-entropy's chunks, where the reference checkpoints."""
        cfg, dt = self.cfg, self.compute_dtype
        remat = self.remat
        auxs = []
        if cfg.is_encdec:
            enc_out, enc_pos = self._encode(params, batch["frames"])
            x = common.embed_tokens(params, batch["tokens"], dt)
            x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(dt)
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
            labels, mask = batch["labels"], batch["mask"].to(torch.float32)
            step = self._step(lambda pl, x, positions, enc_out, enc_pos: _block_train(
                cfg, pl, x, positions, "encdec_dec", dtype=dt, window=cfg.sliding_window,
                enc_out=enc_out, enc_pos=enc_pos, remat=remat)[0])
            for i in range(cfg.n_layers):
                # each layer reads enc_out through a view of its own, so its K and V
                # cotangents are summed before they join the other layers', with
                # remat or without (and as the reference's scan sums them)
                x = step(_layer(params["decoder"], i), x, positions, enc_out.view_as(enc_out),
                         enc_pos)
        else:
            x, positions, labels, mask = self._embed_inputs(params, batch)
            if cfg.arch_type == "hybrid":
                n_units, tail_kinds = _hybrid_units(cfg)

                def unit(up, x, positions):
                    for pos, kind in enumerate(cfg.hybrid_pattern):
                        x, _ = _block_train(cfg, up[f"u{pos}_{kind}"], x, positions, kind,
                                            dtype=dt, window=self._window(kind), remat=remat)
                    return x

                step = self._step(unit)
                for u in range(n_units):
                    x = step(_layer(params["units"], u), x, positions)
                for i, kind in enumerate(tail_kinds):
                    x, _ = _block_train(cfg, params["tail"][f"layer_{i}_{kind}"], x, positions,
                                        kind, dtype=dt, window=self._window(kind), remat=remat)
            else:
                kind = cfg._layer_kinds()[0]
                step = self._step(lambda pl, x, positions: list(_block_train(
                    cfg, pl, x, positions, kind, dtype=dt, window=self._window(kind),
                    remat=remat)))
                for i in range(cfg.n_layers):
                    x, aux = step(_layer(params["blocks"], i), x, positions)
                    auxs.append(aux)
        aux_total = {k: torch.mean(torch.stack([a[k] for a in auxs])) for k in
                     (auxs[0] if auxs else ())}
        x = common.apply_norm(cfg, x, params, "ln_final")
        nll = common.chunked_xent(params, x, labels, mask, self.loss_chunk, dt, remat=remat)
        total = nll
        if "moe_lb_loss" in aux_total:
            total = total + MOE_LB_COEF * aux_total["moe_lb_loss"]
            total = total + MOE_Z_COEF * aux_total["moe_z_loss"]
        aux_total["nll"] = nll
        return total, aux_total

    # ---------------- serving ----------------

    def _cache_capacity(self, seq_len: int, kind: str) -> int:
        window = self.decode_window or self._window(kind)
        return seq_len if window is None else min(seq_len, window)

    def _self_caches(self, batch: int, seq_len: int, device) -> Dict:
        """The encoder-decoder's stacked self-attention caches."""
        cap = self._cache_capacity(seq_len, "attn")
        return _stack(self.cfg.n_layers,
                      attn.init_cache(self.cfg, batch, cap, self.compute_dtype, device))

    @torch.inference_mode()
    def init_decode_state(self, batch: int, seq_len: int,
                          device: Union[str, torch.device] = "cuda") -> Dict:
        """Empty decode state for a ``seq_len`` context on ``device``: the
        caches in the compute dtype, the recurrent states in fp32."""
        cfg, dt = self.cfg, self.compute_dtype
        dev = resolve_device(device)
        if cfg.is_encdec:
            cross = attn.init_cache(cfg, batch, cfg.encoder_seq, dt, dev)
            return {"self": self._self_caches(batch, seq_len, dev),
                    "cross": _stack(cfg.n_layers, cross)}
        if cfg.arch_type == "ssm":
            return {"ssm": _stack(cfg.n_layers, rwkv.init_rwkv_state(cfg, batch, dev))}
        if cfg.arch_type == "hybrid":
            n_units, tail_kinds = _hybrid_units(cfg)

            def one(kind):
                if kind == "rec":
                    return rglru.init_rglru_state(cfg, batch, dev)
                return attn.init_cache(cfg, batch, self._cache_capacity(seq_len, kind), dt, dev)

            return {"units": {f"u{pos}_{kind}": _stack(n_units, one(kind))
                              for pos, kind in enumerate(cfg.hybrid_pattern)},
                    "tail": [one(kind) for kind in tail_kinds]}
        cap = self._cache_capacity(seq_len, cfg._layer_kinds()[0])
        return {"kv": _stack(cfg.n_layers, attn.init_cache(cfg, batch, cap, dt, dev))}

    def _serve_layers(self, params, x: Tensor, state: Dict, *, positions: Optional[Tensor] = None,
                      pos: Optional[int] = None) -> Tensor:
        """The layers over a prompt at ``positions`` (prefill) or over one
        token at ``pos`` (a decode step), writing ``state`` in place."""
        cfg, dt = self.cfg, self.compute_dtype
        decoding = pos is not None

        def self_attn(pl, xn, cache, window, rope=True):
            if decoding:
                return attn.attention_decode(cfg, pl, xn, pos, cache, dtype=dt, window=window,
                                             rope=rope)
            return attn.attention_prefill(cfg, pl, xn, positions, cache, dtype=dt, window=window,
                                          rope=rope)

        def recurrent(block, pl, x, st):
            x, new = block(cfg, pl, x, st, dtype=dt)
            _copy_into(st, new)
            return x

        if cfg.is_encdec:
            # as the reference: prefill windows with sliding_window, decode with
            # decode_window or sliding_window; no RoPE (sinusoidal positions)
            window = (self.decode_window or cfg.sliding_window) if decoding else cfg.sliding_window
            for i in range(cfg.n_layers):
                pl, cross = _layer(params["decoder"], i), _layer(state["cross"], i)
                x = x + self_attn(pl, common.apply_norm(cfg, x, pl, "ln_attn"),
                                  _layer(state["self"], i), window, rope=False)
                xn = common.apply_norm(cfg, x, pl, "ln_cross")
                if decoding:
                    h = attn.attention_decode(cfg, pl, xn, pos, cross, dtype=dt,
                                              update_cache=False, rope=False, causal=False,
                                              prefix="cross")
                else:
                    h = _cross_read(cfg, pl, xn, positions, cross, dt)
                x = _apply_mlp(cfg, pl, x + h, dt)
        elif cfg.arch_type == "ssm":
            block = rwkv.rwkv_block_decode if decoding else rwkv.rwkv_block_train
            for i in range(cfg.n_layers):
                x = recurrent(block, _layer(params["blocks"], i), x, _layer(state["ssm"], i))
        elif cfg.arch_type == "hybrid":
            n_units, tail_kinds = _hybrid_units(cfg)

            def layer(pl, x, st, kind):
                if kind == "rec":
                    return _apply_mlp(cfg, pl, recurrent(rglru.rglru_block, pl, x, st), dt)
                # the window is local_window, the cache _cache_capacity's
                h = self_attn(pl, common.apply_norm(cfg, x, pl, "ln_attn"), st, self._window(kind))
                return _apply_mlp(cfg, pl, x + h, dt)

            for u in range(n_units):
                for p_, kind in enumerate(cfg.hybrid_pattern):
                    key = f"u{p_}_{kind}"
                    x = layer(_layer(params["units"][key], u), x,
                              _layer(state["units"][key], u), kind)
            for i, kind in enumerate(tail_kinds):
                x = layer(params["tail"][f"layer_{i}_{kind}"], x, state["tail"][i], kind)
        else:
            kind = cfg._layer_kinds()[0]
            window = self.decode_window or self._window(kind)
            for i in range(cfg.n_layers):
                pl = _layer(params["blocks"], i)
                x = x + self_attn(pl, common.apply_norm(cfg, x, pl, "ln_attn"),
                                  _layer(state["kv"], i), window)
                if kind == "moe":
                    h, _ = moe.moe_ffn(cfg, pl, common.apply_norm(cfg, x, pl, "ln_mlp"), dtype=dt)
                    x = x + h
                else:
                    x = _apply_mlp(cfg, pl, x, dt)
        return x

    @torch.inference_mode()
    def prefill(self, params, batch, seq_len: int) -> Tuple[Tensor, Dict]:
        """Run the prompt ``batch["tokens"]`` (B, S) (with a VLM's ``vision``,
        an encoder-decoder's ``frames``) and return the last position's
        logits (B, V) and the decode state for a ``seq_len`` context."""
        cfg, dt = self.cfg, self.compute_dtype
        x = common.embed_tokens(params, batch["tokens"], dt)
        B, dev = x.shape[0], x.device
        if cfg.arch_type == "vlm":
            x = torch.cat([batch["vision"].to(dt), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
        if cfg.is_encdec:
            enc_out, enc_pos = self._encode(params, batch["frames"])
            x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model, dev).to(dt)
            state = {"self": self._self_caches(B, seq_len, dev),
                     "cross": _build_cross_caches(cfg, params["decoder"], enc_out, enc_pos, dt)}
        else:
            state = self.init_decode_state(B, seq_len, dev)
        x = self._serve_layers(params, x, state, positions=positions)
        x = common.apply_norm(cfg, x, params, "ln_final")
        return common.lm_logits(params, x[:, -1:, :], dt)[:, 0, :], state

    @torch.inference_mode()
    def decode_step(self, params, state: Dict, token: Tensor, pos: int) -> Tuple[Tensor, Dict]:
        """One token (B,) at absolute position ``pos`` (a Python int): the
        logits (B, V) and ``state``, written in place."""
        cfg, dt = self.cfg, self.compute_dtype
        x = common.embed_tokens(params, token[:, None], dt)  # (B, 1, D)
        if cfg.is_encdec:
            x = x + common.sinusoidal_positions_at(pos, cfg.d_model, x.device).to(dt)
        x = self._serve_layers(params, x, state, pos=pos)
        x = common.apply_norm(cfg, x, params, "ln_final")
        return common.lm_logits(params, x, dt)[:, 0, :], state


def _build_cross_caches(cfg, dec_params, enc_out: Tensor, enc_pos: Tensor, dtype) -> Dict:
    """Each decoder layer's cross K/V of the encoder output, in ``dtype``,
    stacked on the layer axis (the slots hold the encoder positions)."""
    B, T = enc_out.shape[:2]
    KV, hd = cfg.n_kv_heads, cfg.hd
    ks, vs = [], []
    for i in range(cfg.n_layers):
        pl = _layer(dec_params, i)
        k, v = enc_out @ pl["cross_wk"].to(dtype), enc_out @ pl["cross_wv"].to(dtype)
        if cfg.qkv_bias:
            k, v = k + pl["cross_bk"].to(dtype), v + pl["cross_bv"].to(dtype)
        ks.append(k.reshape(B, T, KV, hd))
        vs.append(v.reshape(B, T, KV, hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs),
            "slot_pos": _stack(cfg.n_layers, enc_pos.to(torch.int32))}


def _cross_read(cfg, pl, xn: Tensor, positions: Tensor, crossc: Dict, dtype) -> Tensor:
    """Full-sequence cross-attention against a layer's cross cache."""
    B, S, _ = xn.shape
    q = xn @ pl["cross_wq"].to(dtype)
    if cfg.qkv_bias:
        q = q + pl["cross_bq"].to(dtype)
    out = attn.attention_core(q.reshape(B, S, cfg.n_heads, cfg.hd), crossc["k"], crossc["v"],
                              positions, crossc["slot_pos"], causal=False, window=None,
                              remat=False)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ pl["cross_wo"].to(dtype)


def build_model(cfg: ArchConfig, *, compute_dtype: str = "bfloat16", param_dtype: str = "float32",
                loss_chunk: int = 512, decode_window: Optional[int] = None,
                remat: bool = True) -> Model:
    """The reference's ``build_model``: dtypes by name (``DTYPES``), bf16
    compute over fp32 parameters by default; an unknown name raises."""
    return Model(cfg=cfg, compute_dtype=_dtype(compute_dtype, "compute_dtype"),
                 param_dtype=_dtype(param_dtype, "param_dtype"), loss_chunk=loss_chunk,
                 decode_window=decode_window, remat=remat)
