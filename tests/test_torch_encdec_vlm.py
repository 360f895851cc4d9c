"""repro_torch's Whisper encoder-decoder and InternVL2 vision-prefixed decoder
against ``repro.models``.

whisper-medium at its SMOKE width, as the reference computes it: stub frame
embeddings plus sinusoidal positions through an ``["encoder"]`` stack (not
causal, no RoPE, its final norm inside the subtree), then a ``["decoder"]``
stack with sinusoidal positions, causal self-attention without RoPE and
cross-attention over the encoder's output (never causal, never rotated;
K and V have the encoder's length). LayerNorm, GELU MLPs and qkv biases.
internvl2-26b: the RMSNorm / SwiGLU GQA decoder with ``vision_tokens`` stub
patch embeddings prepended, their labels 0 and mask 0. The configs equal the
reference's field by field and count what its abstract init builds, full
width included; the batches equal the reference's bit for bit. From
JAX-initialised parameters (every constant-initialised leaf perturbed) the
loss and every gradient agree with ``jax.value_and_grad`` to rtol 1e-4 /
atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
from repro.configs import registry as jregistry
from repro.data import make_batches as jmake_batches
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.configs import registry
from repro_torch.data import make_batches, model_inputs
from repro_torch.launch import train as cli
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

WHISPER, VLM = "whisper-medium", "internvl2-26b"


@pytest.fixture(scope="module")
def jax_cache():
    return {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side runs on one thread: these models are thousands of
    small ops (RWKV's time loop, the scan's rounds), whose intra-op threads
    only wait on each other when the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_config_is_the_jax_config(name):
    parity.assert_config_is_the_jax_config(name)


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_param_count_is_the_jax_abstract_init(name):
    parity.assert_param_count_is_the_abstract_init(name)


@pytest.mark.parametrize("name,layers,want,reference", [
    (WHISPER, None, 811_579_392, 1_012_434_944),
    (WHISPER, 4, 223_782_912, None),
    (WHISPER, 2, 165_003_264, None),
    (WHISPER, 20, 694_020_096, None),
    (VLM, None, 19_861_260_288, 19_861_254_144),
    (VLM, 1, 1_527_379_968, None),
    (VLM, 2, 1_917_462_528, None),
])
def test_full_width_counts(name, layers, want, reference):
    """The counts ``chip_smoke.py`` ``[arch]`` and ROADMAP Queue 3 cite
    (Whisper's depth cut on both stacks): the reference's own
    ``param_count`` counts a SwiGLU MLP and bias-less norms for Whisper and
    leaves out InternVL2's final norm."""
    cfg = registry.arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  encoder_layers=layers if cfg.is_encdec else 0)
    assert cfg.param_count() == want
    if reference is not None:
        assert jregistry.arch(name).param_count() == reference


def test_whisper_param_tree_matches_jax_keys_and_shapes():
    shapes = parity.assert_param_tree_matches(WHISPER)
    cfg = registry.smoke(WHISPER)
    D, F, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.encoder_layers
    assert shapes["['encoder']['attn_wq']"] == (E, D, cfg.n_heads * cfg.hd)
    assert shapes["['encoder']['ln_enc_final_scale']"] == (D,)  # no layer axis
    assert shapes["['encoder']['ln_enc_final_bias']"] == (D,)
    assert shapes["['encoder']['mlp_up_b']"] == (E, F)
    assert not any(p.startswith("['encoder']['cross_") for p in shapes)
    assert shapes["['decoder']['cross_wk']"] == (L, D, cfg.n_kv_heads * cfg.hd)
    assert shapes["['decoder']['cross_bq']"] == (L, cfg.n_heads * cfg.hd)
    assert shapes["['decoder']['ln_cross_bias']"] == (L, D)
    assert "['blocks']['attn_wq']" not in shapes and "['ln_final_bias']" in shapes


def test_vlm_param_tree_is_the_decoders():
    shapes = parity.assert_param_tree_matches(VLM)
    cfg = registry.smoke(VLM)
    assert shapes["['blocks']['mlp_gate']"] == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert not any("vision" in p for p in shapes)  # the prefix is a stub input


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_loss_and_every_gradient_match_jax(name, jax_cache):
    taux, _ = parity.loss_and_grads_match_jax(name, jax_cache)
    assert list(taux) == ["nll"]


def test_sinusoidal_positions_match_jax():
    """The table at Whisper SMOKE's encoder length: both compute
    pos / 10000^(2i/d) in float32, and their pow may round an ulp apart."""
    cfg = registry.smoke(WHISPER)
    got = tcommon.sinusoidal_positions(cfg.encoder_seq, cfg.d_model).numpy()
    want = np.asarray(jcommon.sinusoidal_positions(cfg.encoder_seq, cfg.d_model))
    assert got.shape == (cfg.encoder_seq, cfg.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], np.r_[np.zeros(cfg.d_model // 2),
                                                np.ones(cfg.d_model // 2)])


def test_cross_attention_matches_jax():
    """``attention_train`` with ``kv_x`` at the layer level: 24 queries over
    an encoder memory of 40, no causal mask and no RoPE on either side."""
    jcfg, tcfg = parity.configs(WHISPER, "smoke")
    params = parity.jax_params(jcfg)["decoder"]
    p = {k: np.asarray(v[0]) for k, v in params.items() if k.startswith("cross_")}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos, mpos = np.arange(24, dtype=np.int32), np.arange(40, dtype=np.int32)
    fn = jax.jit(lambda p, x, mem: jattn.attention_train(
        jcfg, p, x, jnp.asarray(pos), dtype=jnp.float32, kv_x=mem,
        kv_positions=jnp.asarray(mpos), prefix="cross"))
    want = fn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(mem))
    t = {k: parity._t(v) for k, v in p.items()}
    got = tattn.attention_train(tcfg, t, parity._t(x), parity._t(pos), kv_x=parity._t(mem),
                                kv_positions=parity._t(mpos), prefix="cross")
    assert got.shape == (2, 24, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), parity._np(want), **parity.TOL)


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_make_batches_is_the_references_bit_for_bit(name):
    cfg = registry.smoke(name)
    kw = model_inputs(cfg)
    want_keys = {"tokens", "labels", "mask"} | (
        {"frames"} if cfg.is_encdec else {"vision"})
    ours = make_batches(cfg.vocab, 3, 2, 16, seed=4, steps=2, **kw)
    theirs = jmake_batches(cfg.vocab, 3, 2, 16, seed=4, steps=2, **kw)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == want_keys
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    extra = a["frames" if cfg.is_encdec else "vision"]
    assert extra.shape == (3, 2, cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens,
                           cfg.d_model)


def test_whisper_batched_pass_matches_the_loop():
    auxs = parity.batched_pass_matches_the_loop(WHISPER)
    assert list(auxs) == ["nll"]


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_cli_trains_the_smoke_variant_on_the_cpu(name):
    history = cli.main(["--arch", name, "--device", "cpu", "--workers", "4", "--steps", "4",
                        "--warmup-steps", "2", "--seq", "32", "--log-every", "1"])
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert all("comm_bytes_per_worker" in h for h in history[2:])
