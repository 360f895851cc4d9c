"""repro_torch's recurrent families against ``repro.models``: the RWKV-6 SSM
(rwkv6-3b) and the RecurrentGemma hybrid (recurrentgemma-2b).

At their SMOKE widths, as the reference computes them. RWKV-6: the time mix
(ddlerp token shift through five 64-wide adapters, the decay
exp(-exp(wd)), the per-head state recurrence with its bonus, the per-head
group norm) and the channel mix. The hybrid: ``rec, rec, attn`` units
stacked under ``units``, the layers left over un-stacked under ``tail``;
RG-LRU blocks (causal conv as a sum of shifted slices, the scan in
log-depth rounds) then a SwiGLU MLP; local attention within
``local_window``. The configs equal the reference's field by field and
count what its abstract init builds, full width included. From
JAX-initialised parameters (every constant-initialised leaf perturbed) the
loss and every gradient agree with ``jax.value_and_grad`` to rtol 1e-4 /
atol 1e-5, the hybrid also at 5 layers (one unit and a 2-layer tail) and
96 positions, past its 64-position window. One compressed CLT-k step agrees
with the reference's ``train_step`` to rtol 1e-4 / atol 1e-6, flat and
rowwise: RWKV's adapters and bonus have trailing axes of exactly one chunk
(64) and half a chunk (32); the hybrid's tail (at 4 layers, one unit and
one tail layer) has no layer axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
from repro.configs import registry as jregistry
from repro.models import build_model as jbuild
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import train as cli
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

RWKV, HYBRID = "rwkv6-3b", "recurrentgemma-2b"
# the hybrid with a tail (5 layers: one rec, rec, attn unit, then rec, rec)
# at 96 positions, past its 64-position local window
TAIL = dict(n_layers=5)
LONG = 96
# the compressed step's hybrid: one unit and a 1-layer tail (JAX compiles its
# train step in about half the time of the 5-layer one's)
STEP_TAIL = dict(n_layers=4)


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


def _layer0(params, sub):
    """Layer 0 of a stacked subtree of a JAX-initialised tree, as numpy."""
    return {k: np.asarray(v[0]) for k, v in params[sub].items()}


@pytest.mark.parametrize("name", [RWKV, HYBRID])
def test_config_is_the_jax_config(name):
    parity.assert_config_is_the_jax_config(name)


@pytest.mark.parametrize("name", [RWKV, HYBRID])
def test_param_count_is_the_jax_abstract_init(name):
    parity.assert_param_count_is_the_abstract_init(name)


@pytest.mark.parametrize("name,layers,want,reference", [
    (RWKV, None, 3_125_742_080, 2_915_205_120),
    (RWKV, 2, 509_934_080, None),
    (RWKV, 4, 684_321_280, None),
    (HYBRID, None, 3_549_841_920, 3_195_991_040),
    (HYBRID, 4, 1_659_440_640, None),
    (HYBRID, 10, 2_173_335_040, None),
])
def test_full_width_counts(name, layers, want, reference):
    """The counts ``chip_smoke.py`` ``[arch]`` and ROADMAP Queue 3 cite; the
    reference's own ``param_count`` is approximate for both families."""
    cfg = registry.arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert cfg.param_count() == want
    if reference is not None:
        assert jregistry.arch(name).param_count() == reference


def test_rwkv_param_tree_matches_jax_keys_and_shapes():
    shapes = parity.assert_param_tree_matches(RWKV)
    cfg = registry.smoke(RWKV)
    L, D, H, hd = cfg.n_layers, cfg.d_model, cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    assert shapes["['blocks']['tm_lora_a']"] == (L, 5, D, trwkv.LORA_R)
    assert shapes["['blocks']['tm_lora_b']"] == (L, 5, trwkv.LORA_R, D)
    assert shapes["['blocks']['tm_u']"] == (L, H, hd)
    assert shapes["['blocks']['cm_wk']"] == (L, D, cfg.d_ff)
    assert not any("attn_" in p for p in shapes)


@pytest.mark.parametrize("layers", [3, 5])
def test_hybrid_param_tree_matches_jax_keys_and_shapes(layers):
    jcfg, tcfg = parity.configs(HYBRID, "smoke", n_layers=layers)
    full, _ = jbuild(jcfg).init(None, abstract=True)
    jflat = {jax.tree_util.keystr(p): tuple(v.shape)
             for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
    tp = build_model(tcfg, compute_dtype="float32").init(torch.Generator().manual_seed(0), "cpu")
    tflat = {p: tuple(v.shape) for p, v in tree.flatten_with_path(tp)}
    assert list(tflat) == list(jflat) and tflat == jflat
    D, W = tcfg.d_model, tcfg.conv_width
    assert tflat["['units']['u0_rec']['rec_conv']"] == (1, W, D)
    assert tflat["['units']['u2_attn']['attn_wk']"] == (1, D, tcfg.n_kv_heads * tcfg.hd)
    tail = sorted({p.split("']")[1] for p in tflat if p.startswith("['tail']")})
    assert tail == ([] if layers == 3 else ["['layer_0_rec", "['layer_1_rec"])
    if layers == 5:
        assert tflat["['tail']['layer_1_rec']['rec_conv']"] == (W, D)  # no layer axis


@pytest.mark.parametrize("name,seq,overrides", [
    (RWKV, parity.S, {}),
    (HYBRID, parity.S, {}),
    (HYBRID, LONG, TAIL),
], ids=["rwkv6", "recurrentgemma", "recurrentgemma-tail-windowed"])
def test_loss_and_every_gradient_match_jax(name, seq, overrides, jax_cache):
    taux, _ = parity.loss_and_grads_match_jax(name, jax_cache, seq=seq, **overrides)
    assert list(taux) == ["nll"]


def test_hybrid_window_masks_at_long_sequence():
    """At 96 positions the 64-wide local window changes the loss: the case
    above runs with the window masking."""
    jcfg, tcfg = parity.configs(HYBRID, "smoke", **TAIL)
    params = params_from_jax(parity.jax_params(jcfg), "cpu")
    b = {k: parity._t(v) for k, v in parity.batch(tcfg, seq=LONG).items()}
    windowed, _ = build_model(tcfg, compute_dtype="float32",
                              loss_chunk=parity.LOSS_CHUNK).loss(params, b)
    wide = dataclasses.replace(tcfg, local_window=LONG)
    unmasked, _ = build_model(wide, compute_dtype="float32",
                              loss_chunk=parity.LOSS_CHUNK).loss(params, b)
    assert abs(float(windowed) - float(unmasked)) > 1e-4


def test_rglru_scan_matches_the_sequential_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + bx_t step by step (in
    float64) and against the reference's associative scan, from a non-zero
    h0, at a length that is no power of two. The three sum in different
    orders: fp32 rounding over 100 steps."""
    rng = np.random.default_rng(4)
    B, S, D = 2, 100, 16
    a = rng.uniform(0.5, 1.0, (B, S, D)).astype(np.float32)
    bx = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    got = trglru._rglru_scan(parity._t(a), parity._t(bx), parity._t(h0)).numpy()
    h, want = h0.astype(np.float64), np.empty((B, S, D))
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        want[:, t] = h
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jgot = np.asarray(jax.jit(jrglru._rglru_scan)(jnp.asarray(a), jnp.asarray(bx),
                                                   jnp.asarray(h0)))
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


def _state(rng, shapes):
    return {k: (0.5 * rng.standard_normal(s)).astype(np.float32) if not isinstance(s, dict)
            else _state(rng, s) for k, s in shapes.items()}


def test_time_mix_matches_jax_from_a_carried_state():
    """RWKV's time mix at the layer level, from a non-zero state (the model's
    path starts from zeros): the output and the new state (S and x_prev)."""
    jcfg, tcfg = parity.configs(RWKV, "smoke")
    p = _layer0(parity.jax_params(jcfg), "blocks")
    rng = np.random.default_rng(6)
    B, S, D = 2, 24, tcfg.d_model
    H, hd = D // tcfg.ssm_head_dim, tcfg.ssm_head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    st = _state(rng, {"s": (B, H, hd, hd), "x_prev": (B, D)})
    fn = jax.jit(lambda p, x, st: jrwkv.time_mix(jcfg, p, x, st, dtype=jnp.float32))
    want, wstate = fn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    got, gstate = trwkv.time_mix(tcfg, {k: parity._t(v) for k, v in p.items()}, parity._t(x),
                                 {k: parity._t(v) for k, v in st.items()}, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), parity._np(want), **parity.TOL)
    for k in ("s", "x_prev"):
        np.testing.assert_allclose(gstate[k].numpy(), parity._np(wstate[k]), err_msg=k,
                                   **parity.TOL)


def test_rglru_block_matches_jax_from_a_carried_state():
    """The recurrent block at the layer level, from a non-zero state: the
    conv's carried-in tail and the scan's h0 both reach the output."""
    jcfg, tcfg = parity.configs(HYBRID, "smoke")
    p = _layer0(parity.jax_params(jcfg)["units"], "u0_rec")
    rng = np.random.default_rng(7)
    B, S, D, W = 2, 24, tcfg.d_model, tcfg.conv_width
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    st = _state(rng, {"h": (B, D), "conv": (B, W - 1, D)})
    fn = jax.jit(lambda p, x, st: jrglru.rglru_block(jcfg, p, x, st, dtype=jnp.float32))
    want, wstate = fn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    got, gstate = trglru.rglru_block(tcfg, {k: parity._t(v) for k, v in p.items()},
                                     parity._t(x), {k: parity._t(v) for k, v in st.items()},
                                     dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), parity._np(want), **parity.TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gstate[k].numpy(), parity._np(wstate[k]), err_msg=k,
                                   **parity.TOL)


def test_rwkv_batched_pass_matches_the_loop():
    """The time loop under ``vmap`` gives the loop's gradients. The per-head
    group norm magnifies the rounding of the batched matmuls (which sum in
    another order than the loop's) where a head's output nearly cancels,
    and the bonus's gradient sums B x S x hd such products an element:
    atol 1e-6 (its elements reach ~3e-2)."""
    auxs = parity.batched_pass_matches_the_loop(RWKV, tol=dict(rtol=1e-5, atol=1e-6))
    assert list(auxs) == ["nll"]


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("name,overrides", [(RWKV, {}), (HYBRID, STEP_TAIL)],
                         ids=["rwkv6", "recurrentgemma-tail"])
def test_compressed_step_matches_jax(name, overrides, layout):
    tm, _ = parity.one_compressed_step_matches_jax(name, chunk=64, min_size=128, layout=layout,
                                                   **overrides)
    assert "nll" in tm and not any(k.startswith("moe_") for k in tm)


@pytest.mark.parametrize("name", [RWKV, HYBRID])
def test_cli_trains_the_smoke_variant_on_the_cpu(name):
    history = cli.main(["--arch", name, "--device", "cpu", "--workers", "4", "--steps", "4",
                        "--warmup-steps", "2", "--seq", "32", "--log-every", "1"])
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert all("comm_bytes_per_worker" in h for h in history[2:])
