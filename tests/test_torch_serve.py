"""repro_torch's serving path against ``repro.models``' prefill and decode.

For each of the eleven ids of the registry at its SMOKE width, from the same
JAX-initialised parameters (every constant-initialised leaf perturbed, as
``_torch_arch_parity`` does) and the same prompt: the port's
``Model.prefill`` gives the reference's last logits and decode state, leaf
for leaf under the reference's ``keystr`` paths (the caches, ``slot_pos``
exactly, the RWKV-6 and RG-LRU states, the hybrid's tail list, Whisper's
self and cross caches); then three teacher-forced ``decode_step``s from the
reference's state carried across (``decode_state_from_jax``) give its
logits and states. Values agree to rtol 1e-4 / atol 1e-5, as the arch tests
hold the loss: the two frameworks order matmul sums differently, and the
reference's prefill scans 512-query chunks where the port takes the whole
score tensor. Also: the reference's own serving checks on the port
(prefill/decode consistency at the reference's rtol = atol = 2e-3, the
ring cache of ``decode_window``, the recurrent state's size) with the
window ring and the hybrid past its 64-position window held against the
reference's logits; caches of different layers never alias; the CLI; and
greedy tokens equal to the reference's loop over the same prompts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import serve as cli
from repro_torch.models import attention as attn
from repro_torch.models import build_model, common
from repro_torch.models.convert import (decode_state_from_jax, decode_state_to_numpy,
                                        params_from_jax)
from repro_torch.training.serve import build_serve_fns

ARCHS = list(registry.ARCHS)
PROMPT, STEPS, GEN = 24, 3, 4
TOL = parity.TOL  # rtol 1e-4 / atol 1e-5
CONSISTENCY_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models_smoke.py's
HYBRID = "recurrentgemma-2b"
# the hybrid with a tail (5 layers: one rec, rec, attn unit, then rec, rec),
# prompted past its SMOKE local_window of 64
HYBRID_TAIL, LONG = dict(n_layers=5), 80


@pytest.fixture(scope="module")
def jax_cache():
    return {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port runs on one thread: RWKV's time loop and the hybrid's scan
    are many small ops whose intra-op threads only wait on each other when
    the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _prefix(cfg) -> int:
    return cfg.vision_tokens if cfg.arch_type == "vlm" else 0


def _prompt(b, n):
    """The batch ``b`` (numpy) with its first ``n`` tokens, labels dropped."""
    return {k: (v[:, :n] if k == "tokens" else v) for k, v in b.items()
            if k not in ("labels", "mask")}


def _jnp(tree_):
    return jax.tree.map(jnp.asarray, tree_)


def jax_run(name, cache, *, prompt=PROMPT, decode_window=None, **overrides):
    """The reference's serving of ``name`` (SMOKE, ``overrides``) from
    ``parity.jax_params``: prefill of ``prompt`` tokens, ``STEPS``
    teacher-forced decode steps, and greedy decoding of ``GEN`` tokens from
    the same prefill. Cached per case."""
    key = (name, prompt, decode_window, tuple(sorted(overrides.items())))
    if key in cache:
        return cache[key]
    jcfg, tcfg = parity.configs(name, "smoke", **overrides)
    jm = jbuild(jcfg, compute_dtype="float32", decode_window=decode_window)
    params = parity.jax_params(jcfg)
    b = parity.batch(jcfg, seq=prompt + STEPS)
    ctx = _prefix(jcfg) + prompt
    cap = ctx + STEPS + 5
    jp = _jnp(params)
    prefill = jax.jit(lambda p, b_: jm.prefill(p, b_, cap))
    decode = jax.jit(jm.decode_step)
    logits, state0 = prefill(jp, _jnp(_prompt(b, prompt)))
    run = dict(jcfg=jcfg, tcfg=tcfg, params=params, batch=b, ctx=ctx, cap=cap,
               logits=[np.asarray(logits)], states=[jax.tree.map(np.asarray, state0)])
    state = state0
    for i in range(STEPS):
        logits, state = decode(jp, state, jnp.asarray(b["tokens"][:, prompt + i]),
                               jnp.int32(ctx + i))
        run["logits"].append(np.asarray(logits))
        run["states"].append(jax.tree.map(np.asarray, state))
    tok = jnp.argmax(run["logits"][0], -1).astype(jnp.int32)
    greedy, state = [tok], state0
    for i in range(GEN - 1):  # the reference CLI's loop
        logits, state = decode(jp, state, tok, jnp.int32(ctx + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        greedy.append(tok)
    run["greedy"] = np.stack([np.asarray(t) for t in greedy], axis=1)
    cache[key] = run
    return run


def _port(run, decode_window=None):
    model = build_model(run["tcfg"], decode_window=decode_window)
    return model, params_from_jax(run["params"], "cpu")


def assert_state_close(port_state, jax_state, what):
    """Every leaf of the port's decode state against the reference's, under
    the same ``keystr`` paths; ``slot_pos`` exactly."""
    jflat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    tflat = tree.flatten_with_path(decode_state_to_numpy(port_state))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, jv), (_, tv) in zip(jflat, tflat):
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, (what, path)
        if jv.dtype == np.int32:
            np.testing.assert_array_equal(tv, jv, err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(tv, jv, err_msg=f"{what} {path}", **TOL)


def _decode_matches(run, model, params, state, prompt, what):
    """``STEPS`` teacher-forced decode steps of the port from ``state``
    against the reference's logits and states."""
    for i in range(STEPS):
        tok = _t(run["batch"]["tokens"][:, prompt + i])
        logits, state = model.decode_step(params, state, tok, run["ctx"] + i)
        np.testing.assert_allclose(logits.numpy(), run["logits"][i + 1],
                                   err_msg=f"{what} step {i}", **TOL)
        assert_state_close(state, run["states"][i + 1], f"{what} step {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_jax(jax_cache, name):
    run = jax_run(name, jax_cache)
    model, params = _port(run)
    logits, state = model.prefill(params, {k: _t(v) for k, v in
                                           _prompt(run["batch"], PROMPT).items()}, run["cap"])
    assert logits.shape == (parity.B, run["tcfg"].vocab)
    np.testing.assert_allclose(logits.numpy(), run["logits"][0], **TOL)
    assert_state_close(state, run["states"][0], "prefill")


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_from_the_jax_state_match_jax(jax_cache, name):
    run = jax_run(name, jax_cache)
    model, params = _port(run)
    state = decode_state_from_jax(run["states"][0], "cpu")
    _decode_matches(run, model, params, state, PROMPT, "decode")


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_equal_the_reference_loop(jax_cache, name):
    run = jax_run(name, jax_cache)
    model, params = _port(run)
    prefill_fn, decode_fn = build_serve_fns(model, seq_len=run["cap"])
    batch = {k: _t(v) for k, v in _prompt(run["batch"], PROMPT).items()}
    tokens, _, _ = cli.generate(prefill_fn, decode_fn, params, batch, run["ctx"], GEN)
    np.testing.assert_array_equal(tokens.numpy(), run["greedy"])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_consistency(name):
    """The reference's check on the port: decode of token T after the prefill
    of tokens[:T] gives the last logits of the prefill of tokens[:T+1]. MoE
    is rebuilt with the no-drop capacity factor (its drops depend on the
    token count)."""
    cfg = registry.smoke(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    b = {k: _t(v) for k, v in _prompt(parity.batch(cfg, seed=3, seq=32), 32).items()}
    ctx = _prefix(cfg) + 31
    full, _ = model.prefill(params, b, ctx + 8)
    _, state = model.prefill(params, dict(b, tokens=b["tokens"][:, :31]), ctx + 8)
    dec, _ = model.decode_step(params, state, b["tokens"][:, 31], ctx)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **CONSISTENCY_TOL)


@pytest.mark.parametrize("name", ["starcoder2-3b", "qwen2.5-14b"])
def test_decode_window_ring_matches_jax(jax_cache, name):
    """``decode_window=16``: a 16-slot ring after a 24-token prompt, decoded
    past the window, each step's logits and ring against the reference's."""
    run = jax_run(name, jax_cache, decode_window=16)
    model, params = _port(run, decode_window=16)
    logits, state = model.prefill(params, {k: _t(v) for k, v in
                                           _prompt(run["batch"], PROMPT).items()}, run["cap"])
    assert state["kv"]["k"].shape[2] == 16  # ring capacity == window
    np.testing.assert_allclose(logits.numpy(), run["logits"][0], **TOL)
    assert_state_close(state, run["states"][0], "prefill")
    _decode_matches(run, model, params, state, PROMPT, "ring decode")


def test_window_ring_cache_matches_full_for_short_context():
    """Within the window, ring-cache serving equals full-cache serving."""
    cfg = registry.smoke("starcoder2-3b")
    ring, full = build_model(cfg, decode_window=PROMPT + 8), build_model(cfg)
    params = full.init(torch.Generator().manual_seed(0), "cpu")
    tokens = _t(parity.batch(cfg, seq=PROMPT + 1)["tokens"])
    lw, sw = ring.prefill(params, {"tokens": tokens[:, :PROMPT]}, PROMPT + 8)
    lf, sf = full.prefill(params, {"tokens": tokens[:, :PROMPT]}, PROMPT + 8)
    np.testing.assert_allclose(lw.numpy(), lf.numpy(), **TOL)
    dw, _ = ring.decode_step(params, sw, tokens[:, PROMPT], PROMPT)
    df, _ = full.decode_step(params, sf, tokens[:, PROMPT], PROMPT)
    np.testing.assert_allclose(dw.numpy(), df.numpy(), **TOL)


def test_hybrid_past_its_window_matches_jax(jax_cache):
    """recurrentgemma-2b with a 2-layer tail, prompted with 80 positions past
    its 64-position local window: the attention caches hold the last 64 in
    ring slots; prefill and three decode steps against the reference."""
    run = jax_run(HYBRID, jax_cache, prompt=LONG, **HYBRID_TAIL)
    model, params = _port(run)
    logits, state = model.prefill(params, {k: _t(v) for k, v in
                                           _prompt(run["batch"], LONG).items()}, run["cap"])
    assert state["units"]["u2_attn"]["k"].shape[2] == 64
    assert len(state["tail"]) == 2
    np.testing.assert_allclose(logits.numpy(), run["logits"][0], **TOL)
    assert_state_close(state, run["states"][0], "prefill")
    _decode_matches(run, model, params, state, LONG, "decode past the window")


@pytest.mark.parametrize("name", ["rwkv6-3b", HYBRID])
def test_recurrent_state_is_context_length_independent(name):
    model = build_model(registry.smoke(name))
    n = [sum(x.numel() for x in tree.leaves(model.init_decode_state(2, seq, "cpu")))
         for seq in (64, 4096)]
    if name == "rwkv6-3b":
        assert n[0] == n[1]  # pure SSM: exactly constant
    else:
        assert n[1] <= n[0] * 40  # hybrid: bounded by the local window, not seq_len


@pytest.mark.parametrize("name, params_key, state_key", [
    ("starcoder2-3b", "blocks", "kv"), ("whisper-medium", "decoder", "self"),
    (HYBRID, "units", "units")])
def test_one_layers_write_leaves_the_others_untouched(name, params_key, state_key):
    """Stacked caches are tensors of their own, never views of one shared
    cache: a decode write into layer 0's slot shows in no other layer."""
    cfg = dataclasses.replace(registry.smoke(name), n_layers=6 if name == HYBRID else 2)
    model = build_model(cfg)
    state = model.init_decode_state(2, 8, "cpu")
    stack = model.init(torch.Generator().manual_seed(0), "cpu")[params_key]
    caches = state[state_key]
    if name == HYBRID:  # two stacked rec, rec, attn units
        stack, caches = stack["u2_attn"], caches["u2_attn"]
    layer0 = lambda t: tree.tree_map(lambda v: v[0], t)
    with torch.inference_mode():
        attn.attention_decode(cfg, layer0(stack), torch.randn(2, 1, cfg.d_model), 3,
                              layer0(caches))
    assert torch.count_nonzero(caches["k"][0]) > 0 and caches["slot_pos"][0, 3] == 3
    assert torch.count_nonzero(caches["k"][1:]) == 0 and torch.count_nonzero(caches["v"][1:]) == 0
    assert torch.all(caches["slot_pos"][1:] == -1)
    ptrs = [x.data_ptr() for x in tree.leaves(state)]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("pos", [0, 1, 37, 1499])
def test_sinusoidal_positions_at(pos):
    d = 64
    at = common.sinusoidal_positions_at(pos, d)
    assert at.shape == (1, 1, d)
    np.testing.assert_array_equal(at[0, 0].numpy(), common.sinusoidal_positions(1500, d)[pos].numpy())
    np.testing.assert_allclose(at.numpy(), np.asarray(jcommon.sinusoidal_positions_at(
        jnp.int32(pos), d)), rtol=1e-6, atol=1e-6)


def test_cli_serves_on_the_cpu():
    gen = cli.main(["--device", "cpu", "--arch", HYBRID, "--batch", "2", "--prompt-len", "16",
                    "--gen", "4"])
    assert gen.shape == (2, 4)


def test_cli_without_cuda_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--arch", HYBRID, "--batch", "2", "--prompt-len", "16", "--gen", "4"])


def test_cli_exits_on_an_unknown_arch():
    with pytest.raises(SystemExit, match=r"unknown arch gpt-2; choices: \[") as err:
        cli.main(["--arch", "gpt-2", "--device", "cpu"])
    assert all(repr(a) in str(err.value) for a in registry.ARCHS)
