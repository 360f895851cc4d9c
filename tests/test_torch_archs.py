"""repro_torch's RMSNorm / SwiGLU dense decoders against ``repro.models``.

starcoder2-3b, qwen2.5-14b (qkv biases, head dim 40), phi3-medium-14b and
command-r-plus-104b at their SMOKE widths, as the reference computes them:
RMSNorm (a scale, eps 1e-6, in fp32), GQA attention with RoPE, a SwiGLU MLP
with no biases, an untied LM head. The configs equal the reference's field
by field and count what the reference's abstract init builds, full width
included. From JAX-initialised parameters (every norm scale and bias
perturbed) the loss, ``nll`` and every gradient agree with
``jax.value_and_grad`` to rtol 1e-4 / atol 1e-5; one compressed CLT-k step
of qwen2.5 from a carried-across mid-run state agrees with the reference's
``train_step`` to rtol 1e-4 / atol 1e-6, in the flat layout and in the
rowwise one (where its trailing axes, 160 and 80 wide, are no multiple of
the 64-wide chunk). The paper transformer keeps its own tests in
``test_torch_model.py``; its config is checked here with the others.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
from repro.configs import registry as jregistry
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import train as cli
from repro_torch.models import common as tcommon
from repro_torch.models.convert import params_from_jax

DENSE = ("starcoder2-3b", "qwen2.5-14b", "phi3-medium-14b", "command-r-plus-104b")


@pytest.fixture(scope="module")
def jax_cache():
    return {}


def test_registry_holds_the_reference_ids_it_ports():
    assert set(registry.ARCHS) == set(jregistry._MODULES)
    assert len(registry.ARCHS) == 11


@pytest.mark.parametrize("name", DENSE + ("paper-transformer-base",))
def test_config_is_the_jax_config(name):
    parity.assert_config_is_the_jax_config(name)


@pytest.mark.parametrize("name", DENSE)
def test_param_count_is_the_jax_abstract_init(name):
    parity.assert_param_count_is_the_abstract_init(name)


@pytest.mark.parametrize("name", DENSE)
def test_param_tree_matches_jax_keys_and_shapes(name):
    shapes = parity.assert_param_tree_matches(name)
    cfg = registry.smoke(name)
    assert shapes["['blocks']['mlp_gate']"] == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert shapes["['blocks']['attn_wk']"] == (cfg.n_layers, cfg.d_model, cfg.n_kv_heads * cfg.hd)
    assert ("['blocks']['attn_bq']" in shapes) == cfg.qkv_bias


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_every_gradient_match_jax(name, jax_cache):
    taux, _ = parity.loss_and_grads_match_jax(name, jax_cache)
    assert list(taux) == ["nll"]


def test_rmsnorm_eps_in_fp32():
    rng = np.random.default_rng(3)
    x = (1e-3 * rng.standard_normal((4, 32))).astype(np.float32)  # mean square ~ eps
    scale = rng.standard_normal(32).astype(np.float32)
    want = jcommon.rmsnorm(jax.numpy.asarray(x), jax.numpy.asarray(scale))
    got = tcommon.rmsnorm(parity._t(x), parity._t(scale))
    np.testing.assert_allclose(got.numpy(), parity._np(want), rtol=1e-5, atol=1e-6)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(1)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)  # the init's scale
         for k, s in {"mlp_gate": (16, 24), "mlp_up": (16, 24), "mlp_down": (24, 16)}.items()}
    x = 2.0 * rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jcommon.swiglu(jax.tree.map(jax.numpy.asarray, p), jax.numpy.asarray(x),
                          jax.numpy.float32)
    got = tcommon.swiglu({k: parity._t(v) for k, v in p.items()}, parity._t(x))
    np.testing.assert_allclose(got.numpy(), parity._np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["starcoder2-3b", "qwen2.5-14b"])
def test_params_from_jax_takes_an_rmsnorm_tree_unchanged(name):
    jp, _ = jbuild(jregistry.smoke(name), compute_dtype="float32").init(jax.random.PRNGKey(1))
    tp = params_from_jax(jp, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = tree.flatten_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, j), (_, t) in zip(jflat, tflat):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path))


def test_starcoder2_batched_pass_matches_the_loop():
    auxs = parity.batched_pass_matches_the_loop("starcoder2-3b")
    assert list(auxs) == ["nll"]


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
def test_qwen_compressed_step_matches_jax(layout):
    tm, _ = parity.one_compressed_step_matches_jax("qwen2.5-14b", chunk=64, min_size=128,
                                                   layout=layout)
    assert "nll" in tm and not any(k.startswith("moe_") for k in tm)


def test_cli_trains_starcoder2_smoke_on_the_cpu():
    history = cli.main(["--arch", "starcoder2-3b", "--device", "cpu", "--workers", "4",
                        "--steps", "4", "--warmup-steps", "2", "--log-every", "1"])
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert all("comm_bytes_per_worker" in h for h in history[2:])


def test_cli_keeps_its_message_for_an_unknown_arch():
    with pytest.raises(SystemExit, match=r"unknown arch gpt-2; choices: \[") as err:
        cli.main(["--arch", "gpt-2", "--device", "cpu", "--steps", "1"])
    assert all(repr(a) in str(err.value) for a in registry.ARCHS)


@pytest.mark.parametrize("name", ["starcoder2-3b", "phi3.5-moe-42b-a6.6b"])
def test_cli_without_cuda_raises_unless_cpu_is_asked_for(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--arch", name, "--steps", "1"])
