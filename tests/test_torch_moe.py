"""repro_torch's top-k MoE decoders against ``repro.models``.

phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b at their SMOKE widths (4 experts,
top-2), as the reference computes them: RMSNorm, GQA attention and in every
layer ``models.moe.moe_ffn``: a softmax router, top-k gates renormalised,
``capacity = max(8, int(capacity_factor * T * K / E))``, positions in each
expert from a stable argsort, the choices past capacity sent to one sink row
and dropped, the combine weighted by gate * keep; the load-balance and z
losses weighted 0.01 and 1e-3 into the loss, each aux averaged over layers.

``lax.top_k`` and ``torch.topk`` may order tied router probabilities
differently. The inputs here are random fp32 with no ties: the tests that
route check that the k-th and (k+1)-th router logit of every token are
apart by ``MARGIN``, far more than the frameworks' rounding (~1e-6).
``moe_dropped_frac`` is a float of counts, 1 - kept / (T*K), and is compared
exactly with the reference run eagerly. Compiled, the reference computes it
otherwise: XLA's CPU backend turns the division by the constant T*K into a
multiply by its float32 reciprocal and fuses ``1 - x*c`` into one FMA (kept =
T*K gives -1.49e-8, not 0). Against the compiled reference the tests
compare the drop counts that the floats hold, exactly.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
from repro.configs import registry as jregistry
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import train as cli
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

MOE = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
AUX = ("moe_dropped_frac", "moe_lb_loss", "moe_z_loss", "nll")
MARGIN = 1e-4  # least gap between the k-th and (k+1)-th router logit


@pytest.fixture(scope="module")
def jax_cache():
    return {}


def _count(frac, choices: int) -> int:
    """The number of dropped choices a ``moe_dropped_frac`` (a mean over
    layers of 1 - kept / (T*K)) stands for; ``choices`` = layers * T * K."""
    n = float(frac) * choices
    assert abs(n - round(n)) < 1e-3, n
    return round(n)


def _margin(cfg, router, x) -> float:
    logits = x.detach().reshape(-1, x.shape[-1]) @ router.detach()
    top = torch.topk(logits, cfg.moe_topk + 1, dim=-1).values
    return float((top[:, -2] - top[:, -1]).min())


@pytest.fixture
def margins(monkeypatch):
    """Every ``moe_ffn`` call's least top-k margin (no ties), recorded."""
    seen = []
    real = tmoe.moe_ffn

    def recording(cfg, p, x, **kw):
        if not torch._C._functorch.is_functorch_wrapped_tensor(x):  # the vmapped pass: see probe
            seen.append(_margin(cfg, p["router"], x))
        return real(cfg, p, x, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", recording)
    return seen


@pytest.mark.parametrize("name", MOE)
def test_config_is_the_jax_config(name):
    parity.assert_config_is_the_jax_config(name)
    cfg = registry.arch(name)
    assert cfg.n_experts and cfg.moe_topk and cfg.capacity_factor == 1.25


@pytest.mark.parametrize("name", MOE)
def test_param_count_is_the_jax_abstract_init(name):
    parity.assert_param_count_is_the_abstract_init(name)


def test_phi35_full_width_counts():
    cfg = registry.arch("phi3.5-moe-42b-a6.6b")
    assert dataclasses.replace(cfg, n_layers=1).param_count() == 1_562_980_352
    assert cfg.param_count() == 41_872_527_360


@pytest.mark.parametrize("name", MOE)
def test_param_tree_matches_jax_keys_and_shapes(name):
    shapes = parity.assert_param_tree_matches(name)
    cfg = registry.smoke(name)
    L, E, D, F = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert shapes["['blocks']['router']"] == (L, D, E)
    assert shapes["['blocks']['expert_gate']"] == shapes["['blocks']['expert_up']"] == (L, E, D, F)
    assert shapes["['blocks']['expert_down']"] == (L, E, F, D)
    assert not any(p.startswith("['blocks']['mlp_") for p in shapes)


@pytest.mark.parametrize("name,capacity_factor", [
    ("phi3.5-moe-42b-a6.6b", 1.25), ("kimi-k2-1t-a32b", 1.25), ("phi3.5-moe-42b-a6.6b", 0.5)])
def test_loss_every_aux_and_gradient_match_jax(name, capacity_factor, jax_cache, margins):
    taux, jaux = parity.loss_and_grads_match_jax(name, jax_cache,
                                                 capacity_factor=capacity_factor)
    assert sorted(taux) == list(AUX)
    choices = registry.smoke(name).n_layers * parity.B * parity.S * registry.smoke(name).moe_topk
    dropped = _count(taux["moe_dropped_frac"], choices)
    assert dropped == _count(jaux["moe_dropped_frac"], choices)
    if capacity_factor < 1:
        assert dropped > 0
    assert len(margins) == registry.smoke(name).n_layers and min(margins) > MARGIN


@pytest.mark.parametrize("n,n_experts", [(1, 1), (7, 4), (160, 4), (1000, 16), (4096, 384)])
def test_positions_in_expert_match_jax(n, n_experts):
    ids = np.random.default_rng(n).integers(0, n_experts, n).astype(np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), n_experts))
    got = tmoe._positions_in_expert(torch.from_numpy(ids), n_experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # each expert's entries are ranked 0, 1, ... in stable order
    for e in range(n_experts):
        np.testing.assert_array_equal(want[ids == e], np.arange((ids == e).sum()))


def _ffn_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": 0.5 * rng.standard_normal((D, E)),
         "expert_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "expert_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "expert_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.standard_normal((2, 24, D)).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 0.1])
def test_moe_ffn_and_its_gradients_match_jax(capacity_factor):
    """48 tokens, 4 experts, top-2: capacity 30, 12 and 8 (the floor)."""
    jcfg, tcfg = parity.configs("phi3.5-moe-42b-a6.6b", "smoke", capacity_factor=capacity_factor)
    p, x = _ffn_inputs(tcfg, 7)
    r = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(jcfg, p, x, dtype=jnp.float32)
        return jnp.sum(out * r) + aux["moe_lb_loss"] + aux["moe_z_loss"], (out, aux)

    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    jout, jaux = jmoe.moe_ffn(jcfg, jp, jx, dtype=jnp.float32)  # eager: the division as written
    _, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(jp, jx)
    tp = {k: parity._t(v).requires_grad_(True) for k, v in p.items()}
    tx = parity._t(x).requires_grad_(True)
    assert _margin(tcfg, tp["router"], tx) > MARGIN  # no ties
    tout, taux = tmoe.moe_ffn(tcfg, tp, tx, dtype=torch.float32)
    tl = torch.sum(tout * parity._t(r)) + taux["moe_lb_loss"] + taux["moe_z_loss"]
    tg = torch.autograd.grad(tl, list(tp.values()) + [tx])

    np.testing.assert_allclose(tout.detach().numpy(), parity._np(jout), **parity.TOL)
    assert sorted(taux) == sorted(jaux)
    assert float(taux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])
    if capacity_factor < 1:
        assert float(taux["moe_dropped_frac"]) > 0
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), err_msg=k, **parity.TOL)
    for name, got in zip(list(p) + ["x"], tg):
        want = jg[0][name] if name != "x" else jg[1]
        np.testing.assert_allclose(got.numpy(), parity._np(want), err_msg=name, **parity.TOL)


def test_moe_ffn_under_vmap_matches_each_worker():
    """The per-worker pass vmaps ``moe_ffn``: no fallback warning, and each
    worker's output, aux and drop decisions are its own call's."""
    _, tcfg = parity.configs("phi3.5-moe-42b-a6.6b", "smoke", capacity_factor=0.5)
    p, _ = _ffn_inputs(tcfg, 9)
    tp = {k: parity._t(v) for k, v in p.items()}
    xs = torch.from_numpy(np.random.default_rng(10).standard_normal((3, 2, 24, tcfg.d_model))
                          .astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, aux = torch.func.vmap(lambda x: tmoe.moe_ffn(tcfg, tp, x, dtype=torch.float32))(xs)
    for i in range(3):
        o, a = tmoe.moe_ffn(tcfg, tp, xs[i], dtype=torch.float32)
        np.testing.assert_allclose(out[i].numpy(), o.numpy(), rtol=1e-6, atol=1e-6)
        assert float(aux["moe_dropped_frac"][i]) == float(a["moe_dropped_frac"])
    assert float(aux["moe_dropped_frac"].min()) > 0


def test_params_from_jax_takes_the_moe_tree_unchanged():
    jp, _ = jbuild(jregistry.smoke("phi3.5-moe-42b-a6.6b"),
                   compute_dtype="float32").init(jax.random.PRNGKey(2))
    tp = params_from_jax(jp, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = tree.flatten_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    assert "['blocks']['expert_gate']" in dict(tflat) and "['blocks']['router']" in dict(tflat)
    for (path, j), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path))


def test_phi35_batched_pass_matches_the_loop():
    auxs = parity.batched_pass_matches_the_loop("phi3.5-moe-42b-a6.6b")
    assert sorted(auxs) == list(AUX)


def test_phi35_compressed_step_matches_jax(margins):
    tm, jm = parity.one_compressed_step_matches_jax(
        "phi3.5-moe-42b-a6.6b", chunk=64, min_size=512, layout="flat",
        probe=lambda model, params, b: model.loss(params, b))  # records each worker's margins
    assert {"moe_lb_loss", "moe_z_loss", "moe_dropped_frac", "nll"} <= set(tm)
    choices = 4 * registry.smoke("phi3.5-moe-42b-a6.6b").n_layers * 2 * 32 * 2  # workers first
    assert _count(tm["moe_dropped_frac"], choices) == _count(jm["moe_dropped_frac"], choices)
    assert len(margins) == 4 * registry.smoke("phi3.5-moe-42b-a6.6b").n_layers
    assert min(margins) > MARGIN


def test_cli_trains_phi35_moe_smoke_on_the_cpu():
    history = cli.main(["--arch", "phi3.5-moe-42b-a6.6b", "--device", "cpu", "--workers", "4",
                        "--steps", "4", "--warmup-steps", "2", "--log-every", "1"])
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    for h in history:
        assert 0.0 <= h["moe_dropped_frac"] < 1.0 and h["moe_lb_loss"] > 0
        assert h["loss"] > h["nll"]  # the aux losses are added
