"""repro_torch's paper transformer against ``repro.models`` at smoke width.

Parameters come from the JAX ``Model.init`` (perturbed so that every bias
and norm is non-trivial) and are carried across with ``params_from_jax``.
Loss and every per-parameter gradient agree to rtol 1e-4 / atol 1e-5: the
two frameworks order matmul sums and logsumexp differently. The pieces that
are easy to get wrong each have their own comparison below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models.convert import params_from_jax

ARCH = "paper-transformer-base"
B, S, LOSS_CHUNK = 2, 40, 16  # S is no multiple of the loss chunk


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_params(seed=0):
    cfg = jregistry.smoke(ARCH)
    params, _ = jbuild(cfg, compute_dtype="float32").init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: _np(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
                        params)


def _batch(seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


def test_config_is_the_jax_config():
    for get in ("arch", "smoke"):
        a, b = getattr(jregistry, get)(ARCH), getattr(registry, get)(ARCH)
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                  "qkv_bias", "rope_theta", "norm", "tie_embeddings", "sliding_window", "hd"):
            assert getattr(a, f) == getattr(b, f), (get, f)
    # the port counts the layout it builds; the JAX param_count() counts a
    # SwiGLU MLP for every dense arch and overcounts this GELU model
    full, _ = jbuild(jregistry.arch(ARCH)).init(None, abstract=True)
    built = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    assert registry.arch(ARCH).param_count() == built == 56_800_256


def test_param_tree_matches_jax_keys_and_shapes():
    jp = _jax_params()
    tp = build_model(registry.smoke(ARCH), compute_dtype="float32").init(
        torch.Generator().manual_seed(0), "cpu")
    jflat = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {p: tuple(v.shape) for p, v in tree.flatten_with_path(tp)}
    assert list(jflat) == list(tflat)  # JAX's sorted leaf order
    assert jflat == tflat


def test_loss_and_every_gradient_match_jax():
    cfg = jregistry.smoke(ARCH)
    jmodel = jbuild(cfg, compute_dtype="float32", loss_chunk=LOSS_CHUNK)
    jp, batch = _jax_params(), _batch()
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))

    tmodel = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=LOSS_CHUNK)
    tp = tree.tree_map(lambda p: p.requires_grad_(True), params_from_jax(jp, "cpu"))
    tloss, taux = tmodel.loss(tp, {k: _t(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, tree.leaves(tp))

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(taux["nll"].item(), float(jaux["nll"]), rtol=1e-4, atol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for (path, jg), tg in zip(jflat, tgrads):
        np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_gelu_mlp_is_the_tanh_approximation():
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in {"mlp_up": (16, 32), "mlp_up_b": (32,), "mlp_down": (32, 16),
                      "mlp_down_b": (16,)}.items()}
    x = 2.0 * rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jcommon.gelu_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.float32)
    got = tcommon.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_rope_rotates_split_halves():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tcommon.apply_rope(_t(x), _t(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_layernorm_eps_and_biased_variance():
    rng = np.random.default_rng(3)
    x = (3e-3 * rng.standard_normal((4, 32))).astype(np.float32)  # variance ~ eps
    scale, bias = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    want = jcommon.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tcommon.layernorm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_chunked_xent_divides_by_mask_sum(chunk):
    rng = np.random.default_rng(4)
    h = rng.standard_normal((B, S, 16)).astype(np.float32)
    p = {"lm_head": rng.standard_normal((16, 50)).astype(np.float32),
         "tok_embed": rng.standard_normal((50, 16)).astype(np.float32)}
    labels = rng.integers(0, 50, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.5).astype(np.float32)
    want = jcommon.chunked_xent(jax.tree.map(jnp.asarray, p), jnp.asarray(h), jnp.asarray(labels),
                                jnp.asarray(mask), chunk, jnp.float32)
    got = tcommon.chunked_xent({k: _t(v) for k, v in p.items()}, _t(h), _t(labels), _t(mask), chunk,
                               torch.float32)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_with_qkv_bias_and_neg_inf_mask(window):
    cfg = registry.smoke(ARCH)
    jcfg = jregistry.smoke(ARCH)
    rng = np.random.default_rng(5)
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    shapes = {"attn_wq": (D, H * hd), "attn_wk": (D, H * hd), "attn_wv": (D, H * hd),
              "attn_wo": (H * hd, D), "attn_bq": (H * hd,), "attn_bk": (H * hd,),
              "attn_bv": (H * hd,)}
    p = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    x = rng.standard_normal((B, 12, D)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    want = jattn.attention_train(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                 jnp.asarray(pos), dtype=jnp.float32, causal=True, window=window)
    got = tattn.attention_train(cfg, {k: _t(v) for k, v in p.items()}, _t(x), _t(pos),
                                dtype=torch.float32, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)
