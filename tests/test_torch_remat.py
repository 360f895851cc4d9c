"""The port's memory strategy, the reference's: ``common.remat`` (the port of
``jax.checkpoint``) around each layer, each whole hybrid unit, each query
chunk of attention and each chunk of the cross-entropy.

(a) ``attention_core`` scans 512-query chunks (here smaller ones), the last
one sliced short where the reference pads it with position -1 and masks it:
forward and gradients agree with the reference's ``attention_core`` at the
same ``q_chunk`` to rtol 1e-5 / atol 1e-6, causal or not, windowed or not,
GQA, cross (T != S), S a multiple of the chunk, not one, and below it.
(b) ``Model.loss`` with ``remat=True`` against ``remat=False``, for one
SMOKE id of each family: gradients, loss and aux bit for bit, under the
batched per-worker pass (also with microbatches) and under the loop of one
``torch.autograd.grad`` per worker, and under ``torch.inference_mode``. (c) Rematerialised, a layer keeps about
one (B, S, D) input for the backward; without, many times that; under the
batched pass too. (d) A model
whose sequence is past one 512-query chunk agrees with the reference's loss
and every gradient at the parity tolerances.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
from repro.models import attention as jattn
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.data import model_inputs
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.training.train_step import per_worker_grads, per_worker_grads_loop

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)

# (id, S, T (None: self-attention), H, KV, causal, window, q_chunk)
ATTN_CASES = [
    ("causal-gqa-ragged", 37, None, 4, 2, True, None, 8),
    ("causal-window-multiple", 32, None, 4, 4, True, 5, 8),
    ("encoder-mqa-ragged", 37, None, 4, 1, False, None, 8),
    ("cross-ragged", 37, 23, 4, 2, False, None, 8),
    ("window-below-chunk", 6, None, 4, 2, True, 3, 8),
    ("default-chunk", 37, None, 4, 2, True, None, 512),
]
FAMILIES = ["paper-transformer-base", "starcoder2-3b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b",
            "recurrentgemma-2b", "whisper-medium", "internvl2-26b"]
# the hybrid with its tail: one rec, rec, attn unit and a rec, rec tail
OVERRIDES = {"recurrentgemma-2b": dict(n_layers=5)}
PASSES = ["batched", "batched-microbatches", "loop"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: tok_embed's index-accumulate is bitwise repeatable
    only there, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cache():
    return {}


def _attn_inputs(case):
    _, S, T, H, KV, _, _, _ = case
    T = T or S
    rng = np.random.default_rng(S * 7 + H + KV)
    hd = 8
    return {"q": rng.standard_normal((2, S, H, hd)).astype(np.float32),
            "k": rng.standard_normal((2, T, KV, hd)).astype(np.float32),
            "v": rng.standard_normal((2, T, KV, hd)).astype(np.float32),
            "ct": rng.standard_normal((2, S, H, hd)).astype(np.float32),
            "q_pos": np.arange(S, dtype=np.int32), "k_pos": np.arange(T, dtype=np.int32)}


def _jax_attention(case):
    _, _, _, _, _, causal, window, q_chunk = case
    x = _attn_inputs(case)

    def f(q, k, v):
        out = jattn.attention_core(q, k, v, jnp.asarray(x["q_pos"]), jnp.asarray(x["k_pos"]),
                                   causal=causal, window=window, q_chunk=q_chunk)
        return jnp.sum(out * x["ct"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_chunked_attention_core_matches_jax(case):
    _, _, _, _, _, causal, window, q_chunk = case
    want_out, want_grads = _jax_attention(case)
    x = {k: torch.from_numpy(v) for k, v in _attn_inputs(case).items()}
    got = {}
    for remat in (True, False):
        def core(q, k, v):
            return tattn.attention_core(q, k, v, x["q_pos"], x["k_pos"], causal=causal,
                                        window=window, q_chunk=q_chunk, remat=remat)

        out = core(x["q"], x["k"], x["v"])
        grads = torch.func.grad(lambda q, k, v: torch.sum(core(q, k, v) * x["ct"]),
                                argnums=(0, 1, 2))(x["q"], x["k"], x["v"])
        np.testing.assert_allclose(out.numpy(), want_out, **ATTN_TOL)
        for name, g, w in zip("qkv", grads, want_grads):
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **ATTN_TOL)
        got[remat] = (out, grads)
    assert torch.equal(got[True][0], got[False][0])
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))
    with torch.inference_mode():  # serving never remats, but nothing breaks if it does
        assert torch.equal(tattn.attention_core(x["q"], x["k"], x["v"], x["q_pos"], x["k_pos"],
                                                causal=causal, window=window, q_chunk=q_chunk),
                           got[True][0])


def _family(name, n=2, local_b=2, seq=24):
    cfg = parity.configs(name, "smoke", **OVERRIDES.get(name, {}))[1]
    params = build_model(cfg, compute_dtype="float32").init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(parity.jmake_batches(
        cfg.vocab, n, local_b, seq, seed=3, **model_inputs(cfg))).items()}
    return cfg, params, batch, n


@pytest.mark.parametrize("how", PASSES)
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_is_bitwise_the_plain_pass(name, how):
    cfg, params, batch, n = _family(name)
    out = []
    for remat in (False, True):
        model = build_model(cfg, compute_dtype="float32", loss_chunk=8, remat=remat)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a vmap fallback warns
            if how == "loop":
                out.append(per_worker_grads_loop(model, params, batch, n))
            else:
                out.append(per_worker_grads(model, params, batch, n,
                                            microbatches=2 if how.endswith("microbatches") else 1))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1)
    assert sorted(a0) == sorted(a1) and all(torch.equal(a0[k], a1[k]) for k in a0)
    for (path, x), (_, y) in zip(tree.flatten_with_path(g0), tree.flatten_with_path(g1)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_runs_under_inference_mode(name):
    """Serving never rematerialises, but a loss under inference_mode (no
    graph to save for) gives the plain pass's values."""
    cfg, params, batch, _ = _family(name)
    one = {k: v[0] for k, v in batch.items()}
    with torch.inference_mode():
        got = [build_model(cfg, compute_dtype="float32", loss_chunk=8, remat=r).loss(params, one)
               for r in (False, True)]
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(got[0][1][k], got[1][1][k]) for k in got[0][1])


def _saved_bytes(cfg, n_layers, remat, B=2, S=48):
    """Bytes of the distinct storages ``Model.loss`` saves for its backward,
    the parameters' own excluded."""
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, compute_dtype="float32", loss_chunk=16, remat=remat)
    params = tree.tree_map(lambda p: p.requires_grad_(True),
                           model.init(torch.Generator().manual_seed(0), "cpu"))
    own = {p.untyped_storage().data_ptr() for p in tree.leaves(params)}
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
             "mask": torch.ones(B, S)}
    kept = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in own:
            kept[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(params, batch)
    torch.autograd.grad(loss, tree.leaves(params))
    return sum(kept.values()), B * S * cfg.d_model * 4


def test_remat_keeps_about_one_layer_input_per_layer():
    cfg = registry.smoke("paper-transformer-base")
    growth = {}
    for remat in (True, False):
        (two, x_bytes), (four, _) = (_saved_bytes(cfg, n, remat) for n in (2, 4))
        growth[remat] = (four - two) / 2 / x_bytes  # per layer, in (B, S, D) inputs
    assert 0.9 < growth[True] <= 1.5, growth
    assert growth[False] > 8 * growth[True], growth


# one batched per-worker pass in a fresh process: the growth of its peak
# resident set over the pass, in MiB (the functorch transforms take no
# saved-tensor hooks, so the pass is measured from outside)
RSS_CHILD = """
import dataclasses, sys
import numpy as np, torch
from repro_torch.configs import registry
from repro_torch.models import build_model
from repro_torch.training.train_step import per_worker_grads
torch.set_num_threads(1)
remat, layers, n, B, S = sys.argv[1] == "1", int(sys.argv[2]), 2, 2, 512
cfg = dataclasses.replace(registry.smoke("paper-transformer-base"), n_layers=layers)
model = build_model(cfg, compute_dtype="float32", loss_chunk=64, remat=remat)
params = model.init(torch.Generator().manual_seed(0), "cpu")
rng = np.random.default_rng(0)
batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (n, B, S)).astype(np.int32)),
         "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (n, B, S)).astype(np.int32)),
         "mask": torch.ones(n, B, S)}
def peak_kib():  # this process's own high-water mark (ru_maxrss keeps the parent's)
    with open("/proc/self/status") as f:
        return int(next(line for line in f if line.startswith("VmHWM")).split()[1])
before = peak_kib()
per_worker_grads(model, params, batch, n)
print((peak_kib() - before) / 1024)
"""


def test_remat_keeps_less_under_the_batched_pass():
    """Under ``vmap(grad_and_value)`` too (whose backward runs with
    create_graph), four more layers grow the pass's peak by a small share
    of what they add without remat: 2 x 2 x 512 tokens of d 128, where a
    layer without remat keeps ~100 MiB of scores and activations."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(parity.SRC))
    runs = {(remat, layers): subprocess.Popen(
                [sys.executable, "-c", RSS_CHILD, str(int(remat)), str(layers)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for remat in (False, True) for layers in (2, 6)}
    mib = {}
    for key, proc in runs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        mib[key] = float(out.split()[-1])
    growth = {r: mib[(r, 6)] - mib[(r, 2)] for r in (False, True)}
    assert growth[False] > 200, mib
    assert growth[True] < 0.25 * growth[False], mib


@pytest.mark.parametrize("name,seq,overrides", [
    ("paper-transformer-base", 520, {}),
    ("whisper-medium", 40, dict(encoder_seq=520)),
], ids=["causal-520", "encoder-520"])
def test_past_one_query_chunk_matches_jax(name, seq, overrides, jax_cache):
    """Two 512-query chunks in the model: causal self-attention over 520
    tokens, or a 520-frame encoder and the decoder's cross-attention to it."""
    parity.loss_and_grads_match_jax(name, jax_cache, seq=seq, **overrides)


def test_remat_is_on_by_default_as_the_reference():
    assert build_model(registry.smoke("paper-transformer-base"),
                       compute_dtype="float32").remat is True
