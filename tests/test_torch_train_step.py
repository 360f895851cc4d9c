"""repro_torch's batched per-worker gradient pass against its loop and JAX.

``per_worker_grads`` takes every worker's gradient in one ``torch.func.vmap``
pass. From parameters carried across from the JAX ``Model.init`` and one
worker-stacked batch it agrees with ``per_worker_grads_loop`` (one
``torch.autograd.grad`` per worker) to rtol 1e-5 / atol 1e-7, since the two
order a few sums differently, and with the reference's form (the parameters
broadcast to a worker axis, the loss vmapped under one ``value_and_grad``)
to rtol 1e-4 / atol 1e-6, the repo's tolerance between the two frameworks.
Any vmap fallback warning (an op without a batching rule, looped over the
workers in Python) is an error here. ``microbatches=M`` matches the
reference's fp32-accumulating scan at the same tolerance. Two calls agree
bitwise but for tok_embed, whose index-accumulate PyTorch's CPU kernel sums
in thread order.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import make_batches as jmake_batches
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.training.train_step import per_worker_grads, per_worker_grads_loop

ARCH = "paper-transformer-base"
N, LOCAL_B, SEQ, LOSS_CHUNK = 4, 4, 32, 16
LOOP_TOL = dict(rtol=1e-5, atol=1e-7)
JAX_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_per_worker(jmodel, params, batch, microbatches):
    """The reference's per-worker pass (repro/training/train_step.py:131-172):
    broadcast, vmap, one value_and_grad; a scan over microbatches."""
    def grads_of(mb):
        pex = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (N,) + p.shape), params)

        def total(pex):
            losses, auxs = jax.vmap(jmodel.loss)(pex, mb)
            return jnp.sum(losses), auxs

        return jax.value_and_grad(total, has_aux=True)(pex)

    if microbatches == 1:
        (loss_sum, auxs), g = grads_of(batch)
        return loss_sum / N, jnp.mean(auxs["nll"]), g
    M = microbatches
    mbs = jax.tree.map(lambda x: x.reshape((N, M, x.shape[1] // M) + x.shape[2:]).swapaxes(0, 1),
                       batch)

    def body(acc, mb):
        (loss_sum, auxs), g = grads_of(mb)
        return jax.tree.map(lambda a, gg: a + gg.astype(jnp.float32), acc, g), (loss_sum, auxs)

    acc0 = jax.tree.map(lambda p: jnp.zeros((N,) + p.shape, jnp.float32), params)
    g, (losses, auxs) = jax.lax.scan(body, acc0, mbs)
    return jnp.mean(losses) / N, jnp.mean(jnp.mean(auxs["nll"], axis=0)), jax.tree.map(
        lambda x: x / M, g)


@pytest.fixture(scope="module")
def setup():
    jmodel = jbuild(jregistry.smoke(ARCH), compute_dtype="float32", loss_chunk=LOSS_CHUNK)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    batch = next(jmake_batches(jregistry.smoke(ARCH).vocab, N, LOCAL_B, SEQ, seed=5))
    tmodel = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=LOSS_CHUNK)
    return {
        "jmodel": jmodel, "jparams": jparams, "batch": batch, "tmodel": tmodel,
        "params": params_from_jax(jparams, "cpu"),
        "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "jax": {},  # microbatches -> the reference's (loss, nll, grads), computed once
    }


def _jax_result(setup, microbatches):
    if microbatches not in setup["jax"]:
        fn = jax.jit(lambda p, b: _jax_per_worker(setup["jmodel"], p, b, microbatches))
        setup["jax"][microbatches] = fn(setup["jparams"], setup["batch"])
    return setup["jax"][microbatches]


def _batched(setup, microbatches=1):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a vmap fallback warns, and loops in Python
        return per_worker_grads(setup["tmodel"], setup["params"], setup["tbatch"], N,
                                microbatches)


def _assert_close(t, j, tol, what):
    jflat = jax.tree_util.tree_flatten_with_path(j)[0]
    tflat = tree.flatten_with_path(t)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, jv), (_, tv) in zip(jflat, tflat):
        assert tuple(tv.shape) == np.shape(jv)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), err_msg=f"{what} {path}", **tol)


def test_batched_pass_matches_the_loop(setup):
    loss, auxs, grads = _batched(setup)
    l_loop, a_loop, g_loop = per_worker_grads_loop(setup["tmodel"], setup["params"],
                                                   setup["tbatch"], N)
    assert all(g.shape[0] == N for g in tree.leaves(grads))
    assert list(auxs) == list(a_loop) == ["nll"] and auxs["nll"].shape == (N,)
    np.testing.assert_allclose(float(loss), float(l_loop), rtol=1e-6)
    np.testing.assert_allclose(auxs["nll"].numpy(), a_loop["nll"].numpy(), rtol=1e-6)
    for (path, a), (_, b) in zip(tree.flatten_with_path(grads), tree.flatten_with_path(g_loop)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path, **LOOP_TOL)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_batched_pass_matches_jax(setup, microbatches):
    loss, auxs, grads = _batched(setup, microbatches)
    jloss, jnll, jgrads = _jax_result(setup, microbatches)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(torch.mean(auxs["nll"])), float(jnll), rtol=1e-5)
    _assert_close(grads, jgrads, JAX_TOL, f"microbatches={microbatches}")


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatches_match_one_pass(setup, microbatches):
    loss, auxs, grads = _batched(setup, microbatches)
    l1, a1, g1 = _batched(setup)
    assert all(g.dtype == torch.float32 for g in tree.leaves(grads))
    assert auxs["nll"].shape == (N,)
    np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(torch.mean(auxs["nll"])), float(torch.mean(a1["nll"])),
                               rtol=1e-6)
    for (path, a), (_, b) in zip(tree.flatten_with_path(grads), tree.flatten_with_path(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path, rtol=1e-5, atol=1e-6)


def test_two_batched_passes_agree_bitwise_but_for_the_embedding(setup):
    """tok_embed's gradient is an index-accumulate (``index_put_`` with
    accumulate, the embedding's backward), which PyTorch's CPU kernel sums
    in thread order when many threads run: that one is held to the loop's
    tolerance, every other gradient bitwise. On the card ``chip_smoke.py``
    holds all of them bitwise."""
    _, _, a = _batched(setup)
    _, _, b = _batched(setup)
    for (path, x), (_, y) in zip(tree.flatten_with_path(a), tree.flatten_with_path(b)):
        if path == "['tok_embed']":
            np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=path, **LOOP_TOL)
        else:
            assert torch.equal(x, y), path


def test_microbatches_must_divide_the_batch(setup):
    with pytest.raises(ValueError, match=r"batch 4 .*microbatches=3"):
        per_worker_grads(setup["tmodel"], setup["params"], setup["tbatch"], N, microbatches=3)


def test_worker_count_must_lead_the_batch(setup):
    with pytest.raises(ValueError, match="do not lead with 3 workers"):
        per_worker_grads(setup["tmodel"], setup["params"], setup["tbatch"], 3)
