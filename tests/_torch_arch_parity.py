"""Shared checks of the port's archs against the JAX package, for
``test_torch_archs.py`` (the dense RMSNorm / SwiGLU decoders),
``test_torch_moe.py`` (the top-k MoE decoders), ``test_torch_recurrent.py``
(the RWKV-6 SSM and the RecurrentGemma hybrid) and
``test_torch_encdec_vlm.py`` (Whisper and InternVL2).

Each check takes an arch id of both registries. JAX results are cached per
case in the dicts the test modules' module-scoped fixtures hand in, so the
parametrized tests share one JAX compile per case.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.state import ScaleComState as JState
from repro.data import make_batches as jmake_batches
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import init_train_state as jinit
from repro.training.train_step import build_train_step as jbuild_step
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import model_inputs
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainState, build_train_step
from repro_torch.training.train_step import per_worker_grads, per_worker_grads_loop

B, S, LOSS_CHUNK = 2, 40, 16  # S is no multiple of the loss chunk
TOL = dict(rtol=1e-4, atol=1e-5)  # the two frameworks order matmul sums differently
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
LOOP_TOL = dict(rtol=1e-5, atol=1e-7)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def configs(name, get, **overrides):
    """(JAX config, port config) of ``name`` (``get``: "arch" or "smoke")."""
    j, t = getattr(jregistry, get)(name), getattr(registry, get)(name)
    return dataclasses.replace(j, **overrides), dataclasses.replace(t, **overrides)


def assert_config_is_the_jax_config(name):
    """Every field of the port's ArchConfig equals JAX's; every JAX field the
    port does not carry holds its default (no SSM, hybrid, enc-dec or VLM
    setting is lost)."""
    port_fields = {f.name for f in dataclasses.fields(registry.arch(name))}
    for get in ("arch", "smoke"):
        j, t = configs(name, get)
        for f in port_fields:
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert t.hd == j.hd
        for f in dataclasses.fields(jbase.ArchConfig):
            if f.name not in port_fields:
                assert getattr(j, f.name) == f.default, (get, f.name)


def assert_param_count_is_the_abstract_init(name):
    """The port's param_count() counts every leaf of JAX's abstract init
    (kimi-k2's 1T included: nothing is allocated)."""
    for get in ("arch", "smoke"):
        j, t = configs(name, get)
        full, _ = jbuild(j).init(None, abstract=True)
        built = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
        assert t.param_count() == built, (get, t.param_count(), built)


def assert_param_tree_matches(name):
    j, t = configs(name, "smoke")
    full, _ = jbuild(j).init(None, abstract=True)
    tp = build_model(t).init(torch.Generator().manual_seed(0), "cpu")
    jflat = {jax.tree_util.keystr(p): tuple(v.shape)
             for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
    tflat = {p: tuple(v.shape) for p, v in tree.flatten_with_path(tp)}
    assert list(jflat) == list(tflat)  # JAX's sorted leaf order
    assert jflat == tflat
    if t.norm == "rmsnorm":
        assert not [p for p in tflat if p.endswith("_bias']")]
    return tflat


def perturb_constants(params, seed):
    """``params`` (a JAX tree) as numpy, every leaf initialised to a constant
    (norm scales and biases; RWKV's mixers, decay base and bonus; RG-LRU's
    lambda) plus 0.1 x standard normal noise, so none is trivial."""
    rng = np.random.default_rng(seed)

    def perturb(p):
        p = _np(p)
        if np.all(p == p.flat[0]):
            p = p + 0.1 * rng.standard_normal(p.shape).astype(np.float32)
        return p

    return jax.tree.map(perturb, params)


def jax_params(jcfg, seed=0):
    """JAX ``Model.init`` with its constant leaves perturbed (``perturb_constants``)."""
    params, _ = jbuild(jcfg, compute_dtype="float32").init(jax.random.PRNGKey(seed))
    return perturb_constants(params, seed)


def batch(cfg, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
           "mask": (rng.random((B, seq)) > 0.3).astype(np.float32)}
    if cfg.arch_type == "vlm":
        out["vision"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model), np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), np.float32)
    return out


def loss_and_grads_match_jax(name, cache, seq=S, **overrides):
    """From JAX-initialised params, the port's loss, every aux and every
    gradient agree with ``jax.value_and_grad(model.loss)`` to ``TOL``
    (a batch of ``seq`` positions). Returns (the port's aux dict, JAX's)."""
    jcfg, tcfg = configs(name, "smoke", **overrides)
    key = (name, seq, tuple(sorted(overrides.items())))
    if key not in cache:
        jp, b = jax_params(jcfg), batch(jcfg, seq=seq)
        jmodel = jbuild(jcfg, compute_dtype="float32", loss_chunk=LOSS_CHUNK)
        fn = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
        cache[key] = (jp, b, fn(jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b)))
    jp, b, ((jloss, jaux), jgrads) = cache[key]

    tmodel = build_model(tcfg, loss_chunk=LOSS_CHUNK)
    tp = tree.tree_map(lambda p: p.requires_grad_(True), params_from_jax(jp, "cpu"))
    tloss, taux = tmodel.loss(tp, {k: _t(v) for k, v in b.items()})
    tgrads = torch.autograd.grad(tloss, tree.leaves(tp))

    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), err_msg=k, **TOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for (path, jg), tg in zip(jflat, tgrads):
        np.testing.assert_allclose(tg.numpy(), _np(jg), err_msg=jax.tree_util.keystr(path),
                                   **TOL)
    return {k: v.detach() for k, v in taux.items()}, {k: jaux[k] for k in jaux}


def batched_pass_matches_the_loop(name, n=4, local_b=2, seq=32, tol=LOOP_TOL):
    """``per_worker_grads`` (one vmapped pass, every warning an error: a
    vmap fallback warns) against ``per_worker_grads_loop``, every gradient
    to ``tol``."""
    jcfg, tcfg = configs(name, "smoke")
    model = build_model(tcfg, loss_chunk=LOSS_CHUNK)
    params = params_from_jax(jax_params(jcfg), "cpu")
    b = {k: torch.from_numpy(v) for k, v in next(
        jmake_batches(tcfg.vocab, n, local_b, seq, seed=5, **model_inputs(tcfg))).items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loss, auxs, grads = per_worker_grads(model, params, b, n)
    l_loop, a_loop, g_loop = per_worker_grads_loop(model, params, b, n)
    np.testing.assert_allclose(float(loss), float(l_loop), rtol=1e-6)
    assert sorted(auxs) == sorted(a_loop)
    for k in auxs:
        assert auxs[k].shape == (n,)
        np.testing.assert_allclose(auxs[k].numpy(), a_loop[k].numpy(), rtol=1e-6, err_msg=k)
    for (path, a), (_, c) in zip(tree.flatten_with_path(grads), tree.flatten_with_path(g_loop)):
        assert a.shape[0] == n
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=path, **tol)
    return auxs


def _assert_tree_close(t, j, what):
    jflat = jax.tree_util.tree_flatten_with_path(j)[0]
    tflat = tree.flatten_with_path(t)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, jv), (_, tv) in zip(jflat, tflat):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), err_msg=f"{what} {path}",
                                   **STEP_TOL)


def one_compressed_step_matches_jax(name, *, chunk, min_size, layout, n=4, local_b=2, seq=32,
                                    lr=0.05, probe=None, **overrides):
    """From a mid-run state carried across (non-zero momentum and residues,
    the parameters' constant leaves perturbed as ``jax_params`` does, leader
    t mod n = 3), one compressed CLT-k step of the port agrees with
    JAX's ``train_step``: params, momentum, residues and every metric the
    reference reports, the model's aux losses included. ``probe(model,
    params, worker batch)`` runs on each worker's batch before the step (the
    step updates the parameters in place); ``overrides`` replace fields of
    the SMOKE config. Returns (port metrics, JAX metrics)."""
    jcfg_m, tcfg_m = configs(name, "smoke", **overrides)
    kw = dict(beta=0.1, min_size=min_size, warmup_steps=2, layout=layout)
    jcfg = JCfg(compressor=JComp("clt_k", chunk=chunk), backend="jnp", fused=False, **kw)
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=chunk), backend="torch",
                          **kw)
    jmodel = jbuild(jcfg_m, compute_dtype="float32", loss_chunk=LOSS_CHUNK)
    tmodel = build_model(tcfg_m, loss_chunk=LOSS_CHUNK)
    jopt, topt = jmake_opt("sgdm"), make_optimizer("sgdm")
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=n)
    js.params = jax.tree.map(jnp.asarray, perturb_constants(js.params, 0))
    rng = np.random.default_rng(1)
    noise = lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32))
    js.opt_state = {"m": jax.tree.map(noise, js.opt_state["m"])}
    js.sc_state = JState(residues=jax.tree.map(noise, js.sc_state.residues), t=jnp.int32(7))
    js.step = jnp.int32(3)
    ts = TrainState(params=params_from_jax(js.params, "cpu"),
                    opt_state={"m": params_from_jax(js.opt_state["m"], "cpu")},
                    sc_state=state_from_jax(js.sc_state, "cpu"), step=3)
    b = next(jmake_batches(tcfg_m.vocab, n, local_b, seq, seed=2, **model_inputs(tcfg_m)))
    if probe is not None:
        for i in range(n):
            probe(tmodel, ts.params, {k: torch.from_numpy(v[i]) for k, v in b.items()})

    jstep = jax.jit(jbuild_step(jmodel, jopt, jschedule.linear_warmup(jschedule.constant(lr), 2),
                                jcfg, n_workers=n, mode="scalecom"))
    tstep = build_train_step(tmodel, topt, schedule.linear_warmup(schedule.constant(lr), 2),
                             tcfg, n_workers=n, mode="scalecom")
    js2, jm = jstep(js, b)
    ts2, tm = tstep(ts, b)

    _assert_tree_close(ts2.params, js2.params, "params")
    _assert_tree_close(ts2.opt_state["m"], js2.opt_state["m"], "momentum")
    assert sorted(ts2.sc_state.residues) == sorted(js2.sc_state.residues)
    for path, enc in js2.sc_state.residues.items():
        np.testing.assert_allclose(ts2.sc_state.residues[path]["q"].numpy(),
                                   np.asarray(enc["q"]), err_msg=path, **STEP_TOL)
    assert ts2.sc_state.t == int(js2.sc_state.t) and ts2.step == int(js2.step) == 4
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **STEP_TOL)
    return tm, jm
