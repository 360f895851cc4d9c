"""repro_torch's training path against ``repro.training``, plus the port's rules.

One compressed step from a carried-across TrainState agrees to rtol 1e-4 /
atol 1e-6 (matmul and worker-mean sums are ordered differently); a 6-step
run with 2 dense warm-up steps keeps its loss history within rtol 1e-3.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.state import ScaleComState as JState
from repro.data import make_batches as jmake_batches
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import TrainLoop as JLoop
from repro.training import init_train_state as jinit
from repro.training import run_training as jrun
from repro.training.train_step import build_train_step as jbuild_step
from repro_torch import kernels, tree
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import make_batches
from repro_torch.launch import train as cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainLoop, TrainState, build_train_step, run_training

ARCH = "paper-transformer-base"
N, LOCAL_B, SEQ, CHUNK, MIN_SIZE, LR = 4, 2, 32, 16, 512, 0.05
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _cfgs(compressor="clt_k", warmup=2):
    kw = dict(beta=0.1, min_size=MIN_SIZE, warmup_steps=warmup)
    return (JCfg(compressor=JComp(compressor, chunk=CHUNK), backend="jnp", fused=False, **kw),
            ScaleComConfig(compressor=CompressorConfig(compressor, chunk=CHUNK), backend="torch",
                           **kw))


def _models():
    return (jbuild(jregistry.smoke(ARCH), compute_dtype="float32", loss_chunk=16),
            build_model(registry.smoke(ARCH), loss_chunk=16))


def _carry(jstate):
    """A JAX TrainState (sgdm) -> the port's, on the CPU."""
    return TrainState(
        params=params_from_jax(jstate.params, "cpu"),
        opt_state={"m": params_from_jax(jstate.opt_state["m"], "cpu")},
        sc_state=state_from_jax(jstate.sc_state, "cpu"),
        step=int(jstate.step),
    )


def _assert_tree_close(t, j, rtol, atol, what):
    jflat = jax.tree_util.tree_flatten_with_path(j)[0]
    tflat = tree.flatten_with_path(t)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, jv), (_, tv) in zip(jflat, tflat):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_make_batches_bit_identical():
    for a, b in zip(jmake_batches(512, N, LOCAL_B, SEQ, seed=3, steps=3),
                    make_batches(512, N, LOCAL_B, SEQ, seed=3, steps=3)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_linear_warmup_matches_jax_and_starts_at_zero():
    jf = jschedule.linear_warmup(jschedule.constant(LR), 4)
    tf = schedule.linear_warmup(schedule.constant(LR), 4)
    assert tf(0) == 0.0
    for step in range(8):
        np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))), rtol=1e-7)


@pytest.mark.parametrize("name", ["sgdm", "adam", "rmsprop"])
def test_optimizer_update_matches_jax(name):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jopt, topt = jmake_opt(name), make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(0.1))
        tp, ts = topt.update(params_from_jax(g, "cpu"), ts, tp, 0.1)
    _assert_tree_close(tp, jp, 1e-6, 1e-7, name)


def test_one_compressed_step_matches_jax():
    jmodel, tmodel = _models()
    jcfg, tcfg = _cfgs()
    jopt, topt = jmake_opt("sgdm"), make_optimizer("sgdm")
    sched_j = jschedule.linear_warmup(jschedule.constant(LR), 2)
    sched_t = schedule.linear_warmup(schedule.constant(LR), 2)
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    # a mid-run state: non-zero momentum and residues, leader t mod N = 3
    rng = np.random.default_rng(1)
    noise = lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32))
    js.opt_state = {"m": jax.tree.map(noise, js.opt_state["m"])}
    js.sc_state = JState(residues=jax.tree.map(noise, js.sc_state.residues), t=jnp.int32(7))
    js.step = jnp.int32(3)
    ts = _carry(js)
    batch = next(jmake_batches(512, N, LOCAL_B, SEQ, seed=2))

    jstep = jax.jit(jbuild_step(jmodel, jopt, sched_j, jcfg, n_workers=N, mode="scalecom"))
    tstep = build_train_step(tmodel, topt, sched_t, tcfg, n_workers=N, mode="scalecom")
    js2, jm = jstep(js, batch)
    ts2, tm = tstep(ts, batch)

    _assert_tree_close(ts2.params, js2.params, 1e-4, 1e-6, "params")
    _assert_tree_close(ts2.opt_state["m"], js2.opt_state["m"], 1e-4, 1e-6, "momentum")
    for path, enc in js2.sc_state.residues.items():
        np.testing.assert_allclose(ts2.sc_state.residues[path]["q"].numpy(), np.asarray(enc["q"]),
                                   rtol=1e-4, atol=1e-6, err_msg=path)
    assert ts2.sc_state.t == int(js2.sc_state.t) and ts2.step == int(js2.step) == 4
    for k in ("loss", "grad_norm", "lr", "nll", "comm_bytes_per_worker", "comm_bytes_dense"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_six_step_run_tracks_jax_loss_history():
    jmodel, tmodel = _models()
    jcfg, tcfg = _cfgs(warmup=2)
    jopt, topt = jmake_opt("sgdm"), make_optimizer("sgdm")
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    ts = _carry(js)
    jloop = JLoop(model=jmodel, optimizer=jopt, schedule=jschedule.constant(LR), sc_cfg=jcfg,
                  n_workers=N, log_every=1)
    tloop = TrainLoop(model=tmodel, optimizer=topt, schedule=schedule.constant(LR), sc_cfg=tcfg,
                      n_workers=N, log_every=1)
    _, jh = jrun(jloop, js, jmake_batches(512, N, LOCAL_B, SEQ, seed=0), 6, log=None)
    _, th = run_training(tloop, ts, make_batches(512, N, LOCAL_B, SEQ, seed=0), 6, log=None)
    assert [h["step"] for h in th] == list(range(6))
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-3)


def test_grad_clip_bounds_update():
    _, tmodel = _models()
    _, tcfg = _cfgs()
    opt = make_optimizer("sgdm")
    from repro_torch.training import init_train_state

    state = init_train_state(tmodel, opt, tcfg, torch.Generator().manual_seed(0), n_workers=N,
                             device="cpu")
    before = tree.tree_map(torch.clone, state.params)
    step = build_train_step(tmodel, opt, schedule.constant(0.1), tcfg, n_workers=N,
                            grad_clip=0.001)
    new, _ = step(state, next(make_batches(512, N, LOCAL_B, SEQ)))
    delta = torch.sqrt(sum(torch.sum((a - b) ** 2)
                           for a, b in zip(tree.leaves(new.params), tree.leaves(before))))
    assert 0 < float(delta) < 0.01


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 30 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_without_cuda_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--steps", "1"])


def test_cpu_run_through_the_cuda_backend_launches_no_kernel():
    kernels.reset_launches()
    history = cli.main(["--device", "cpu", "--backend", "cuda", "--workers", "2", "--steps", "3",
                        "--warmup-steps", "1", "--local-batch", "2", "--seq", "16",
                        "--log-every", "1"])
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    assert kernels.launches() == {
        "chunk_argmax": 0, "chunk_topm": 0, "chunk_gather": 0, "chunk_scatter": 0,
        "ef_update": 0, "fused_reduce": 0,
    }
