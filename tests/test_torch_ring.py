"""repro_torch.distributed.ring and the group train step, on gloo between processes.

Four rank processes (``_torch_ring_ranks.rank_main``, spawned once for the
module, one torch thread each, rendezvous through a ``file://`` store under
the test's temporary directory, so no port is taken) each hold one
ScaleCom worker. The reference's results come from one JAX subprocess with
four forced host devices (``--xla_force_host_platform_device_count=4``),
started beside them.

- The port's ring against ``repro.distributed.ring.make_ring_reducer`` at
  sizes 4096 and 4133 (no chunk multiple), chunk 16, beta 0.3, t = 0..3
  (each rank leads once): the same ĝ support, ĝ and m' to rtol 1e-6 /
  atol 1e-7 (the all-reduce sums in another order). The reference ring
  selects top-1 whatever ``cfg.topm`` says (``ring.py:56`` calls
  ``chunk_argmax``); the port's honours top-m, so top-2 is held against the
  reference's stacked ``scalecom_reduce``, which its own
  ``test_ring_backend_matches_gspmd_path`` holds the ring to.
- The port's ring against its own stacked ``scalecom_reduce`` on the same
  rows, both backends: the broadcast offsets and m' bitwise, ĝ to rtol
  1e-6 / atol 1e-7, and identical on every rank.
- ``build_train_step(group=...)`` against JAX's single-device step, one
  dense and one scalecom step from the same carried-across state
  (paper-transformer-base SMOKE, chunk 16): rtol 1e-4 / atol 1e-5; the
  params bitwise identical across ranks after three steps.
- The payload bytes the ranks count equal the plan's, and at the main
  path's chunk 64 the compressed step sends under a tenth of the dense one
  (the port's form of ``test_no_dense_gradient_allreduce_in_hlo``).
- The configurations the group step gained (the exact path, the fused
  reduce and buckets, each also through its environment variable, and
  telemetry) build and run a step on the 4 ranks: the loss JAX's, the
  params bitwise identical across ranks and, but for the exact path and
  the packed buckets (rtol 1e-6 / atol 1e-7), bitwise the plain group
  step's; an ``n_workers`` other than ``group.size()`` raises.
  ``tests/test_torch_ring_group_paths.py`` holds each against JAX.
"""

import multiprocessing
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ring_ranks as ranks
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
from repro_torch.core.compressors import CompressorConfig, select_indices
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import ScaleComState
from repro_torch.backends import resolve_backend
from repro_torch.distributed import clt_ring_reduce, make_ring_reducer
from repro_torch.models.convert import params_from_jax
from repro_torch.training import TrainState, shard_train_state

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N = 4
SIZES, TOPMS, BACKENDS, TS = (4096, 4133), (1, 2), ("torch", "cuda"), (0, 1, 2, 3)
RING_CHUNK, RING_BETA = 16, 0.3
RING_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
LOCAL_B, SEQ, CHUNK, MIN_SIZE, LR = 2, 32, 16, 512, 0.05
TIMEOUT_S = 240

# (label, ScaleComConfig fields, build_train_step keywords, environment):
# the configurations the group step gained, each run for one step, and the
# one it refuses, n_workers
GROUP_CASES = [
    ("exact", {"compressor": CompressorConfig("clt_k", chunk=CHUNK, exact=True)}, {}, {}),
    ("fused", {"fused": True}, {}, {}),
    ("fused_env", {}, {}, {"SCALECOM_TORCH_FUSED": "1"}),
    ("buckets", {}, {"buckets": True}, {}),
    ("buckets_env", {}, {}, {"SCALECOM_TORCH_BUCKET_MB": "4"}),
    ("telemetry", {"telemetry": True}, {}, {}),
    ("n_workers", {}, {"n_workers": 3}, {}),
]

JAX_RING = """
    import numpy as np, jax, jax.numpy as jnp
    from repro.compat import jax_compat
    from repro.core.compressors import CompressorConfig
    from repro.core.scalecom import ScaleComConfig, scalecom_reduce
    from repro.core.state import ScaleComState
    from repro.distributed.ring import make_ring_reducer
    from repro.launch.mesh import make_test_mesh

    src = np.load({path!r} + "/ring_in.npz")
    mesh = make_test_mesh(({n},), ("data",))
    out = {{}}
    for size in {sizes}:
        g, m = jnp.asarray(src[f"g{{size}}"]), jnp.asarray(src[f"m{{size}}"])
        for topm in {topms}:
            cfg = CompressorConfig("clt_k", chunk={chunk}, topm=topm)
            reducer = jax.jit(make_ring_reducer(mesh, "data", cfg, {beta}))
            sc = ScaleComConfig(compressor=cfg, beta={beta}, min_size=1, backend="jnp",
                                fused=False)
            stacked = jax.jit(lambda g, s: scalecom_reduce({{"w": g}}, s, sc))
            for t in {ts}:
                with jax_compat.set_mesh(mesh):
                    ghat, m_new = reducer(g, m, jnp.int32(t))
                key = f"{{size}}_{{topm}}_{{t}}"
                out["ring_ghat_" + key], out["ring_m_" + key] = np.asarray(ghat), np.asarray(m_new)
                state = ScaleComState(residues={{"['w']": {{"q": m}}}}, t=jnp.int32(t))
                ghat_s, st, _ = stacked(g, state)
                out["stacked_ghat_" + key] = np.asarray(ghat_s["w"])
                out["stacked_m_" + key] = np.asarray(st.residues["['w']"]["q"])
    np.savez({path!r} + "/ring_ref.npz", **out)
"""


def _jax_state():
    """A mid-run JAX TrainState (sgdm; non-zero momentum and residues; t = 7,
    so rank 3 leads) and the models."""
    jmodel = jbuild(jregistry.smoke(ranks.ARCH), compute_dtype="float32", loss_chunk=16)
    jcfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), beta=0.1, min_size=MIN_SIZE,
                warmup_steps=2, backend="jnp", fused=False)
    jopt = jmake_opt("sgdm")
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    rng = np.random.default_rng(1)
    noise = lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    js.opt_state = {"m": jax.tree.map(noise, js.opt_state["m"])}
    js.sc_state = JState(residues=jax.tree.map(noise, js.sc_state.residues), t=jnp.int32(7))
    js.step = jnp.int32(3)
    return jmodel, jopt, jcfg, js


def _flat(t) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    g = {size: rng.standard_normal((N, size)).astype(np.float32) for size in SIZES}
    m = {size: rng.standard_normal((N, size)).astype(np.float32) for size in SIZES}
    np.savez(tmp / "ring_in.npz", **{f"g{s}": g[s] for s in SIZES}, **{f"m{s}": m[s] for s in SIZES})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(JAX_RING).format(path=str(tmp), n=N, sizes=SIZES, topms=TOPMS,
                                            chunk=RING_CHUNK, beta=RING_BETA, ts=TS)
    jax_ring = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(N)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, N, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(N)]
    for p in procs:
        p.start()
    try:
        jmodel, jopt, jcfg, js = _jax_state()
        batches = list(jmake_batches(512, N, LOCAL_B, SEQ, seed=2, steps=4))
        job = {
            "ring": {"cases": [(s, k) for s in SIZES for k in TOPMS], "g": g, "m": m,
                     "chunk": RING_CHUNK, "beta": RING_BETA, "ts": TS, "backends": BACKENDS},
            "step": {"params": _flat_tree(js.params), "opt_m": _flat_tree(js.opt_state["m"]),
                     "residues": {p: np.asarray(e["q"]) for p, e in js.sc_state.residues.items()},
                     "t": int(js.sc_state.t), "step": int(js.step), "batch": batches[0],
                     "batches3": batches[1:], "chunk": CHUNK, "min_size": MIN_SIZE, "lr": LR,
                     "cases": GROUP_CASES},
        }
        for parent, _ in pipes:
            parent.send(job)
        # JAX's single-device steps while the ranks run
        sched = jschedule.linear_warmup(jschedule.constant(LR), 2)
        jax_steps = {}
        for mode in ("dense", "scalecom"):
            fn = jax.jit(jbuild_step(jmodel, jopt, sched, jcfg, n_workers=N, mode=mode))
            jax_steps[mode] = fn(js, batches[0])
        results = []
        for r, (parent, _) in enumerate(pipes):
            assert parent.poll(TIMEOUT_S), f"rank {r} sent no result within {TIMEOUT_S} s"
            results.append(parent.recv())
        for r, p in enumerate(procs):
            p.join(TIMEOUT_S)
            assert p.exitcode == 0, f"rank {r} exited with {p.exitcode}"
        out, err = jax_ring.communicate(timeout=TIMEOUT_S)
        assert jax_ring.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if jax_ring.poll() is None:
            jax_ring.kill()
            jax_ring.communicate()
    ref = dict(np.load(tmp / "ring_ref.npz"))
    return {"g": g, "m": m, "ranks": results, "ref": ref, "jax": jax_steps, "js": js}


def _flat_tree(t):
    """A JAX tree -> the same nested dict of numpy arrays."""
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("size", SIZES)
def test_ring_matches_reference_ring(world, size):
    for t in TS:
        key = f"{size}_1_{t}"
        for r, res in enumerate(world["ranks"]):
            _, ghat, m_new = res["ring"][(size, 1, "torch", t)]
            want = world["ref"]["ring_ghat_" + key][r]
            assert ghat.shape == (1, size) and m_new.shape == (1, size)
            np.testing.assert_array_equal(ghat[0] != 0, want != 0, err_msg=f"support t={t}")
            np.testing.assert_allclose(ghat[0], want, err_msg=f"ghat t={t}", **RING_TOL)
            np.testing.assert_allclose(m_new[0], world["ref"]["ring_m_" + key][r],
                                       err_msg=f"m' t={t}", **RING_TOL)


@pytest.mark.parametrize("topm", TOPMS)
@pytest.mark.parametrize("size", SIZES)
def test_ring_matches_reference_stacked_reduce(world, size, topm):
    for t in TS:
        key = f"{size}_{topm}_{t}"
        for r, res in enumerate(world["ranks"]):
            _, ghat, m_new = res["ring"][(size, topm, "torch", t)]
            want = world["ref"]["stacked_ghat_" + key]
            np.testing.assert_array_equal(ghat[0] != 0, want != 0, err_msg=f"support t={t}")
            np.testing.assert_allclose(ghat[0], want, err_msg=f"ghat t={t}", **RING_TOL)
            np.testing.assert_allclose(m_new[0], world["ref"]["stacked_m_" + key][r],
                                       err_msg=f"m' t={t}", **RING_TOL)


@pytest.mark.parametrize("size", SIZES)
def test_reference_ring_selects_top1_whatever_topm(world, size):
    """The reference ring ignores ``cfg.topm`` (``repro/distributed/ring.py:56``):
    its top-2 result is its top-1 result, bit for bit."""
    for t in TS:
        for part in ("ghat", "m"):
            np.testing.assert_array_equal(world["ref"][f"ring_{part}_{size}_2_{t}"],
                                          world["ref"][f"ring_{part}_{size}_1_{t}"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("topm", TOPMS)
@pytest.mark.parametrize("size", SIZES)
def test_ring_matches_port_stacked_reduce(world, size, topm, backend):
    g, m = torch.from_numpy(world["g"][size]), torch.from_numpy(world["m"][size])
    comp = CompressorConfig("clt_k", chunk=RING_CHUNK, topm=topm)
    cfg = ScaleComConfig(compressor=comp, beta=RING_BETA, min_size=1, backend=backend,
                         fused=False, layout="flat")
    be = resolve_backend(backend)
    for t in TS:
        ghat, state, _ = scalecom_reduce({"w": g}, ScaleComState({"['w']": {"q": m}}, t), cfg)
        idx = select_indices(m + g, t, comp, be).numpy()
        m_want = state.residues["['w']"]["q"].numpy()
        ghats = [res["ring"][(size, topm, backend, t)][1] for res in world["ranks"]]
        for r, res in enumerate(world["ranks"]):
            got_idx, got_ghat, got_m = res["ring"][(size, topm, backend, t)]
            np.testing.assert_array_equal(got_idx, idx, err_msg=f"offsets t={t} rank {r}")
            np.testing.assert_array_equal(got_m[0].view(np.uint32), m_want[r].view(np.uint32),
                                          err_msg=f"m' t={t} rank {r}")
            np.testing.assert_allclose(got_ghat[0], ghat["w"].numpy(), err_msg=f"ghat t={t}",
                                       **RING_TOL)
            np.testing.assert_array_equal(got_ghat.view(np.uint32), ghats[0].view(np.uint32))


@pytest.mark.parametrize("mode", ["dense", "scalecom"])
def test_group_step_matches_jax(world, mode):
    js2, jm = world["jax"][mode]
    jparams, jmom = _flat(js2.params), _flat(js2.opt_state["m"])
    for r, res in enumerate(world["ranks"]):
        got = res["step"][mode]
        assert list(got["params"]) == list(jparams)
        for path, want in jparams.items():
            np.testing.assert_allclose(got["params"][path], want, err_msg=f"rank {r} {path}",
                                       **STEP_TOL)
            np.testing.assert_allclose(got["m"][path], jmom[path], err_msg=f"rank {r} {path}",
                                       **STEP_TOL)
        for path, enc in js2.sc_state.residues.items():
            assert got["residues"][path].shape == (1,) + enc["q"].shape[1:]
            np.testing.assert_allclose(got["residues"][path][0], np.asarray(enc["q"])[r],
                                       err_msg=f"rank {r} residue {path}", **STEP_TOL)
        assert got["t"] == int(js2.sc_state.t) and got["step"] == int(js2.step) == 4
        keys = ["loss", "grad_norm", "lr", "nll"]
        if mode == "scalecom":
            keys += ["comm_bytes_per_worker", "comm_bytes_dense"]
        assert sorted(got["metrics"]) == sorted(keys)
        for k in keys:
            np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-4, err_msg=k)


def test_group_params_identical_across_ranks_after_three_steps(world):
    first = world["ranks"][0]["run3"]
    before = _flat(world["js"].params)
    assert any(not np.array_equal(first[p], before[p]) for p in before)
    for res in world["ranks"][1:]:
        for path, x in res["run3"].items():
            np.testing.assert_array_equal(x.view(np.uint32), first[path].view(np.uint32),
                                          err_msg=path)


@pytest.mark.parametrize("mode", ["dense", "scalecom"])
def test_counted_bytes_equal_the_plan(world, mode):
    """Each rank counts what it puts into a collective as its source; their
    mean is the plan's per-worker bytes. At chunk 64 the compressed step
    sends under a tenth of the dense one."""
    counted = [res["bytes"][mode][0] for res in world["ranks"]]
    _, per_worker, dense = world["ranks"][0]["bytes"]["scalecom"]
    mean = sum(sum(c.values()) for c in counted) / N
    if mode == "dense":
        assert all(c == {"values": 0, "indices": 0, "dense": dense, "oracle": 0, "intra": 0,
                         "stats": 0, "telemetry": 0} for c in counted)
    else:
        assert mean == per_worker
        # only the leader (t = 7: rank 3) sends offsets
        assert [c["indices"] > 0 for c in counted] == [r == 7 % N for r in range(N)]
        assert per_worker < dense / 10, (per_worker, dense)
    # chunk 16: the bytes the step counted are the plan's, as JAX reports them
    step = [res["step"][mode]["sent"] for res in world["ranks"]]
    if mode == "scalecom":
        # JAX's byte counts are float32 arrays
        assert np.float32(sum(sum(c.values()) for c in step) / N) == np.float32(
            world["jax"][mode][1]["comm_bytes_per_worker"])


@pytest.mark.parametrize("label", [r[0] for r in GROUP_CASES])
def test_group_step_refuses_what_it_does_not_run(world, label):
    """The group step refuses only an ``n_workers`` other than the group's
    size; the configurations it once refused run a step."""
    jloss = float(world["jax"]["scalecom"][1]["loss"])
    for r, res in enumerate(world["ranks"]):
        msg = res["errors"][label]
        if label == "n_workers":
            assert msg is not None and "n_workers (3) must equal group.size() (4)" in msg, msg
            continue
        assert msg is None, f"rank {r}: {msg}"
        run = res["cases"][label]
        np.testing.assert_allclose(run["metrics"]["loss"], jloss, rtol=1e-4)
        assert any(k.startswith("obs/") for k in run["metrics"]) == (label == "telemetry")
        plain = res["step"]["scalecom"]["params"]
        for path, x in run["params"].items():
            first = world["ranks"][0]["cases"][label]["params"][path]
            np.testing.assert_array_equal(x.view(np.uint32), first.view(np.uint32),
                                          err_msg=f"rank {r} {path}")
            if label.startswith("buckets"):
                np.testing.assert_allclose(x, plain[path], err_msg=path, **RING_TOL)
            elif label != "exact":
                np.testing.assert_array_equal(x.view(np.uint32), plain[path].view(np.uint32),
                                              err_msg=f"rank {r} {path}")
        payload = sum(run["sent"][k] for k in ("values", "indices", "dense"))
        assert np.float32(sum(sum(world["ranks"][q]["cases"][label]["sent"][k]
                                  for k in ("values", "indices", "dense")) for q in range(N))
                          / N) == np.float32(run["metrics"]["comm_bytes_per_worker"]), payload


def test_ring_refuses_other_compressors():
    g = torch.zeros(64)
    for comp in (CompressorConfig("true_topk", chunk=16), CompressorConfig("clt_k", exact=True)):
        with pytest.raises(ValueError, match="clt_ring_reduce runs chunked clt_k"):
            clt_ring_reduce(g, g, 0, comp, 0.1, group=None)
    with pytest.raises(ValueError, match="must be float32"):
        clt_ring_reduce(g.double(), g.double(), 0, CompressorConfig(chunk=16), 0.1, group=None)
    reducer = make_ring_reducer(None, CompressorConfig(chunk=16), 0.1)
    with pytest.raises(ValueError, match=r"\(1, size\) row"):
        reducer(torch.zeros(2, 64), torch.zeros(2, 64), 0)


def test_shard_train_state_keeps_one_row_and_copies_the_rest(world):
    js = world["js"]
    state = TrainState(params=params_from_jax(js.params, "cpu"),
                       opt_state={"m": params_from_jax(js.opt_state["m"], "cpu")},
                       sc_state=ScaleComState({p: {"q": torch.from_numpy(np.array(e["q"]))}
                                               for p, e in js.sc_state.residues.items()}, 7),
                       step=3)
    share = shard_train_state(state, 2, N)
    assert share.step == 3 and share.sc_state.t == 7
    for path, enc in state.sc_state.residues.items():
        assert torch.equal(share.sc_state.residues[path]["q"], enc["q"][2:3])
    p0 = next(iter(share.params.values()))
    p0.add_(1.0)
    assert not torch.equal(p0, next(iter(state.params.values())))
    with pytest.raises(ValueError, match=r"rank 4 is not in \[0, 4\)"):
        shard_train_state(state, 4, N)
    with pytest.raises(ValueError, match="rows of 3 workers in every field"):
        shard_train_state(state, 0, 3)
