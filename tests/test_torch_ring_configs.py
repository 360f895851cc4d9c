"""The group train step's other configurations, on gloo between processes:
``ring.ring_reduce`` for true_topk, local_topk and random_k, the lossy
residue codecs, hierarchical groups and ``compute_stats``.

Four rank processes (``_torch_ring_config_ranks.rank_main``, spawned once
for the module, one torch thread each, rendezvous through a ``file://``
store under the test's temporary directory, so no port is taken) each hold
one ScaleCom worker. The reference runs in the test process meanwhile:
JAX's single-device ``scalecom_reduce`` and train step, which
``tests/test_distributed.py`` holds the reference's sharded step to. JAX's
random_k draws and stochastic-rounding bits for the whole (n, ...) stack go
to the ranks in the job, in place of the port's own draws.

- Each of true_topk, local_topk and random_k (top-1 and top-2; sizes 4096
  and 4133, no chunk multiple; chunk 16; t = 0..3) against JAX's stacked
  reduce: the offsets bitwise (local_topk: each rank's own row), m' and ĝ
  to rtol 1e-6 / atol 1e-7 (the collectives sum in another order), ĝ
  bitwise the same on every rank; the counted payload the plan's, the
  oracle's all-reduce of ef beside it.
- ``_group_reduce`` with bf16, fp8 and fp8_ec residues (and fp32): the
  codes bitwise JAX's; with ``groups=2`` over the 4 ranks, fp32 and fp8,
  against JAX's ``scalecom_reduce(..., groups=2)``: a code may sit one step
  from JAX's where the intra-group mean rounds differently (at most
  ``CODE_STEPS_MAX`` of them, printed), the replicas of a group's row
  bitwise each other; ``contraction_gamma`` against the port's stacked
  reduce and JAX's.
- One dense and one compressed ``build_train_step(group=...)`` step at
  ``groups=2`` with fp8 residues and ``compute_stats`` against JAX's
  single-device step: rtol 1e-4 / atol 1e-5; a world that the groups do not
  divide raises, naming n, G and the world.
- ``shard_train_state``: every field of every codec, the group's row, and
  its errors.
"""

import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ring_config_ranks as ranks
from repro.backends import resolve_backend as jresolve
from repro.configs import registry as jregistry
from repro.core import plan as jplan
from repro.core import state as jstate
from repro.core.compressors import CompressorConfig as JComp
from repro.core.compressors import select_indices as jselect
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.scalecom import scalecom_reduce as jreduce
from repro.core.state import ScaleComState as JState
from repro.data import make_batches as jmake_batches
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import init_train_state as jinit
from repro.training.train_step import build_train_step as jbuild_step
from repro_torch.core import plan as tplan
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import scalecom_reduce
from repro_torch.core.state import CODECS, ScaleComState
from repro_torch.models.convert import params_from_jax
from repro_torch.training import TrainState, shard_train_state

N = 4
SIZES, TOPMS, TS = (4096, 4133), (1, 2), (0, 1, 2, 3)
COMPRESSORS = ("true_topk", "local_topk", "random_k")
CHUNK, BETA = 16, 0.3
RING_TOL = dict(rtol=1e-6, atol=1e-7)
# ĝ of the group reduces: unit-scale values whose 4-term sum cancels keep no
# relative precision; the sum's rounding is at most 3u * sum|v| (~7e-7 here)
GHAT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# the group reduces' tree: two compressed tensors (one off the 512-element
# fp8 block) and one dense
TREE = {"a": (4133,), "b": (4096,), "c": (100,)}
MIN_SIZE = 512
REDUCE_TS = (0, 1)  # the group reduces' steps: each group leads once at groups=2
# label: (compressor, residue codec, groups, compute_stats)
REDUCES = {
    "fp32": ("clt_k", "fp32", None, True),
    "bf16": ("clt_k", "bf16", None, False),
    "fp8": ("clt_k", "fp8", None, False),
    "fp8_ec": ("clt_k", "fp8_ec", None, False),
    "groups_fp32": ("clt_k", "fp32", 2, True),
    "groups_fp8": ("clt_k", "fp8", 2, True),
    "true_topk_stats": ("true_topk", "fp32", None, True),
}
GAMMA = ("fp32", "groups_fp8", "true_topk_stats")
# codes allowed one step from JAX's, of all the fp8 codes of a run
CODE_STEPS_MAX = 0.01
STEP_GROUPS, LOCAL_B, SEQ, STEP_CHUNK, STEP_MIN_SIZE, LR = 2, 2, 32, 16, 512, 0.05
TIMEOUT_S = 240
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


def _padded(size: int) -> int:
    return -(-size // 512) * 512


def _jax_draw(t, shape, high=None):
    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
    if high is None:
        return np.array(jax.random.uniform(key, tuple(shape)))
    return np.array(jax.random.randint(key, tuple(shape), 0, high, dtype=jnp.int32))


def _jax_dither(path, t, shape):
    bits = jax.random.bits(jstate.codec_key(path, jnp.int32(t)), tuple(shape), jnp.uint32) >> 16
    return np.asarray(bits).astype(np.int32)


def _draws() -> dict:
    """JAX's random_k draws for every (t, shape, high) the ring cases ask for."""
    out = {}
    for size in SIZES:
        n_ch = -(-size // CHUNK)
        for t in TS:
            out[(t, (n_ch,), CHUNK)] = _jax_draw(t, (n_ch,), CHUNK)
            out[(t, (n_ch, CHUNK), None)] = _jax_draw(t, (n_ch, CHUNK))
    return out


def _dithers() -> dict:
    """JAX's stochastic-rounding bits for the whole (G, ...) stack of every
    compressed tensor, step and stochastically rounding codec of REDUCES."""
    out = {}
    for name, codec, groups, _ in REDUCES.values():
        if codec not in ("bf16", "fp8_ec"):
            continue
        G = groups or N
        for key, (size,) in TREE.items():
            if size < MIN_SIZE:
                continue
            shape = (G, size if codec == "bf16" else _padded(size))
            for t in REDUCE_TS:
                out[(f"['{key}']", t, shape)] = _jax_dither(f"['{key}']", t, shape)
    return out


def _jax_cfg(name, codec, groups, topm=1, min_size=MIN_SIZE) -> JCfg:
    return JCfg(compressor=JComp(name, chunk=CHUNK, topm=topm), beta=BETA, min_size=min_size,
                residue_dtype=codec, groups=groups, backend="jnp", fused=False, layout="flat")


def _ring_reference(g, m) -> dict:
    """JAX's stacked reduce of each ring case: ĝ, m' and the offsets."""
    be = jresolve("jnp")
    out = {}
    for name in COMPRESSORS:
        for size in SIZES:
            gj, mj = jnp.asarray(g[size]), jnp.asarray(m[size])
            for topm in TOPMS:
                cfg = _jax_cfg(name, "fp32", None, topm, min_size=1)

                @jax.jit
                def run(t, gj=gj, mj=mj, cfg=cfg):
                    ghat, st, _ = jreduce({"w": gj}, JState({"['w']": {"q": mj}}, t), cfg)
                    idx = jselect(mj + gj, t, cfg.compressor, be)
                    return ghat["w"], st.residues["['w']"]["q"], idx

                for t in TS:
                    out[(name, size, topm, t)] = [np.asarray(x) for x in run(jnp.int32(t))]
    return out


def _reduce_inputs(rng) -> tuple:
    """The group reduces' worker-stacked tree and, per label, its residues
    encoded by JAX's codec (random values, nearest rounding)."""
    grads = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in TREE.items()}
    residues = {}
    for label, (_, codec, groups, _) in REDUCES.items():
        G = groups or N
        residues[label] = {
            f"['{k}']": jax.tree.map(np.asarray, jstate.CODECS[codec].encode(
                jnp.asarray(rng.standard_normal((G,) + s).astype(np.float32)), s))
            for k, s in TREE.items() if s[0] >= MIN_SIZE}
    return grads, residues


def _reduce_reference(grads, residues) -> dict:
    """JAX's stacked reduce of each labelled configuration at each t, run
    eagerly."""
    out = {}
    tree_j = {k: jnp.asarray(v) for k, v in grads.items()}
    for label, (name, codec, groups, stats) in REDUCES.items():
        cfg = _jax_cfg(name, codec, groups)
        res = jax.tree.map(jnp.asarray, residues[label])
        for t in REDUCE_TS:
            # eagerly: jitted, XLA's CPU contracts Eq. 5's multiply-add into
            # an FMA, and the codes would not be bitwise
            ghat, st, got = jreduce(tree_j, JState(res, jnp.int32(t)), cfg, compute_stats=stats)
            out[(label, t)] = (jax.tree.map(np.asarray, ghat),
                               jax.tree.map(np.asarray, st.residues),
                               {k: float(v) for k, v in got.items()})
    return out


def _jax_step_state():
    """A mid-run JAX TrainState at groups=2 with fp8 residues (sgdm; non-zero
    momentum; random residues, encoded; t = 7, so group 1 leads)."""
    jmodel = jbuild(jregistry.smoke(ranks.ARCH), compute_dtype="float32", loss_chunk=16)
    jcfg = JCfg(compressor=JComp("clt_k", chunk=STEP_CHUNK), beta=0.1, min_size=STEP_MIN_SIZE,
                residue_dtype="fp8", groups=STEP_GROUPS, warmup_steps=2, backend="jnp",
                fused=False)
    jopt = jmake_opt("sgdm")
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    rng = np.random.default_rng(1)
    noise = lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    js.opt_state = {"m": jax.tree.map(noise, js.opt_state["m"])}
    # random residues for each compressed tensor's own size (its storage is padded)
    sizes = {jax.tree_util.keystr(p): int(np.prod(v.shape))
             for p, v in jax.tree_util.tree_flatten_with_path(js.params)[0]}
    residues = {p: jstate.CODECS["fp8"].encode(
        jnp.asarray(0.01 * rng.standard_normal((STEP_GROUPS, sizes[p])).astype(np.float32)),
        (sizes[p],)) for p in js.sc_state.residues}
    js.sc_state = JState(residues=residues, t=jnp.int32(7))
    js.step = jnp.int32(3)
    return jmodel, jopt, jcfg, js


def _flat(t) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _jax_steps(pipes) -> tuple:
    """The step's state, sent to the ranks; then JAX's single-device dense and
    scalecom steps from it (compute_stats on). Returns (state, {mode: (new
    state, metrics)})."""
    jmodel, jopt, jcfg, js = _jax_step_state()
    batch = next(iter(jmake_batches(512, N, LOCAL_B, SEQ, seed=2, steps=1)))
    step_job = {"params": jax.tree.map(np.asarray, js.params),
                "opt_m": jax.tree.map(np.asarray, js.opt_state["m"]),
                "residues": jax.tree.map(np.asarray, js.sc_state.residues),
                "t": int(js.sc_state.t), "step": int(js.step), "batch": batch,
                "chunk": STEP_CHUNK, "min_size": STEP_MIN_SIZE, "lr": LR, "groups": STEP_GROUPS}
    for parent, _ in pipes:
        parent.send(step_job)
    sched = jschedule.linear_warmup(jschedule.constant(LR), 2)
    out = {}
    for mode in ("dense", "scalecom"):
        fn = jax.jit(jbuild_step(jmodel, jopt, sched, jcfg, n_workers=N, mode=mode,
                                 compute_stats=True))
        out[mode] = fn(js, batch)
    return js, out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_configs")
    rng = np.random.default_rng(0)
    g = {size: rng.standard_normal((N, size)).astype(np.float32) for size in SIZES}
    m = {size: rng.standard_normal((N, size)).astype(np.float32) for size in SIZES}
    grads, residues = _reduce_inputs(rng)
    job = {
        "draws": _draws(), "dithers": _dithers(),
        "ring": {"cases": [(c, s, k) for c in COMPRESSORS for s in SIZES for k in TOPMS],
                 "g": g, "m": m, "chunk": CHUNK, "beta": BETA, "ts": TS},
        "reduce": {"reduces": REDUCES, "tree": grads, "residues": residues, "chunk": CHUNK,
                   "beta": BETA, "min_size": MIN_SIZE, "ts": REDUCE_TS},
    }
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(N)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, N, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(N)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()  # a rank that dies then breaks its pipe: no send waits on it
    try:
        for parent, _ in pipes:
            parent.send(job)
        # the step's state goes second (the ranks run the reduces meanwhile);
        # JAX compiles the references in threads beside each other
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            steps = pool.submit(_jax_steps, pipes)
            ring = pool.submit(_ring_reference, g, m)
            reduce_ref = _reduce_reference(grads, residues)
            js, jax_steps = steps.result(TIMEOUT_S)
            ring_ref = ring.result(TIMEOUT_S)
        results = []
        for r, (parent, _) in enumerate(pipes):
            assert parent.poll(TIMEOUT_S), f"rank {r} sent no result within {TIMEOUT_S} s"
            results.append(parent.recv())
        for r, p in enumerate(procs):
            p.join(TIMEOUT_S)
            assert p.exitcode == 0, f"rank {r} exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return {"g": g, "m": m, "grads": grads, "residues": residues, "ranks": results,
            "ring_ref": ring_ref, "reduce_ref": reduce_ref, "jax": jax_steps, "js": js}


@pytest.mark.parametrize("topm", TOPMS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", COMPRESSORS)
def test_ring_compressor_matches_jax_stacked_reduce(world, name, size, topm):
    for t in TS:
        jghat, jm, jidx = world["ring_ref"][(name, size, topm, t)]
        ghats = []
        for r, res in enumerate(world["ranks"]):
            idx, ghat, m_new, _ = res["ring"][(name, size, topm, t)]
            want = jidx[r] if name == "local_topk" else jidx
            np.testing.assert_array_equal(idx, want, err_msg=f"offsets t={t} rank {r}")
            np.testing.assert_allclose(m_new, jm[r], err_msg=f"m' t={t} rank {r}", **RING_TOL)
            np.testing.assert_allclose(ghat, jghat, err_msg=f"ghat t={t} rank {r}", **RING_TOL)
            ghats.append(ghat)
        for ghat in ghats[1:]:
            np.testing.assert_array_equal(_bits(ghat), _bits(ghats[0]))


@pytest.mark.parametrize("name", COMPRESSORS)
def test_ring_counts_the_plans_bytes(world, name):
    """Each rank counts what it puts into a collective as its source; the
    payload's mean over the ranks is the plan's per-worker bytes. true_topk's
    dense all-reduce of ef stands apart, under "oracle"."""
    for size in SIZES:
        for topm in TOPMS:
            k = -(-size // CHUNK) * topm
            comp = CompressorConfig(name, chunk=CHUNK, topm=topm)
            planned = tplan.payload_bytes(comp, k, N)
            assert np.float32(planned) == np.float32(
                jplan.payload_bytes(JComp(name, chunk=CHUNK, topm=topm), k, N))
            for t in TS:
                sent = [res["ring"][(name, size, topm, t)][3] for res in world["ranks"]]
                assert sum(c["values"] + c["indices"] + c["dense"] for c in sent) / N == planned
                assert all(c["values"] == 4 * k and c["dense"] == c["intra"] == c["stats"] == 0
                           for c in sent)
                if name == "true_topk":
                    assert [c["indices"] > 0 for c in sent] == [r == t % N for r in range(N)]
                    assert all(c["oracle"] == 4 * size for c in sent)
                else:
                    want = 4 * k if name == "local_topk" else 0
                    assert all(c["indices"] == want and c["oracle"] == 0 for c in sent)


def _row(label: str, rank: int) -> int:
    groups = REDUCES[label][2]
    return rank if groups is None else rank // (N // groups)


def _fp8_steps(got: np.ndarray, want: np.ndarray) -> int:
    """Codes that differ, each by at most one e4m3 step (raises otherwise)."""
    g = got.view(np.uint8).astype(np.int16)
    w = want.view(np.uint8).astype(np.int16)
    diff = g != w
    assert np.all(np.abs(g[diff] - w[diff]) <= 1), "an fp8 code more than one step from JAX's"
    return int(diff.sum())


@pytest.mark.parametrize("label", ["fp32", "bf16", "fp8", "fp8_ec"])
def test_group_reduce_codes_match_jax(world, label):
    for t in REDUCE_TS:
        jghat, jres, _ = world["reduce_ref"][(label, t)]
        for r, res in enumerate(world["ranks"]):
            got = res["reduce"][(label, t)]
            assert got["t"] == t + 1
            for path, enc in jres.items():
                assert sorted(got["residues"][path]) == sorted(enc)
                for field, want in enc.items():
                    np.testing.assert_array_equal(got["residues"][path][field][0],
                                                  _bits(want)[r], err_msg=f"{path} {field} t={t}")
            for k, want in jghat.items():
                np.testing.assert_allclose(got["ghat"][k], want, err_msg=f"ghat {k} t={t}",
                                           **GHAT_TOL)


@pytest.mark.parametrize("label", ["groups_fp32", "groups_fp8"])
def test_groups_reduce_matches_jax(world, label):
    """``groups=2`` over 4 ranks: rank r holds group r // 2's row. The
    intra-group mean is the stacked fold's, so offsets agree; a code may sit
    one step from JAX's where that mean rounds differently."""
    steps = total = 0
    for t in REDUCE_TS:
        jghat, jres, _ = world["reduce_ref"][(label, t)]
        for r, res in enumerate(world["ranks"]):
            got = res["reduce"][(label, t)]
            row = _row(label, r)
            for path, enc in jres.items():
                mine = got["residues"][path]
                if label == "groups_fp32":
                    np.testing.assert_allclose(mine["q"][0].view(np.float32), enc["q"][row],
                                               err_msg=f"{path} t={t}", **RING_TOL)
                else:
                    steps += _fp8_steps(mine["q"][0], _bits(enc["q"])[row])
                    total += mine["q"].size
                    np.testing.assert_allclose(mine["scale"][0].view(np.float32),
                                               enc["scale"][row], err_msg=f"{path} scale t={t}",
                                               **RING_TOL)
            for k, want in jghat.items():
                np.testing.assert_allclose(got["ghat"][k], want, err_msg=f"ghat {k} t={t}",
                                           **GHAT_TOL)
    if label == "groups_fp8":
        print(f"{label}: {steps} of {total} fp8 codes one step from JAX's")
        assert steps <= CODE_STEPS_MAX * total, (steps, total)


@pytest.mark.parametrize("label", ["groups_fp32", "groups_fp8"])
def test_group_replicas_are_bitwise(world, label):
    """Every rank of a group holds the same residue row and the same ĝ."""
    for t in REDUCE_TS:
        by_row = {}
        for r, res in enumerate(world["ranks"]):
            got = res["reduce"][(label, t)]
            first = by_row.setdefault(_row(label, r), got)
            for path, enc in got["residues"].items():
                for field, bits in enc.items():
                    np.testing.assert_array_equal(bits, first["residues"][path][field])
            for k, x in got["ghat"].items():
                np.testing.assert_array_equal(_bits(x), _bits(world["ranks"][0]["reduce"][
                    (label, t)]["ghat"][k]))
        assert len(by_row) == REDUCES[label][2]


@pytest.mark.parametrize("label", GAMMA)
def test_contraction_gamma_matches_stacked_port_and_jax(world, label):
    name, codec, groups, _ = REDUCES[label]
    from repro_torch.core.scalecom import ScaleComConfig

    cfg = ScaleComConfig(compressor=CompressorConfig(name, chunk=CHUNK), beta=BETA,
                         min_size=MIN_SIZE, residue_dtype=codec, groups=groups,
                         backend="torch", fused=False, layout="flat")
    stacked = {k: torch.from_numpy(v) for k, v in world["grads"].items()}
    residues = params_from_jax(world["residues"][label], "cpu")
    for t in REDUCE_TS:
        _, _, want = scalecom_reduce(stacked, ScaleComState(residues, t), cfg, compute_stats=True)
        jgamma = world["reduce_ref"][(label, t)][2]["contraction_gamma"]
        gammas = [res["reduce"][(label, t)]["stats"]["contraction_gamma"]
                  for res in world["ranks"]]
        assert len(set(gammas)) == 1, gammas
        np.testing.assert_allclose(gammas[0], float(want["contraction_gamma"]), rtol=1e-5)
        np.testing.assert_allclose(gammas[0], jgamma, rtol=1e-5)


@pytest.mark.parametrize("label", list(REDUCES))
def test_group_reduce_counts_the_plans_bytes(world, label):
    """The payload's mean over the ranks is the plan's comm_bytes_per_worker
    (JAX's, a float32); the intra-group gather, the oracle and the stats'
    all-reduce are counted apart, each rank's own rows."""
    name, _, groups, stats = REDUCES[label]
    compressed = sum(s[0] for s in TREE.values() if s[0] >= MIN_SIZE)
    for t in REDUCE_TS:
        sent = [res["reduce"][(label, t)]["sent"] for res in world["ranks"]]
        planned = world["ranks"][0]["reduce"][(label, t)]["stats"]["comm_bytes_per_worker"]
        jplanned = world["reduce_ref"][(label, t)][2]["comm_bytes_per_worker"]
        assert np.float32(planned) == np.float32(jplanned)
        assert sum(c["values"] + c["indices"] + c["dense"] for c in sent) / N == planned
        for c in sent:
            assert c["intra"] == (4 * sum(s[0] for s in TREE.values()) if groups else 0)
            assert c["stats"] == (4 * compressed if stats else 0)
            assert c["oracle"] == (4 * compressed if name == "true_topk" else 0)


@pytest.mark.parametrize("mode", ["dense", "scalecom"])
def test_group_step_groups_fp8_matches_jax(world, mode):
    js2, jm = world["jax"][mode]
    jparams, jmom = _flat(js2.params), _flat(js2.opt_state["m"])
    steps = total = 0
    for r, res in enumerate(world["ranks"]):
        got = res["step"][mode]
        assert list(got["params"]) == list(jparams)
        for path, want in jparams.items():
            np.testing.assert_allclose(got["params"][path], want, err_msg=f"rank {r} {path}",
                                       **STEP_TOL)
            np.testing.assert_allclose(got["m"][path], jmom[path], err_msg=f"rank {r} {path}",
                                       **STEP_TOL)
        for path, enc in js2.sc_state.residues.items():
            mine, row = got["residues"][path], r // (N // STEP_GROUPS)
            assert sorted(mine) == ["q", "scale"] and mine["q"].shape[0] == 1
            steps += _fp8_steps(mine["q"][0], _bits(enc["q"])[row])
            total += mine["q"].size
            np.testing.assert_allclose(mine["scale"][0].view(np.float32),
                                       np.asarray(enc["scale"])[row], err_msg=path, **STEP_TOL)
        assert got["t"] == int(js2.sc_state.t) and got["step"] == int(js2.step) == 4
        keys = ["loss", "grad_norm", "lr", "nll"]
        if mode == "scalecom":
            keys += ["comm_bytes_per_worker", "comm_bytes_dense", "contraction_gamma"]
        assert sorted(got["metrics"]) == sorted(keys)
        for k in keys:
            np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-4, err_msg=k)
    print(f"{mode}: {steps} of {total} fp8 codes one step from JAX's")
    assert steps <= CODE_STEPS_MAX * total, (steps, total)
    first = world["ranks"][0]["step"][mode]["params"]
    for res in world["ranks"][1:]:
        for path, x in res["step"][mode]["params"].items():
            np.testing.assert_array_equal(_bits(x), _bits(first[path]), err_msg=path)


def test_group_reduce_refuses_a_residue_not_the_ranks_row(world):
    for res in world["ranks"]:
        msg = res["reduce"]["not_my_row"]
        assert msg is not None and "want this rank's row" in msg, msg
        assert "('q', (4, 4608), 'float8_e4m3fn')" in msg and "(1, 4608)" in msg, msg


def test_group_step_refuses_indivisible_groups(world):
    for res in world["ranks"]:
        msg = res["indivisible"]
        assert msg is not None and "4 workers not divisible into 3 groups" in msg, msg
        assert "n=4, G=3" in msg, msg


def _stacked_state(codec: str, rows: int) -> TrainState:
    rng = np.random.default_rng(3)
    residues = {}
    for path, size in (("['a']", 1030), ("['b']", 4096)):
        x = torch.from_numpy(rng.standard_normal((rows, size)).astype(np.float32))
        residues[path] = CODECS[codec].encode(x, (size,))
    params = {"a": torch.zeros(1030), "b": torch.ones(4096)}
    return TrainState(params, {"m": {"a": torch.zeros(1030), "b": torch.zeros(4096)}},
                      ScaleComState(residues, 5), 2)


@pytest.mark.parametrize("codec", list(CODECS))
def test_shard_train_state_takes_every_field(codec):
    state = _stacked_state(codec, N)
    for rank in range(N):
        share = shard_train_state(state, rank, N)
        assert share.sc_state.t == 5 and share.step == 2
        for path, enc in state.sc_state.residues.items():
            mine = share.sc_state.residues[path]
            assert sorted(mine) == sorted(enc)
            for field, x in enc.items():
                assert mine[field].dtype == x.dtype
                assert torch.equal(mine[field].view(torch.uint8),
                                   x[rank:rank + 1].view(torch.uint8))
        mine = share.sc_state.residues["['b']"]["q"]
        assert mine.data_ptr() != state.sc_state.residues["['b']"]["q"].data_ptr()


@pytest.mark.parametrize("codec", ["fp32", "fp8_ec"])
def test_shard_train_state_takes_the_group_row(codec):
    state = _stacked_state(codec, 2)
    for rank in range(N):
        share = shard_train_state(state, rank, N, groups=2)
        for path, enc in state.sc_state.residues.items():
            for field, x in enc.items():
                row = rank // 2
                assert torch.equal(share.sc_state.residues[path][field].view(torch.uint8),
                                   x[row:row + 1].view(torch.uint8))


def test_shard_train_state_refuses_indivisible_world():
    with pytest.raises(ValueError, match="4 workers not divisible into 3 groups"):
        shard_train_state(_stacked_state("fp32", 3), 0, N, groups=3)


def test_shard_train_state_refuses_a_wrong_row_count():
    state = _stacked_state("fp8", N)
    with pytest.raises(ValueError, match=r"must hold rows of 2 workers in every field"):
        shard_train_state(state, 0, N, groups=2)
    state.sc_state.residues["['a']"]["scale"] = state.sc_state.residues["['a']"]["scale"][:3]
    with pytest.raises(ValueError, match=r"rows of 4 workers in every field.*'scale': \(3, 3\)"):
        shard_train_state(state, 0, N)
