"""The tensor-parallel step's buckets and telemetry, on gloo between
processes: ``_tp_reduce`` with ``buckets`` and ``ScaleComConfig.telemetry``
on a (2 data, 2 model) grid, against the unbucketed and telemetry-off tensor-
parallel step, JAX's stacked reduce and the port's stacked reduce.

Four rank processes (``_torch_tp_path_ranks.rank_main``, spawned once for
the module, one torch thread each, rendezvous through a ``file://`` store
under the test's temporary directory) form the grid and run every case on
their slices of ``test_torch_tp_configs.TREE``, whose leaves take every
route ("part" across the slices and replicated, "local" on whole rows and
on runs of whole chunks of the last dim, dense under min_size), at t = 0..2;
and, rowwise, on a tree with a replicated one-row leaf, of which model rank
1 has no part (it yields empty rounds where model rank 0 reduces).
The test process computes the references meanwhile: JAX's stacked
``scalecom_reduce`` (fp32 jitted, fp8 eagerly: its codes are held bitwise),
the port's stacked reduce with telemetry, and JAX's unsharded train step;
a fifth process (``_jax_taps_main``) runs JAX's telemetry reduce, whose
taps go to a collector no other reduce may share. The ranks and the port's
stacked reduce take JAX's random_k draws and stochastic-rounding bits, so
that random_k's and bf16's taps are JAX's too.

- Buckets (16 KB and 40 KB, overlap on and off, $SCALECOM_TORCH_BUCKET_MB=4;
  clt_k, true_topk, exact clt_k, flat fp8 and ``groups=1`` at 40 KB):
  offsets and m' codes bitwise the unbucketed tensor-parallel step's, ĝ
  within rtol 1e-6 / atol 1e-7 (the packed values sum in another order);
  against JAX as ``test_torch_tp_configs.py`` holds the unbucketed step.
  The ranks of each group issue the same calls over it in the same order,
  async; fewer data-axis calls than unbucketed, no more model-axis calls. The one-row tree, rowwise, at
  16 KB, with and without telemetry, the same way.
- Telemetry (bf16, rowwise fp8, true_topk, local_topk, random_k, exact
  clt_k, ``groups=1`` and the fused clt_k route with metrics_every 1;
  bucketed bf16 with compute_stats and metrics_every 2; the one-row tree
  bucketed): ĝ, m' and offsets bitwise telemetry off; the
  ``obs/`` keys JAX's; the values the same on every rank and within rtol
  1e-5 / atol 1e-6 of JAX's telemetry reduce and of the port's stacked
  reduce (the rank-based similarity taps within 0.01, counted where they
  move), but for ``fused_launches``, which counts the tensor-parallel
  leader's launches: 2 on the fused route (``fused_select_update`` and the
  scatter) where the stacked reduce taps its one fused launch, and 2 for
  random_k (no select) where it taps 3.
- ``ring.ring_rounds`` is the number of rounds ``ring.ring_steps`` yields
  for each compressor, exact and not, on every rank of a group.
- One whole SMOKE step with buckets and telemetry against the reference's
  unsharded step, within rtol 2e-4 / atol 1e-5
  (``tests/test_distributed.py:75-76``) outside near-tie chunks.
"""

import concurrent.futures
import contextlib
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_path_ranks as ranks
from repro.backends import resolve_backend as jresolve
from repro.core.compressors import select_indices as jselect
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.scalecom import scalecom_reduce as jreduce
from repro.core.state import CODECS as JCODECS
from repro.core.state import ScaleComState as JState
from repro.data import make_batches as jmake_batches
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import init_train_state as jinit
from repro.training.train_step import build_train_step as jbuild_step
from repro_torch.core import compressors as tcomp
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.plan import plan_shards, plan_tensors
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import ScaleComState
from repro_torch.distributed.ring import ring_rounds
from repro_torch.models.convert import params_from_jax
from repro_torch.training.train_step import _leader_launches
from test_torch_tp_configs import (
    BETA, CHUNK, COMPRESSED, GRID, MIN_SIZE, N, RING_TOL, STEP_TOL, TREE, WORLD, _bits,
    _chunk_ids, _cut_row, _dithered, _encode, _flat, _flips, _fold, _jax_dither, _jax_draw,
    _jcfg, _own, _slice, _specs, _step_model, _storage, _whole,
)

TS = (0, 1, 2)
TIMEOUT_S = 240
# rank taps whose values may move where the worker mean's rounding moves a
# near tie
RANK_TAPS = ("hamming_d_over_k", "topk_energy_overlap", "spearman_rho")

# label: the case's settings (ScaleComConfig fields, buckets, env, stats)
CASES = {
    "plain": dict(),
    "buckets_16k": dict(buckets=16 << 10),
    "buckets_16k_no_overlap": dict(buckets=16 << 10, overlap=False),
    "buckets_40k": dict(buckets=40 << 10),
    "buckets_40k_no_overlap": dict(buckets=40 << 10, overlap=False),
    "buckets_env": dict(buckets=None, env={"SCALECOM_TORCH_BUCKET_MB": "4"}),
    "true_topk": dict(compressor="true_topk"),
    "buckets_true_topk": dict(compressor="true_topk", buckets=40 << 10),
    "exact": dict(exact=True),
    "buckets_exact": dict(exact=True, buckets=40 << 10),
    "fp8": dict(codec="fp8"),
    "buckets_fp8": dict(codec="fp8", buckets=40 << 10),
    "groups1": dict(groups=1),
    "buckets_groups1": dict(groups=1, buckets=40 << 10),
    "bf16": dict(codec="bf16"),
    "bf16_stats": dict(codec="bf16", stats=True),
    "telemetry_bf16": dict(codec="bf16", telemetry=True, metrics_every=1),
    "rowwise_fp8": dict(codec="fp8", layout="rowwise"),
    "telemetry_rowwise_fp8": dict(codec="fp8", layout="rowwise", telemetry=True,
                                  metrics_every=1),
    "buckets_bf16_stats": dict(codec="bf16", buckets=16 << 10, stats=True),
    "telemetry_buckets_stats": dict(codec="bf16", buckets=16 << 10, stats=True, telemetry=True,
                                    metrics_every=2),
    "fused": dict(backend="cuda", fused=True),
    "telemetry_fused": dict(backend="cuda", fused=True, telemetry=True, metrics_every=1),
    "telemetry_true_topk": dict(compressor="true_topk", telemetry=True, metrics_every=1),
    "telemetry_exact": dict(exact=True, telemetry=True, metrics_every=1),
    "telemetry_groups1": dict(groups=1, telemetry=True, metrics_every=1),
    "local_topk": dict(compressor="local_topk"),
    "telemetry_local_topk": dict(compressor="local_topk", telemetry=True, metrics_every=1),
    "random_k": dict(compressor="random_k"),
    "telemetry_random_k": dict(compressor="random_k", telemetry=True, metrics_every=1),
    "rowwise_row1": dict(layout="rowwise", tree="row1"),
    "buckets_rowwise_row1": dict(layout="rowwise", tree="row1", buckets=16 << 10),
    "telemetry_buckets_rowwise_row1": dict(layout="rowwise", tree="row1", buckets=16 << 10,
                                           telemetry=True, metrics_every=1),
}
# a bucketed case: the unbucketed case it is held to
BUCKETED = {
    "buckets_16k": "plain", "buckets_16k_no_overlap": "plain", "buckets_40k": "plain",
    "buckets_40k_no_overlap": "plain", "buckets_env": "plain", "buckets_true_topk": "true_topk",
    "buckets_exact": "exact", "buckets_fp8": "fp8", "buckets_groups1": "groups1",
    "buckets_bf16_stats": "bf16_stats", "buckets_rowwise_row1": "rowwise_row1",
}
# a telemetry case: the case it is bitwise with telemetry off
TELEMETRY = {"telemetry_bf16": "bf16", "telemetry_rowwise_fp8": "rowwise_fp8",
             "telemetry_buckets_stats": "buckets_bf16_stats", "telemetry_fused": "fused",
             "telemetry_true_topk": "true_topk", "telemetry_exact": "exact",
             "telemetry_groups1": "groups1", "telemetry_local_topk": "local_topk",
             "telemetry_random_k": "random_k",
             "telemetry_buckets_rowwise_row1": "buckets_rowwise_row1"}
# the cases held against JAX's stacked reduce, with the bucketed ones
JAX_CASES = ("plain", "true_topk", "exact", "fp8", "groups1")
# the REDUCES label of test_torch_tp_configs.py whose chunks a case's reduce runs on
CHUNKS_OF = {"plain": "fp8", "true_topk": "true_topk", "fp8": "fp8", "groups1": "groups_fp8"}
# the trees: the configurations' tree, and "row1", whose replicated leaf "g" is
# one row: in the rowwise layout model rank 0 reduces it and model rank 1 has
# no part of it, and yields empty rounds in place of its reduce's
TREES = {"main": TREE,
         "row1": {"a": TREE["a"], "d": TREE["d"], "e": TREE["e"], "g": ((1, 640), (None, "embed"))}}

# the whole step: clt_k chunk 128 with buckets and telemetry from a mid-run state
STEP = dict(buckets=64 << 10, telemetry=True, metrics_every=1)
STEP_CHUNK, STEP_LR, STEP_T, STEP_MIN_SIZE, STEP_BETA = 128, 0.05, 3, 512, 0.1


def _key(case: dict):
    return (case.get("tree", "main"), case.get("codec", "fp32"), case.get("groups"),
            case.get("layout", "flat"))


def _tree(case: dict) -> dict:
    return TREES[case.get("tree", "main")]


def _compressed(case: dict) -> tuple:
    return tuple(k for k, (s, _) in _tree(case).items() if np.prod(s) >= MIN_SIZE)


def _row(case: dict, d: int) -> int:
    groups = case.get("groups")
    return d if groups is None else d // (N // groups)


def _inputs():
    """Each worker-stacked tree and its residues, encoded by JAX's codec
    (random values, nearest rounding), per (tree, codec, groups, layout);
    and JAX's random_k draws and stochastic-rounding bits for every (t,
    shape) a case asks for."""
    rng = np.random.default_rng(0)
    grads = {name: {k: rng.standard_normal((N,) + s).astype(np.float32)
                    for k, (s, _) in tree_.items()} for name, tree_ in TREES.items()}
    residues = {}
    for case in CASES.values():
        name, codec, groups, layout = _key(case)
        if _key(case) in residues:
            continue
        G = groups or N
        residues[_key(case)] = {
            f"['{k}']": jax.tree.map(np.asarray, _encode(
                jnp.asarray(rng.standard_normal((G,) + st).astype(np.float32)), codec, st))
            for k in _compressed(case) for st in [_storage(TREES[name][k][0], layout)]}
    draws, dithers = {}, {}
    for case in CASES.values():
        name, codec, groups, layout = _key(case)
        for k in _compressed(case):
            shape = TREES[name][k][0]
            lead = shape[:-1] if layout == "rowwise" else ()
            n_ch = -(-(shape[-1] if layout == "rowwise" else int(np.prod(shape))) // CHUNK)
            st = _dithered(codec, groups or N, shape, layout)
            for t in TS:
                if case.get("compressor") == "random_k" and not case.get("exact"):
                    draws[(t, lead + (n_ch,), CHUNK)] = _jax_draw(t, lead + (n_ch,), CHUNK)
                if codec in ("bf16", "fp8_ec"):
                    dithers[(f"['{k}']", t, st)] = _jax_dither(f"['{k}']", t, st)
    return grads, residues, draws, dithers


@contextlib.contextmanager
def _jax_draws_installed(draws: dict, dithers: dict):
    """The port's draws are JAX's inside ``with``, as in the ranks."""
    real = tcomp.random_draw, tstate.codec_dither
    ranks._install_draws(draws, dithers)
    try:
        yield
    finally:
        tcomp.random_draw, tstate.codec_dither = real


def _jcfg_of(case: dict, **kw) -> JCfg:
    cfg = _jcfg(case.get("compressor", "clt_k"), case.get("exact", False),
                case.get("codec", "fp32"), case.get("groups"), layout=case.get("layout", "flat"))
    return JCfg(**{**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}, **kw})


def _jax_refs(grads, residues, label: str) -> dict:
    """JAX's stacked reduce of ``label`` at each t (fp32 jitted, fp8
    eagerly) and the offsets it selected: chunked, ``select_indices`` of
    the (folded) EF; exact, ``lax.top_k`` of the leader's |EF|."""
    case = CASES[label]
    cfg = _jcfg_of(case)
    G = case.get("groups") or N
    be = jresolve("jnp")
    grads = grads["main"]
    tree_j = {k: jnp.asarray(v) for k, v in grads.items()}

    def run(res, t):
        ghat, st, _ = jreduce(tree_j, JState(res, t), cfg)
        offsets = {}
        for k in COMPRESSED:
            size = int(np.prod(TREE[k][0]))
            m = JCODECS[cfg.residue_dtype].decode(res[f"['{k}']"], (size,))
            ef = m + _fold(grads[k].reshape(N, size), G)
            if case.get("exact"):
                offsets[k] = jax.lax.top_k(jnp.abs(ef[t % G]), max(1, size // CHUNK))[1]
            else:
                offsets[k] = jselect(ef, t, cfg.compressor, be)
        return ghat, st.residues, offsets

    fn = jax.jit(run) if cfg.residue_dtype == "fp32" else run
    res = jax.tree.map(jnp.asarray, residues[_key(case)])
    return {t: jax.tree.map(np.asarray, fn(res, jnp.int32(t))) for t in TS}


def _jax_taps(grads, residues, label: str) -> dict:
    """JAX's telemetry reduce in ``label``'s settings at each t, jitted: its
    stats, taps included."""
    case = CASES[label]
    cfg = _jcfg_of(case, telemetry=True, metrics_every=case["metrics_every"],
                   fused=case.get("fused", False))
    tree_j = {k: jnp.asarray(v) for k, v in grads[case.get("tree", "main")].items()}

    def run(res, t):
        return jreduce(tree_j, JState(res, t), cfg, compute_stats=case.get("stats", False),
                       buckets=case.get("buckets", False))[2]

    fn = jax.jit(run)
    res = jax.tree.map(jnp.asarray, residues[_key(case)])
    return {t: {k: float(v) for k, v in fn(res, jnp.int32(t)).items()} for t in TS}


def _jax_taps_main(conn) -> None:
    """A spawned process beside the ranks: ``_jax_taps`` of every telemetry
    case, sent back by label. JAX's taps go to one collector shared by every
    thread of a process, which a reduce in another thread would write into;
    here no other reduce runs."""
    grads, residues = conn.recv()
    conn.send({label: _jax_taps(grads, residues, label) for label in TELEMETRY})


def _stacked_taps(grads, residues, draws, dithers, label: str) -> dict:
    """The port's stacked reduce in ``label``'s settings with telemetry and
    JAX's draws, at each t: its stats, taps included."""
    case = CASES[label]
    cfg = ranks.sc_config({"chunk": CHUNK, "beta": BETA, "min_size": MIN_SIZE}, case)
    stacked = {k: torch.from_numpy(v) for k, v in grads[case.get("tree", "main")].items()}
    rows = params_from_jax(residues[_key(case)], "cpu")
    out = {}
    with _jax_draws_installed(draws, dithers):
        for t in TS:
            _, _, stats = scalecom_reduce(stacked, ScaleComState(rows, t), cfg,
                                          compute_stats=case.get("stats", False),
                                          buckets=case.get("buckets", False))
            out[t] = {k: float(v) for k, v in stats.items()}
    return out


def _step_job():
    """A mid-run JAX TrainState (sgdm with noise momentum, random fp32
    residues, t = 3, step 3) and its batch."""
    rng = np.random.default_rng(1)
    jmodel = _step_model()
    jcfg = _jcfg("clt_k", False, "fp32", None, STEP_CHUNK, STEP_MIN_SIZE, STEP_BETA)
    base, _ = jinit(jmodel, jmake_opt("sgdm"), jcfg, jax.random.PRNGKey(0), n_workers=N)
    momentum = {"m": jax.tree.map(
        lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32)),
        base.opt_state["m"])}
    residues = {p: {"q": jnp.asarray(0.01 * rng.standard_normal(e["q"].shape).astype(np.float32))}
                for p, e in base.sc_state.residues.items()}
    js = type(base)(params=base.params, opt_state=momentum,
                    sc_state=JState(residues=residues, t=jnp.int32(STEP_T)), step=jnp.int32(3))
    batch = next(iter(jmake_batches(512, N, 2, 32, seed=2, steps=1)))
    job = {"state": {"params": jax.tree.map(np.asarray, js.params),
                     "opt_m": jax.tree.map(np.asarray, js.opt_state["m"]),
                     "residues": jax.tree.map(np.asarray, js.sc_state.residues),
                     "t": STEP_T, "step": 3},
           "case": STEP, "batch": batch, "chunk": STEP_CHUNK, "min_size": STEP_MIN_SIZE,
           "beta": STEP_BETA, "lr": STEP_LR}
    return jmodel, jcfg, js, batch, job


def _step_ref(jmodel, jcfg, js, batch) -> dict:
    """JAX's unsharded step (jitted) and each compressed tensor's selection
    key, the leader's EF, from the reference's own per-worker gradients."""
    g = _flat(jax.jit(jax.vmap(jax.grad(jmodel.loss, has_aux=True), in_axes=(None, 0)))(
        js.params, batch)[0])
    keys = {}
    for path, enc in js.sc_state.residues.items():
        size = g[path][0].size
        keys[path] = np.asarray(enc["q"][STEP_T % N]) + g[path][STEP_T % N].reshape(size)
    fn = jax.jit(jbuild_step(jmodel, jmake_opt("sgdm"), jschedule.constant(STEP_LR), jcfg,
                             n_workers=N, mode="scalecom", compute_stats=True))
    new, metrics = fn(js, batch)
    return {"params": _flat(new.params), "metrics": {k: float(v) for k, v in metrics.items()},
            "keys": keys}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_paths")
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(WORLD)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(WORLD)]
    # JAX's telemetry reduces in a process of their own beside the ranks
    pipes.append(ctx.Pipe())
    procs.append(ctx.Process(target=_jax_taps_main, args=(pipes[-1][1],), daemon=True))
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()  # a process that dies then breaks its pipe: no send waits on it
    try:
        grads, residues, draws, dithers = _inputs()
        job = {"trees": {name: {"shapes": {k: s for k, (s, _) in tree_.items()},
                                "axes": {k: a for k, (_, a) in tree_.items()},
                                "grads": grads[name]} for name, tree_ in TREES.items()},
               "residues": residues, "draws": draws, "dithers": dithers, "cases": CASES,
               "chunk": CHUNK, "beta": BETA, "min_size": MIN_SIZE, "ts": TS}
        pipes[WORLD][0].send((grads, residues))
        for parent, _ in pipes[:WORLD]:
            parent.send(job)
        # the references in threads beside each other (XLA compiles, and much
        # of eager dispatch, run without the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(len(JAX_CASES) + 1) as pool:
            step_job = pool.submit(_step_job)
            refs = {label: pool.submit(_jax_refs, grads, residues, label) for label in JAX_CASES}
            jmodel, jcfg, js, batch, job = step_job.result(TIMEOUT_S)
            for parent, _ in pipes[:WORLD]:
                parent.send(job)
            step = pool.submit(_step_ref, jmodel, jcfg, js, batch)
            stacked = {label: _stacked_taps(grads, residues, draws, dithers, label)
                       for label in TELEMETRY}
            refs = {label: f.result(TIMEOUT_S) for label, f in refs.items()}
            step = step.result(TIMEOUT_S)
        results = []
        for r, (parent, _) in enumerate(pipes):
            assert parent.poll(TIMEOUT_S), f"process {r} sent no result within {TIMEOUT_S} s"
            results.append(parent.recv())
        for r, p in enumerate(procs):
            p.join(TIMEOUT_S)
            assert p.exitcode == 0, f"process {r} exited with {p.exitcode}"
        jax_taps = results.pop()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return {"ranks": {(res["coords"]["data"], res["coords"]["model"]): res for res in results},
            "jax": refs, "jax_taps": jax_taps, "stacked": stacked, "step": step}


def _jax_label(label: str) -> str:
    return BUCKETED.get(label, label)


@pytest.mark.parametrize("label", [k for k in CASES if _jax_label(k) in JAX_CASES])
def test_tp_paths_match_jax(world, label):
    """Against JAX's stacked reduce: each rank's ĝ slice and fp32 m' within
    rtol 1e-6 / atol 1e-7, fp8's codes and scales bitwise; the unbucketed
    case's offsets (in leaf order) bitwise JAX's at the rank's chunks."""
    ref_label = _jax_label(label)
    case = CASES[label]
    specs = _specs(TREE)
    for t in TS:
        jghat, jres, joffsets = world["jax"][ref_label][t]
        for (d, m), res in world["ranks"].items():
            got = res["reduce"][(label, t)]
            assert got["t"] == t + 1
            for k in TREE:
                path = f"['{k}']"
                np.testing.assert_allclose(got["ghat"][path], _slice(jghat[k], specs[path], m),
                                           err_msg=f"{label} ghat {k} t={t}", **RING_TOL)
            for path, enc in jres.items():
                for field, want in enc.items():
                    row = want[_row(case, d)]
                    if case.get("codec", "fp32") == "fp32":
                        np.testing.assert_allclose(
                            got["residues"][path][field][0].view(np.float32),
                            _cut_row(field, row, path, m, "flat"),
                            err_msg=f"{label} m' {path} t={t}", **RING_TOL)
                    else:
                        np.testing.assert_array_equal(
                            got["residues"][path][field][0],
                            _cut_row(field, _bits(row), path, m, "flat"),
                            err_msg=f"{label} {path} {field} t={t}")
            if label in JAX_CASES:  # unbucketed: the reduces end in leaf order
                offsets = [o for _, o in got["offsets"]]
                assert len(offsets) == len(COMPRESSED)
                for k, idx in zip(COMPRESSED, offsets):
                    want = joffsets[k]
                    if not case.get("exact"):
                        want = np.asarray(want).reshape(-1)[_chunk_ids(k, m, CHUNKS_OF[label])]
                    np.testing.assert_array_equal(idx.reshape(-1), want,
                                                  err_msg=f"{label} {k} t={t} rank {(d, m)}")


def _same_outputs(got: dict, want: dict, ghat_bitwise: bool) -> int:
    """Offsets (by tensor) and every residue field bitwise; ĝ bitwise or
    within RING_TOL. Returns how many ĝ elements are not bitwise."""
    assert len(dict(want["offsets"])) == len(want["offsets"])  # one reduce a key
    assert dict(got["offsets"]).keys() == dict(want["offsets"]).keys()
    for key, idx in want["offsets"]:
        np.testing.assert_array_equal(dict(got["offsets"])[key], idx, err_msg=str(key))
    for path, enc in want["residues"].items():
        for field, bits in enc.items():
            np.testing.assert_array_equal(got["residues"][path][field], bits,
                                          err_msg=f"{path} {field}")
    differ = 0
    for path, x in want["ghat"].items():
        if ghat_bitwise:
            np.testing.assert_array_equal(_bits(got["ghat"][path]), _bits(x), err_msg=path)
        else:
            np.testing.assert_allclose(got["ghat"][path], x, err_msg=path, **RING_TOL)
            differ += int(np.sum(_bits(got["ghat"][path]) != _bits(x)))
    return differ


def _shard_plans(label: str, m: int) -> dict:
    """The port's plan of ``label``'s tree on model rank ``m``, by leaf."""
    case = CASES[label]
    cfg = ranks.sc_config({"chunk": CHUNK, "beta": BETA, "min_size": MIN_SIZE}, case)
    tree_ = _tree(case)
    specs = _specs(tree_)
    plans = plan_tensors(tuple((f"['{k}']", s, N) for k, (s, _) in tree_.items()), cfg,
                         frozenset(f"['{k}']" for k in _compressed(case)))
    return dict(zip(tree_, plan_shards(plans, [specs[f"['{k}']"] for k in tree_], GRID[1], m)))


def _axis_calls(calls, axes) -> list:
    return [c for c in calls if c[4] in axes]


@pytest.mark.parametrize("label", list(BUCKETED))
def test_tp_buckets_are_the_unbucketed_step(world, label):
    """Offsets and m' codes bitwise the unbucketed step's, ĝ within rtol
    1e-6 / atol 1e-7 (printed: how many of its elements are not bitwise).
    The ranks of each group make the same calls over it (op, dtype,
    elements, async) in the same order; every call async but the stats'
    closing all-reduce; fewer data-axis calls than
    unbucketed, no more model-axis calls; the same bytes on the model axis
    and the same payload."""
    plain = BUCKETED[label]
    stats = CASES[label].get("stats", False)
    differ = 0
    for t in TS:
        by = world["ranks"]
        for (d, m), res in by.items():
            got, want = res["reduce"][(label, t)], res["reduce"][(plain, t)]
            differ += _same_outputs(got, want, ghat_bitwise=False)
            data_axes = ("data", "intra", "inter")
            same_data = by[(1 - d, m)]["reduce"][(label, t)]["calls"]  # its data group's
            assert _axis_calls(got["calls"], data_axes) == _axis_calls(same_data, data_axes)
            same_model = by[(d, 1 - m)]["reduce"][(label, t)]["calls"]  # its model group's
            assert _axis_calls(got["calls"], ("model",)) == _axis_calls(same_model, ("model",))
            assert sum(not c[3] for c in got["calls"]) == int(stats), got["calls"]
            assert not any(c[3] for c in want["calls"])
            assert (len(_axis_calls(got["calls"], data_axes))
                    < len(_axis_calls(want["calls"], data_axes)))
            assert (len(_axis_calls(got["calls"], ("model",)))
                    <= len(_axis_calls(want["calls"], ("model",))))
            assert sum(got["model_sent"].values()) == sum(want["model_sent"].values())
            assert sum(got["model_calls"].values()) == len(_axis_calls(got["calls"], ("model",)))
            for kind in ("values", "indices", "dense", "oracle", "stats", "intra"):
                assert got["sent"][kind] == want["sent"][kind], kind
    print(f"{label}: {differ} ghat elements not bitwise the unbucketed step's")


@pytest.mark.parametrize("label", list(TELEMETRY))
def test_tp_telemetry_leaves_the_outputs_bitwise(world, label):
    """Telemetry changes no bit of the offsets, m' or ĝ, and no payload byte."""
    for t in TS:
        for res in world["ranks"].values():
            got, want = res["reduce"][(label, t)], res["reduce"][(TELEMETRY[label], t)]
            _same_outputs(got, want, ghat_bitwise=True)
            for kind in ("values", "indices", "dense", "oracle", "stats"):
                assert got["sent"][kind] == want["sent"][kind], kind


@pytest.mark.parametrize("label", list(TELEMETRY))
def test_tp_telemetry_taps_match_the_stacked_step(world, label):
    """JAX's ``obs/`` keys; every rank of the grid the same values; each
    within rtol 1e-5 / atol 1e-6 of JAX's telemetry reduce's and of the
    port's stacked reduce's (the rank-based taps within 0.01, counted where
    they move beyond), but for ``fused_launches``: the tensor-parallel
    leader's launches (``_leader_launches``), 2 on the fused route and for
    random_k, where both stacked reduces tap 1 and 3."""
    case = CASES[label]
    comp = CompressorConfig(case.get("compressor", "clt_k"), chunk=CHUNK,
                            exact=case.get("exact", False))
    fused = case.get("fused", False) and not comp.exact
    stacked_launches = 0.0 if comp.exact else (1.0 if fused else 3.0)
    moved = checked = 0
    for t in TS:
        first = world["ranks"][(0, 0)]["reduce"][(label, t)]["stats"]
        taps = {k for k in first if k.startswith("obs/")}
        for res in world["ranks"].values():
            stats = res["reduce"][(label, t)]["stats"]
            assert {k: stats[k] for k in taps} == {k: first[k] for k in taps}
        for name in ("jax_taps", "stacked"):
            want = world[name][label][t]
            keys = {k for k in want if k.startswith("obs/")}
            assert taps == keys, (name, sorted(taps - keys), sorted(keys - taps))
            for key in sorted(taps):
                got, ref = first[key], want[key]
                if key.startswith("obs/fused_launches{"):
                    assert (got, ref) == (_leader_launches(comp, fused), stacked_launches), (
                        name, key)
                elif any(key.startswith(f"obs/{tap}{{") for tap in RANK_TAPS):
                    checked += 1
                    moved += not np.isclose(got, ref, rtol=1e-5, atol=1e-6)
                    assert abs(got - ref) <= 0.01, (name, key, got, ref)
                else:
                    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                               err_msg=f"{name} {key}")
            if case.get("stats"):
                np.testing.assert_allclose(first["contraction_gamma"], want["contraction_gamma"],
                                           rtol=1e-5, err_msg=name)
    print(f"{label}: {moved} of {checked} rank-based tap values moved beyond rtol 1e-5")
    assert moved <= checked // 4


@pytest.mark.parametrize("label", list(TELEMETRY))
def test_tp_telemetry_bytes_stand_apart(world, label):
    """The taps' bytes count under ``sent["telemetry"]`` (the worker-mean
    EF's all-reduce where compute_stats does not make it, the roundtrip
    error's two floats, and on sampled steps the unit EFs and the data
    group's rank 0's three taps) or on the model axis, never in the
    payload."""
    case = CASES[label]
    every = case["metrics_every"]
    for t in TS:  # no similarity taps over one group (the stacked step's G >= 2)
        sampled = t % every == 0 and (case.get("groups") or N) >= 2
        for (d, m), res in world["ranks"].items():
            got = res["reduce"][(label, t)]
            off = res["reduce"][(TELEMETRY[label], t)]
            want = 0
            for k, sp in _shard_plans(label, m).items():
                if k in _compressed(case):
                    want += (0 if case.get("stats") else 4 * _own(sp, m)) + 8
                    if sampled:
                        want += 4 * (sp.plan.size + 1) + (12 if d == 0 else 0)
            assert got["sent"]["telemetry"] == want, (t, d, m, got["sent"])
            assert off["sent"]["telemetry"] == 0
            assert got["sent"]["stats"] == off["sent"]["stats"]
            assert sum(got["model_sent"].values()) > sum(off["model_sent"].values())


def test_tp_step_with_buckets_and_telemetry_matches_reference(world):
    """One compressed SMOKE step with 64 KB buckets and telemetry: each
    rank's parameter slices within rtol 2e-4 / atol 1e-5 of the reference's
    unsharded step outside chunks that selected another lane at a near
    tie, the loss and contraction_gamma the reference's, the taps the same
    on every rank."""
    ref = world["step"]
    specs = _specs(ranks.ARCH)
    by = world["ranks"]
    skip, flipped = {}, 0
    for path, key in ref["keys"].items():
        ghat = _whole([by[(0, m)]["step"]["ghat"][path] for m in range(GRID[1])], specs[path])
        flip = _flips(ghat, key, STEP_CHUNK)
        flipped += int(flip.sum())
        skip[path] = np.repeat(flip, STEP_CHUNK)[:key.size].reshape(ghat.shape)
    first = by[(0, 0)]["step"]["metrics"]
    taps = {k for k in first if k.startswith("obs/")}
    assert taps
    for (d, m), res in by.items():
        got = res["step"]
        assert sorted(got["params"]) == sorted(ref["params"])
        for path, want in ref["params"].items():
            keep = ~_slice(skip[path], specs[path], m) if path in skip else slice(None)
            np.testing.assert_allclose(got["params"][path][keep],
                                       _slice(want, specs[path], m)[keep],
                                       err_msg=f"rank {(d, m)} {path}", **STEP_TOL)
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["contraction_gamma"],
                                   ref["metrics"]["contraction_gamma"], rtol=1e-4)
        assert {k: v for k, v in got["metrics"].items() if k in taps} == {
            k: first[k] for k in taps}
    print(f"step: {flipped} chunks selected another lane at a near tie")
    assert flipped <= 4, flipped


@pytest.mark.parametrize("exact", [False, True], ids=["chunked", "exact"])
@pytest.mark.parametrize("compressor", ["clt_k", "true_topk", "random_k", "local_topk"])
def test_ring_rounds_counts_the_rounds_of_ring_steps(world, compressor, exact):
    """``ring.ring_rounds``, the empty rounds a rank with no part of a
    tensor yields in step with the others, is what ``ring_steps`` yields
    on every rank of the data group, leader or not."""
    want = ring_rounds(CompressorConfig(compressor, chunk=8, exact=exact))
    assert {res["rounds"][(compressor, exact)] for res in world["ranks"].values()} == {want}
