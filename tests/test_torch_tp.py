"""The tensor-parallel train step (``build_train_step(mesh=...)``) on gloo
between processes, against the reference's unsharded step.

Four rank processes (``_torch_tp_ranks.rank_main``, spawned once for the
module, one torch thread each, rendezvous through a ``file://`` store under
the test's temporary directory) form a (2 data, 2 model) grid, then a
(1 data, 4 model) one. The reference runs in the test process meanwhile.

- The whole step: paper-transformer SMOKE and starcoder2-3b SMOKE (GQA, 4
  heads, 2 kv heads), CLT-k chunk 16, min_size 512, beta 0.1, SGD-momentum,
  1 dense + 2 compressed steps from JAX's init. Each rank's parameter slices
  after every step within rtol 2e-4 / atol 1e-5 of the slices of the
  reference's unsharded ``build_train_step`` at 2 workers (the tolerance of
  ``tests/test_distributed.py``), the loss within 1e-3. The row-parallel
  products sum in another order, so a chunk whose two largest |ef| lie
  within ``NEAR_TIE_RTOL`` may select another lane than the reference: such
  chunks are counted, checked to be near ties of the reference's own
  leader EF, and left out of the comparison from then on; any other
  difference fails. The fused step's parameters equal the unfused step's,
  bit for bit.
- The reduce, teacher-forced: a tree with a leaf whose chunks cross the
  model slices, a leaf reduced where it lies, replicated leaves and dense
  ones, at t = 0 and 1 (each data rank leads once), fused and unfused: the
  offsets bitwise the reference's (``chunk_argmax`` of the leader's ef),
  part by part; m' and ĝ within rtol 1e-6 / atol 1e-7 of JAX's stacked
  reduce; m' bitwise and ĝ within rtol 1e-6 of the port's own stacked
  reduce.
- Bytes: each data group's counted payload is the plan's for its share,
  and the shares sum over the model ranks to the unsharded plan's bytes.
- The model-axis operators on the (1, 4) grid: the vocabulary-parallel
  cross-entropy and embedding against the whole-vocabulary ones, and
  starcoder2-3b SMOKE's loss and gradients with its 64 kv columns split 16
  a rank (half a head) against the unsplit ones.
- A wrong ``n_workers`` raises, naming it, and so do the ``fsdp`` policy
  with its workers on "data" (dense-only in the reference), a layout of
  the fsdp grid without process groups and an unknown policy.
"""

import concurrent.futures
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.configs import registry as jregistry
from repro.core.chunked import chunk_argmax as jchunk_argmax
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.scalecom import scalecom_reduce as jreduce
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
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import ScaleComState
from repro_torch.distributed.sharding import specs_for_axes
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model

ARCHS = ("paper-transformer-base", "starcoder2-3b")
GRID = (2, 2)
N = GRID[0]
WORLD = GRID[0] * GRID[1]
MODES = ("dense", "scalecom", "scalecom")
CHUNK, LR = ranks.CHUNK, ranks.LR
STEP_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_distributed.py:75-76
RING_TOL = dict(rtol=1e-6, atol=1e-7)
NEAR_TIE_RTOL = 1e-5  # |ef| of two lanes this close may order either way
TIMEOUT_S = 240

# the teacher-forced tree: (shape, logical axes); at model=2 and chunk 16
# "a" splits its 24 columns 12 a rank, so its chunks cross the slices; "b"
# and "f" split into runs of whole chunks; "c" is replicated; "d" and "e"
# fall under min_size (d split, e replicated)
RED = {
    "a": ((40, 24), ("embed", "vocab")),
    "b": ((64, 48), ("vocab", "embed")),
    "c": ((600,), ("embed",)),
    "d": ((8, 16), ("embed", "mlp")),
    "e": ((100,), (None,)),
    "f": ((3, 40, 64), ("layers", "embed", "heads")),
}
RED_TS = (0, 1)
# how each compressed leaf of RED is reduced (core.plan.ShardPlan.route)
ROUTES = {"['a']": "part", "['b']": "local", "['c']": "part", "['f']": "local"}

# (label, arch, ScaleComConfig fields, build_train_step keywords, environment):
# what the step refuses (every compressor, the exact path, every codec,
# groups and compute_stats run: tests/test_torch_tp_configs.py; buckets and
# telemetry: tests/test_torch_tp_paths.py; the MoE and RWKV-6 families:
# tests/test_torch_tp_families.py; the hybrid and the encoder-decoder:
# tests/test_torch_tp_hybrid_encdec.py)
REFUSALS = [
    ("n_workers", ARCHS[0], {}, {"n_workers": 4}, {}),
    # fsdp with its workers on "data": dense-only in the reference
    ("fsdp_on_data", ARCHS[0], {}, {"policy": "fsdp"}, {}),
    # a layout of the fsdp grid without process groups
    ("fsdp_grid", ARCHS[0], {},
     {"policy": "fsdp", "mesh": Mesh(("pod", "data", "model"), (1, 2, 2))}, {}),
    ("policy", ARCHS[0], {}, {"policy": "dp"}, {}),
]
REFUSED = {"n_workers": "n_workers (4) must equal the grid's data size",
           "fsdp_on_data": "fsdp with its workers on 'data'",
           "fsdp_grid": "the fsdp step takes a ('pod', 'data', 'model') grid of process groups",
           "policy": "policy must be 'tp' or 'fsdp'"}


def _jcfg() -> JCfg:
    return JCfg(compressor=JComp("clt_k", chunk=CHUNK), beta=ranks.BETA, min_size=ranks.MIN_SIZE,
                backend="jnp", fused=False)


def _flat(t) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _step_job(arch: str):
    """The carried-across state and batches of one arch, and a function
    that runs the reference on them: params after each step, losses, and
    before each compressed step the leader's ef (residue + gradient) per
    residue path."""
    jmodel = jbuild(jregistry.smoke(arch), compute_dtype="float32", loss_chunk=16)
    jopt, jcfg = jmake_opt("sgdm"), _jcfg()
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    batches = list(jmake_batches(512, N, 2, 32, seed=1, steps=3))
    job = {"arch": arch, "params": jax.tree.map(np.asarray, js.params),
           "opt_m": jax.tree.map(np.asarray, js.opt_state["m"]),
           "residues": {p: np.asarray(e["q"]) for p, e in js.sc_state.residues.items()},
           "t": int(js.sc_state.t), "step": int(js.step), "batches": batches}

    def run(js=js):
        fns = {m: jax.jit(jbuild_step(jmodel, jopt, jschedule.constant(LR), jcfg, n_workers=N,
                                      mode=m)) for m in ("dense", "scalecom")}
        grads_fn = jax.jit(jax.vmap(jax.grad(jmodel.loss, has_aux=True), in_axes=(None, 0)))
        ref = []
        for mode, batch in zip(MODES, batches):
            ef = None
            if mode == "scalecom":
                grads, _ = grads_fn(js.params, batch)
                lead = int(js.sc_state.t) % N
                g = _flat(grads)
                ef = {p: np.asarray(e["q"])[lead] + g[p][lead].reshape(-1)
                      for p, e in js.sc_state.residues.items()}
            js, metrics = fns[mode](js, batch)
            ref.append({"params": _flat(js.params), "loss": float(metrics["loss"]), "ef": ef,
                        "bytes": float(metrics.get("comm_bytes_per_worker", 0.0))})
        return ref

    return job, run


def _reduce_job():
    rng = np.random.default_rng(3)
    shapes = {k: s for k, (s, _) in RED.items()}
    grads = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in shapes.items()}
    residues = {f"['{k}']": rng.standard_normal((N, int(np.prod(s)))).astype(np.float32)
                for k, s in shapes.items() if np.prod(s) >= ranks.MIN_SIZE}
    return {"shapes": shapes, "axes": {k: a for k, (_, a) in RED.items()}, "grads": grads,
            "residues": residues, "ts": RED_TS}


def _reduce_refs(job):
    """JAX's stacked reduce, its offsets (chunk_argmax of the leader's ef)
    and the port's own stacked reduce, per t."""
    jcfg = _jcfg()
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=ranks.BETA,
                         min_size=ranks.MIN_SIZE, backend="torch", fused=False, layout="flat")
    out = {}
    reduce = jax.jit(lambda g, s: jreduce(g, s, jcfg))
    for t in job["ts"]:
        jg = {k: jnp.asarray(g) for k, g in job["grads"].items()}
        jres = {p: {"q": jnp.asarray(q)} for p, q in job["residues"].items()}
        ghat, st, stats = reduce(jg, JState(residues=jres, t=jnp.int32(t)))
        lead = t % N
        offsets = {p: np.asarray(jchunk_argmax(jnp.asarray(q[lead] + job["grads"][p[2:-2]][lead]
                                                           .reshape(-1)), CHUNK))
                   for p, q in job["residues"].items()}
        tg, tst, tstats = scalecom_reduce(
            {k: torch.from_numpy(g) for k, g in job["grads"].items()},
            ScaleComState({p: {"q": torch.from_numpy(q)} for p, q in job["residues"].items()}, t),
            cfg)
        out[t] = {"ghat": {k: np.asarray(v) for k, v in ghat.items()},
                  "m": {p: np.asarray(e["q"]) for p, e in st.residues.items()},
                  "offsets": offsets, "bytes": float(stats["comm_bytes_per_worker"]),
                  "port_ghat": {k: v.numpy() for k, v in tg.items()},
                  "port_m": {p: e["q"].numpy() for p, e in tst.residues.items()},
                  "port_bytes": tstats["comm_bytes_per_worker"]}
    return out


def _attention_ref(jmodel, jparams, batch):
    """The reference's loss and gradients on the attention job: its
    unsplit model on the same parameters and its one worker's rows."""
    fn = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (loss, _), grads = fn(jparams, {k: jnp.asarray(v[0]) for k, v in batch.items()})
    return float(loss), _flat(grads)


def _mesh_layout(shape) -> Mesh:
    return Mesh(("data", "model"), shape)


def _specs(arch_or_shapes, shape=GRID) -> dict:
    if isinstance(arch_or_shapes, str):
        model = build_model(registry.smoke(arch_or_shapes))
        abstract, axes = model.abstract_params(), model.logical_axes()
    else:
        abstract = {k: torch.empty(s, device="meta") for k, (s, _) in arch_or_shapes.items()}
        axes = {k: a for k, (_, a) in arch_or_shapes.items()}
    return dict(tree.flatten_with_path(specs_for_axes(abstract, axes, "tp", _mesh_layout(shape))))


def _slice(x: np.ndarray, spec, coords, shape=GRID) -> np.ndarray:
    sizes = dict(zip(("data", "model"), shape))
    for d, ax in enumerate(spec):
        if ax is not None:
            w = x.shape[d] // sizes[ax]
            x = np.take(x, range(coords[ax] * w, (coords[ax] + 1) * w), axis=d)
    return x


def _whole(per_model: list, spec) -> np.ndarray:
    """The logical array from the slices of model ranks 0, 1, ..."""
    dims = [d for d, ax in enumerate(spec) if ax == "model"]
    return np.concatenate(per_model, axis=dims[0]) if dims else per_model[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(WORLD)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        steps, runs = {}, {}
        for arch in ARCHS:
            steps[arch], runs[arch] = _step_job(arch)
        red = _reduce_job()
        rng = np.random.default_rng(5)
        jmodel = jbuild(jregistry.smoke("starcoder2-3b"), compute_dtype="float32", loss_chunk=16)
        jparams, _ = jmodel.init(jax.random.PRNGKey(1))
        att_batch = next(jmake_batches(512, 1, 2, 32, seed=4))
        job = {
            "steps": steps, "fused_arch": ARCHS[0], "reduce": red, "refusals": REFUSALS,
            "batch": steps[ARCHS[0]]["batches"][0],
            "attention": {"params": jax.tree.map(np.asarray, jparams), "batch": att_batch},
            "operators": {"logits": rng.standard_normal((2, 5, 64)).astype(np.float32),
                          "labels": rng.integers(0, 64, (2, 5)).astype(np.int64),
                          "table": rng.standard_normal((64, 8)).astype(np.float32),
                          "tokens": rng.integers(0, 64, (3, 7)).astype(np.int64)},
        }
        for parent, _ in pipes:
            parent.send(job)
        # the reference while the ranks run, in threads (XLA compiles
        # without the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(len(runs) + 2) as pool:
            refs = {arch: pool.submit(run) for arch, run in runs.items()}
            red_refs = pool.submit(_reduce_refs, red)
            att_ref = pool.submit(_attention_ref, jmodel, jparams, att_batch)
            refs = {arch: f.result() for arch, f in refs.items()}
            red_refs, att_ref = red_refs.result(), att_ref.result()
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
    return {"ranks": results, "refs": refs, "red": red, "red_refs": red_refs, "job": job,
            "att_ref": att_ref}


def _by_coords(world) -> dict:
    return {(res["coords"]["data"], res["coords"]["model"]): res for res in world["ranks"]}


def _flips(ghat: np.ndarray, ef: np.ndarray) -> np.ndarray:
    """Chunks where the step's ĝ has its lane elsewhere than the
    reference's selection (``chunk_argmax`` of the leader's ef); each must
    be a near tie of that ef. Returns the flipped chunks' mask."""
    pad = (-ef.size) % CHUNK
    e = np.abs(np.pad(ef, (0, pad))).reshape(-1, CHUNK)
    a = np.pad(ghat.reshape(-1), (0, pad)).reshape(-1, CHUNK) != 0
    want = np.argmax(e, axis=1)
    lane = np.argmax(a, axis=1)
    flip = a.any(axis=1) & (lane != want)
    rows = np.nonzero(flip)[0]
    top, other = e[rows, want[rows]], e[rows, lane[rows]]
    assert np.all(top - other <= NEAR_TIE_RTOL * top), (
        f"chunks {rows[top - other > NEAR_TIE_RTOL * top]} select another lane without a near tie")
    return flip


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_reference(world, arch):
    specs, by = _specs(arch), _by_coords(world)
    refs = world["refs"][arch]
    skip = {}  # per residue path: elements of chunks that flipped so far
    flipped = 0
    for i, (mode, ref) in enumerate(zip(MODES, refs)):
        if mode == "scalecom":
            for path, ef in ref["ef"].items():
                ghat = _whole([by[(0, m)]["steps"][arch][i]["ghat"][path] for m in range(GRID[1])],
                              specs[path])
                flip = _flips(ghat, ef)
                flipped += int(flip.sum())
                mask = np.repeat(flip, CHUNK)[:ef.size].reshape(ghat.shape)
                skip[path] = skip.get(path, np.zeros_like(mask)) | mask
        for (d, m), res in by.items():
            got = res["steps"][arch][i]
            assert sorted(got["params"]) == sorted(ref["params"])
            for path, want in ref["params"].items():
                keep = ~_slice(skip[path], specs[path], {"data": d, "model": m}) \
                    if path in skip else np.ones(got["params"][path].shape, bool)
                np.testing.assert_allclose(
                    got["params"][path][keep], _slice(want, specs[path],
                                                      {"data": d, "model": m})[keep],
                    err_msg=f"{arch} step {i} rank {(d, m)} {path}", **STEP_TOL)
            assert abs(got["metrics"]["loss"] - ref["loss"]) < 1e-3
    print(f"{arch}: {flipped} chunks selected another lane at a near tie")
    assert flipped <= 4, flipped


def test_tp_fused_step_is_the_unfused_one(world):
    for res in world["ranks"]:
        for plain, fused in zip(res["steps"][ARCHS[0]], res["fused"]):
            for path, x in plain["params"].items():
                np.testing.assert_array_equal(fused["params"][path].view(np.uint32),
                                              x.view(np.uint32), err_msg=path)


def test_tp_slices_gather_to_the_same_tree_on_every_rank(world):
    specs, by = _specs(ARCHS[1]), _by_coords(world)
    for (d, m), res in by.items():
        whole = res["steps"][ARCHS[1]][-1]["gathered"]
        for path, x in whole.items():
            np.testing.assert_array_equal(
                _slice(x, specs[path], {"data": d, "model": m}),
                res["steps"][ARCHS[1]][-1]["params"][path], err_msg=path)
            np.testing.assert_array_equal(x, by[(0, 0)]["steps"][ARCHS[1]][-1]["gathered"][path])


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_bytes_are_the_plans(world, arch):
    """The payload each rank counted: averaged over a data group, its share
    of the plan; the shares summed over the model ranks, the unsharded
    plan's bytes, which are the reference's."""
    by = _by_coords(world)
    for i, mode in enumerate(MODES):
        if mode != "scalecom":
            continue
        shares = []
        for m in range(GRID[1]):
            runs = [by[(d, m)]["steps"][arch][i] for d in range(N)]
            share = runs[0]["metrics"]["comm_bytes_per_shard"]
            assert sum(r["payload"] for r in runs) / N == share
            assert all(r["metrics"]["comm_bytes_per_shard"] == share for r in runs)
            shares.append(share)
        total = runs[0]["metrics"]["comm_bytes_per_worker"]
        assert sum(shares) == total
        assert np.float32(total) == np.float32(world["refs"][arch][i]["bytes"])
        assert total < runs[0]["metrics"]["comm_bytes_dense"] / 4


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("t", RED_TS)
def test_tp_reduce_teacher_forced(world, t, fused):
    specs, by = _specs(RED), _by_coords(world)
    ref = world["red_refs"][t]
    paths = sorted(ref["offsets"])
    for m in range(GRID[1]):
        for d in range(N):
            got = by[(d, m)]["reduce"][(t, fused)]
            where = {"data": d, "model": m}
            for name in RED:
                path = f"['{name}']"
                np.testing.assert_allclose(got["ghat"][path], _slice(ref["ghat"][name],
                                           specs[path], where), err_msg=path, **RING_TOL)
                np.testing.assert_allclose(got["ghat"][path], _slice(ref["port_ghat"][name],
                                           specs[path], where), rtol=1e-6, err_msg=path)
                if path not in ref["m"]:
                    continue
                shape = RED[name][0]
                want = _slice(ref["m"][path][d].reshape(shape), specs[path], where).reshape(-1)
                np.testing.assert_allclose(got["residues"][path][0], want, err_msg=path,
                                           **RING_TOL)
                port = _slice(ref["port_m"][path][d].reshape(shape), specs[path],
                              where).reshape(-1)
                np.testing.assert_array_equal(got["residues"][path][0].view(np.uint32),
                                              port.view(np.uint32), err_msg=path)
    # the offsets: a "part" leaf's model ranks' parts, in model order, are the
    # reference's offsets of the whole leaf; a "local" leaf's slice holds the
    # reference's offsets of its own chunks
    for path in paths:
        parts = []
        for m in range(GRID[1]):
            parts.append(by[(0, m)]["reduce"][(t, fused)]["offsets"][paths.index(path)]
                         .reshape(-1))
            for d in range(1, N):
                np.testing.assert_array_equal(by[(d, m)]["reduce"][(t, fused)]["offsets"]
                                              [paths.index(path)].reshape(-1), parts[-1])
        want = ref["offsets"][path]
        if ROUTES[path] == "part":
            np.testing.assert_array_equal(np.concatenate(parts), want, err_msg=path)
            continue
        for m, ids in enumerate(_local_chunk_ids(RED[path[2:-2]][0], specs[path], CHUNK)):
            np.testing.assert_array_equal(parts[m], want[ids], err_msg=f"{path} model {m}")


def _local_chunk_ids(shape, spec, chunk) -> list:
    """Per model rank, the logical chunk ids of its slice's chunks, in its
    own flat order."""
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    return [_slice(ids, spec, {"data": 0, "model": m}).reshape(-1)[::chunk] // chunk
            for m in range(GRID[1])]


@pytest.mark.parametrize("t", RED_TS)
def test_tp_reduce_bytes_are_the_plans(world, t):
    by = _by_coords(world)
    ref = world["red_refs"][t]
    shares = []
    for m in range(GRID[1]):
        runs = [by[(d, m)]["reduce"][(t, False)] for d in range(N)]
        share = runs[0]["stats"]["comm_bytes_per_shard"]
        assert sum(r["payload"] for r in runs) / N == share
        shares.append(share)
    assert sum(shares) == runs[0]["stats"]["comm_bytes_per_worker"] == ref["port_bytes"]
    assert np.float32(ref["port_bytes"]) == np.float32(ref["bytes"])


def test_tp_residue_share_is_the_workers_slice(world):
    specs, by = _specs(RED), _by_coords(world)
    for (d, m), res in by.items():
        for path, q in world["red"]["residues"].items():
            want = _slice(q[d].reshape(RED[path[2:-2]][0]), specs[path],
                          {"data": d, "model": m}).reshape(-1)
            np.testing.assert_array_equal(res["reduce"]["share"][path][0], want)


def test_vocab_parallel_operators(world):
    job = world["job"]["operators"]
    logits, labels = torch.from_numpy(job["logits"]), torch.from_numpy(job["labels"])
    x = logits.clone().requires_grad_(True)
    whole = torch.sum(torch.logsumexp(x, -1) - torch.gather(x, -1, labels[..., None])[..., 0])
    (gx,) = torch.autograd.grad(whole, x)
    per_row = (torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0])
    table, tokens = torch.from_numpy(job["table"]), torch.from_numpy(job["tokens"])
    w = table.clone().requires_grad_(True)
    (gw,) = torch.autograd.grad(torch.sum(w[tokens] ** 2), w)
    for res in world["ranks"]:
        m, cols, rows = res["line"]["model"], logits.shape[-1] // 4, table.shape[0] // 4
        loss, g = res["operators"]["xent"]
        np.testing.assert_allclose(loss, float(whole.detach()), rtol=1e-6)
        np.testing.assert_allclose(g, gx[..., m * cols:(m + 1) * cols].numpy(), rtol=1e-5,
                                   atol=1e-7)
        lv, gv = res["operators"]["xent_vmap"]
        np.testing.assert_allclose(lv, torch.sum(per_row, -1).numpy(), rtol=1e-6)
        np.testing.assert_allclose(gv, gx[..., m * cols:(m + 1) * cols].numpy(), rtol=1e-5,
                                   atol=1e-7)
        e, gt, out = res["operators"]["embed"]
        np.testing.assert_array_equal(out, table[tokens].numpy())
        np.testing.assert_allclose(gt, gw[m * rows:(m + 1) * rows].numpy(), rtol=1e-6)


@pytest.mark.parametrize("how", ["vmap", "plain"])
def test_tp_attention_half_a_kv_head_a_rank(world, how):
    """starcoder2-3b SMOKE on (1 data, 4 model): its 2 x 32 kv columns split
    16 a rank, so each rank's q heads read kv it holds only half of; K and V
    are gathered and their cotangents summed over the model group. The
    loss and every gradient slice against the unsplit pass's."""
    specs = _specs("starcoder2-3b", (1, 4))
    assert specs["['blocks']['attn_wk']"] == (None, None, "model")
    for res in world["ranks"]:
        m = res["line"]["model"]
        att = res["attention"]
        assert att["split"] == ["heads", "kv", "mlp", "vocab"]
        loss, grads = att[how]
        want_loss, want = att["whole"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
        for path, g in grads.items():
            np.testing.assert_allclose(g, _slice(want[path], specs[path], {"data": 0, "model": m},
                                                 (1, 4)), rtol=1e-4, atol=1e-6, err_msg=path)
        assert att["calls"]["all_gather"] > 0


@pytest.mark.parametrize("how", ["vmap", "plain"])
def test_tp_attention_half_a_kv_head_a_rank_matches_reference(world, how):
    """The same split pass against the reference: ``jax.value_and_grad`` of
    its unsplit model on the same parameters and batch. The loss and each
    rank's gradient slices within the tolerance of the port's other
    gradient comparisons with JAX (``tests/_torch_arch_parity.py``)."""
    specs = _specs("starcoder2-3b", (1, 4))
    want_loss, want = world["att_ref"]
    for res in world["ranks"]:
        m = res["line"]["model"]
        loss, grads = res["attention"][how]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-4, atol=1e-5)
        assert set(grads) == set(want)
        for path, g in grads.items():
            np.testing.assert_allclose(g, _slice(want[path], specs[path], {"data": 0, "model": m},
                                                 (1, 4)), rtol=1e-4, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("label", [r[0] for r in REFUSALS])
def test_tp_refuses_what_it_does_not_run(world, label):
    for res in world["ranks"]:
        msg = res["refusals"][label]
        assert msg is not None, f"{label} ran a step"
        assert REFUSED[label] in msg, msg


def test_tp_init_is_the_stacked_inits_share(world):
    for res in world["ranks"]:
        got = res["init"]
        assert got["params"] and got["zero"]
        assert got["residues"] == got["want"]
