"""The tensor-parallel step's other configurations, on gloo between
processes: every compressor, the exact path, the lossy residue codecs,
``groups`` and ``compute_stats`` on a (2 data, 2 model) grid, against the
reference's unsharded reduce and step.

Four rank processes (``_torch_tp_config_ranks.rank_main``, spawned once for
the module, one torch thread each, rendezvous through a ``file://`` store
under the test's temporary directory) form the grid. The reference runs in
the test process meanwhile: JAX's stacked ``scalecom_reduce`` (eagerly,
since jitted, XLA's CPU contracts Eq. 5 into an FMA and the lossy codes
would not be bitwise) and its unsharded train step, which
``tests/test_distributed.py`` holds the reference's sharded step to. JAX's
random_k draws and stochastic-rounding bits for the whole stack go to the
ranks in the job, in place of the port's own draws.

- Teacher-forced reduces over a tree whose leaves take every route: "a"
  splits its 24 columns 12 a rank, so its chunks (16) and its fp8 blocks
  (512) cross the slices ("part"); "f" splits its last dim into runs of
  whole chunks whose fp8 blocks cross the slices ("local", not consecutive
  logical chunks); "b" splits rows ("local"); "c" is replicated ("part");
  "d" and "e" fall under min_size. For true_topk, local_topk and random_k
  (true_topk fused too), the exact path of all four (t = 0..2, or 0..1)
  and random_k in the rowwise layout (whose "a" and "f" split their last
  dim, "b" whole rows): the offsets bitwise JAX's (local_topk: each
  worker's own; chunked: each rank's logical chunks'; exact: the k logical
  offsets), m' and ĝ to rtol 1e-6 / atol 1e-7, ĝ bitwise the same on both
  ranks of a model index. For bf16, fp8 and fp8_ec residues (clt_k; fp8 and
  fp8_ec in the rowwise layout too, whose per-row scales cross the slices
  of "a" and "f"): the codes of each slice, joined back into the row,
  bitwise JAX's, each slice's fields the row's at its positions, fp8's
  scales the logical blocks' or rows'; with
  ``groups=1`` (the 2 workers of a data line averaged into one group: the
  fold of ``groups=2`` over 4 workers, n/G = 2) and fp8, a code at most one
  step from JAX's where the intra-group mean rounds differently.
  ``contraction_gamma`` against JAX's. The payload each data group counted
  is its share of the plan, the shares summing to JAX's bytes.
- A NaN in a block or row of fp8's scales that crosses the slices (flat
  fp8 and rowwise fp8_ec, on leaf "a", held by model rank 0 or 1): the codes
  and scales bitwise JAX's stacked encode (scale 1.0 there).
- The share: ``shard_train_state(mesh=, groups=)`` of every codec's stacked
  residues, joined back (``train_state_from_shard``), bitwise JAX's row;
  ``init_train_state(mesh=)`` of every codec, with and without groups, the
  same fields, shapes and dtypes, zero.
- Whole steps of paper-transformer SMOKE at chunk 128 (lm_head and the
  expert-free MLP reduced where they lie, the attention's column slices in
  parts) from a mid-run JAX state: one dense step, and a compressed step of
  true_topk, of fp8 with ``groups=1`` and ``compute_stats``, and of bf16:
  the parameter slices within rtol 2e-4 / atol 1e-5 of the reference's
  unsharded step (``tests/test_distributed.py:75-76``) outside chunks that
  selected another lane at a near tie (counted, checked against the
  reference's own EF), ``contraction_gamma`` against the reference's, and
  the payload summed over the model ranks the logical plan's.
"""

import concurrent.futures
import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tp_config_ranks as ranks
from _torch_tp_refs import jax_dither as _jax_dither
from _torch_tp_refs import jax_draw as _jax_draw
from _torch_tp_refs import padded as _padded
from repro.backends import resolve_backend as jresolve
from repro.configs import registry as jregistry
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
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.plan import plan_shards, plan_tensors
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.distributed import slices
from repro_torch.distributed.sharding import specs_for_axes
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model

GRID = (2, 2)
N = GRID[0]
WORLD = GRID[0] * GRID[1]
CHUNK, BETA, MIN_SIZE = 16, 0.3, 512
RING_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_distributed.py:75-76
NEAR_TIE_RTOL = 1e-5  # |key| of two lanes this close may order either way
CODE_STEPS_MAX = 0.01  # codes one step from JAX's, of all the fp8 codes, under groups
TIMEOUT_S = 240
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}

# the teacher-forced tree: (shape, logical axes)
TREE = {
    "a": ((40, 24), ("embed", "vocab")),
    "b": ((64, 48), ("vocab", "embed")),
    "c": ((600,), ("embed",)),
    "d": ((8, 16), ("embed", "mlp")),
    "e": ((100,), (None,)),
    "f": ((3, 40, 64), ("layers", "embed", "heads")),
}
COMPRESSED = ("a", "b", "c", "f")  # leaf order
TS3, TS2 = (0, 1, 2), (0, 1)
# label: (compressor, exact, codec, groups, fused, compute_stats, steps, layout); in
# the rowwise layout "a" and "f" split their last dim ("f" in runs of whole
# chunks a row, so fp8's per-row scales cross the slices) and "b" whole rows
REDUCES = {
    "true_topk": ("true_topk", False, "fp32", None, False, True, TS3, "flat"),
    "true_topk_fused": ("true_topk", False, "fp32", None, True, False, TS3, "flat"),
    "local_topk": ("local_topk", False, "fp32", None, False, False, TS3, "flat"),
    "random_k": ("random_k", False, "fp32", None, False, False, TS3, "flat"),
    "clt_k_exact": ("clt_k", True, "fp32", None, False, False, TS3, "flat"),
    "true_topk_exact": ("true_topk", True, "fp32", None, False, True, TS3, "flat"),
    "local_topk_exact": ("local_topk", True, "fp32", None, False, True, TS2, "flat"),
    "random_k_exact": ("random_k", True, "fp32", None, False, False, TS2, "flat"),
    "rowwise_random_k": ("random_k", False, "fp32", None, False, False, TS2, "rowwise"),
    "bf16": ("clt_k", False, "bf16", None, False, False, TS2, "flat"),
    "fp8": ("clt_k", False, "fp8", None, False, False, TS2, "flat"),
    "fp8_ec": ("clt_k", False, "fp8_ec", None, False, False, TS2, "flat"),
    "rowwise_fp8": ("clt_k", False, "fp8", None, False, False, TS2, "rowwise"),
    "rowwise_fp8_ec": ("clt_k", False, "fp8_ec", None, False, False, TS2, "rowwise"),
    "groups_fp8": ("clt_k", False, "fp8", 1, False, True, TS2, "flat"),
}
COMPRESSOR_LABELS = ("true_topk", "true_topk_fused", "local_topk", "random_k", "clt_k_exact",
                     "true_topk_exact", "local_topk_exact", "random_k_exact",
                     "rowwise_random_k")
COMPRESSOR_CASES = [(label, t) for label in COMPRESSOR_LABELS for t in REDUCES[label][6]]
CODEC_LABELS = ("bf16", "fp8", "fp8_ec", "rowwise_fp8", "rowwise_fp8_ec")
CODEC_CASES = [(label, t) for label in CODEC_LABELS for t in REDUCES[label][6]]
GAMMA_LABELS = ("true_topk", "true_topk_exact", "local_topk_exact", "groups_fp8")

# a NaN in leaf "a" (split on its last dim, 12 columns a model rank) at row 5,
# in a flat fp8 block and a rowwise row that cross the slices: column by the
# model rank that holds it
NAN_COLUMN = {0: 3, 1: 15}
NAN_CASES = [(codec, layout, holder) for codec, layout in (("fp8", "flat"), ("fp8_ec", "rowwise"))
             for holder in NAN_COLUMN]

# the whole steps: label: (compressor, codec, groups, compute_stats, modes)
STEP_CHUNK, STEP_LR, STEP_T = 128, 0.05, 3
STEPS = {
    "true_topk": ("true_topk", "fp32", None, False, ("dense", "scalecom")),
    "fp8_groups_stats": ("clt_k", "fp8", 1, True, ("scalecom",)),
    "bf16": ("clt_k", "bf16", None, False, ("scalecom",)),
}
STEP_CASES = [("true_topk", "dense")] + [(label, "scalecom") for label in STEPS]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


@functools.partial(jax.jit, static_argnums=(1, 2))
def _encode(x, codec: str, shape):
    return jstate.CODECS[codec].encode(x, shape)


def _dither_shape(codec: str, rows: int, size: int):
    return (rows, size if codec == "bf16" else _padded(size))


def _storage(shape, layout: str):
    """A leaf's residue storage (no row axis): its shape in the rowwise
    layout, one axis in the flat one (and for a 1-D leaf in both)."""
    return tuple(shape) if layout == "rowwise" else (int(np.prod(shape)),)


def _dithered(codec: str, rows: int, shape, layout: str):
    """The shape of the stack a codec's stochastic rounding draws over."""
    store = _storage(shape, layout)
    if codec == "bf16" or len(store) > 1:
        return (rows,) + store
    return (rows, _padded(store[0]))


def _exact_random_keys(t: int, size: int, k: int) -> np.ndarray:
    """Keys whose top-k are JAX's ``choice(replace=False)`` offsets of the
    exact random_k path, in its order."""
    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
    chosen = np.asarray(jax.random.choice(key, size, (k,), replace=False))
    keys = np.full(size, -1.0, np.float32)
    keys[chosen] = np.arange(k, 0, -1, dtype=np.float32)
    return keys


def _jcfg(name, exact, codec, groups, chunk=CHUNK, min_size=MIN_SIZE, beta=BETA,
          layout="flat") -> JCfg:
    return JCfg(compressor=JComp(name, chunk=chunk, exact=exact), beta=beta, min_size=min_size,
                residue_dtype=codec, groups=groups, backend="jnp", fused=False, layout=layout)


# -- the teacher-forced reduces ---------------------------------------------------


def _reduce_job(rng) -> dict:
    """The worker-stacked tree and, per label, its residues encoded by
    JAX's codec (random values, nearest rounding), with JAX's draws and
    dither bits for every (step, shape) the ranks ask for."""
    grads = {k: rng.standard_normal((N,) + s).astype(np.float32) for k, (s, _) in TREE.items()}
    residues, draws, dithers, coded = {}, {}, {}, {}
    for label, (name, exact, codec, groups, _, _, t_list, layout) in REDUCES.items():
        G = groups or N
        if (codec, G, layout) not in coded:  # one set of residues a codec, row count, layout
            coded[(codec, G, layout)] = {
                f"['{k}']": jax.tree.map(np.asarray, _encode(
                    jnp.asarray(rng.standard_normal((G,) + st).astype(np.float32)), codec, st))
                for k in COMPRESSED for st in [_storage(TREE[k][0], layout)]}
        residues[label] = coded[(codec, G, layout)]
        for k in COMPRESSED:
            shape = TREE[k][0]
            size = int(np.prod(shape))
            lead = shape[:-1] if layout == "rowwise" else ()
            n_ch = -(-(shape[-1] if layout == "rowwise" else size) // CHUNK)
            for t in t_list:
                if name == "random_k" and exact:
                    draws[(t, (size,), None)] = _exact_random_keys(t, size,
                                                                   max(1, size // CHUNK))
                elif name == "random_k":
                    draws[(t, lead + (n_ch,), CHUNK)] = _jax_draw(t, lead + (n_ch,), CHUNK)
                if codec in ("bf16", "fp8_ec"):
                    st = _dithered(codec, G, shape, layout)
                    dithers[(f"['{k}']", t, st)] = _jax_dither(f"['{k}']", t, st)
    nan = {}
    for codec, layout, holder in NAN_CASES:
        row = rng.standard_normal((1,) + TREE["a"][0]).astype(np.float32)
        row[0, 5, NAN_COLUMN[holder]] = np.nan
        nan[(codec, layout, holder)] = row.reshape((1,) + _storage(TREE["a"][0], layout))
    return {"grads": grads, "residues": residues, "draws": draws, "dithers": dithers, "nan": nan}


def _fold(x: np.ndarray, G: int) -> jnp.ndarray:
    return jnp.mean(jnp.asarray(x).reshape((G, x.shape[0] // G) + x.shape[1:]), axis=1)


def _reduce_refs(job: dict, labels) -> dict:
    """JAX's stacked reduce of each of ``labels`` at each t, and the offsets
    it selected: chunked, ``select_indices`` of the (folded) EF; exact,
    ``lax.top_k`` of the leader's |EF| (clt_k) or the mean's. fp32 residues
    jitted (Eq. 5 contracted into an FMA moves m' by an ulp, inside the
    tolerance); the lossy codecs eagerly, whose codes are held bitwise."""
    be = jresolve("jnp")
    tree_j = {k: jnp.asarray(v) for k, v in job["grads"].items()}
    out = {}
    for label in labels:
        name, exact, codec, groups, _, stats, t_list, layout = REDUCES[label]
        cfg = _jcfg(name, exact, codec, groups, layout=layout)
        G = groups or N

        def run(res, t, cfg=cfg, G=G, name=name, exact=exact, codec=codec, stats=stats,
                layout=layout):
            ghat, st, got = jreduce(tree_j, JState(res, t), cfg, compute_stats=stats)
            offsets = {}
            for k in COMPRESSED:
                size = int(np.prod(TREE[k][0]))
                store = _storage(TREE[k][0], layout)
                m = jstate.CODECS[codec].decode(res[f"['{k}']"], store)
                ef = m + _fold(job["grads"][k].reshape((N,) + store), G)
                k_exact = max(1, size // CHUNK)
                if exact and name == "local_topk":
                    offsets[k] = jax.vmap(lambda e: jax.lax.top_k(jnp.abs(e), k_exact)[1])(ef)
                elif exact and name == "random_k":
                    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
                    offsets[k] = jax.random.choice(key, size, (k_exact,), replace=False)
                elif exact:
                    key = ef[t % G] if name == "clt_k" else jnp.mean(ef, axis=0)
                    offsets[k] = jax.lax.top_k(jnp.abs(key), k_exact)[1]
                else:
                    offsets[k] = jselect(ef, t, cfg.compressor, be)
            return ghat, st.residues, got, offsets

        fn = jax.jit(run) if codec == "fp32" else run
        res = jax.tree.map(jnp.asarray, job["residues"][label])
        for t in t_list:
            ghat, residues, got, offsets = jax.tree.map(np.asarray, fn(res, jnp.int32(t)))
            out[(label, t)] = {"ghat": ghat, "residues": residues, "offsets": offsets,
                               "stats": {k: float(v) for k, v in got.items()}}
    return out


# -- the whole steps --------------------------------------------------------------


def _step_model():
    return jbuild(jregistry.smoke(ranks.ARCH), compute_dtype="float32", loss_chunk=16)


def _step_states(jmodel, rng) -> dict:
    """Per label, a mid-run JAX TrainState: sgdm with noise momentum (one
    init and momentum for all), random residues in the label's codec (G
    rows), t = 3, step 3."""
    jopt = jmake_opt("sgdm")
    first = _jcfg("clt_k", False, "fp32", None, STEP_CHUNK, 512, 0.1)
    base, _ = jinit(jmodel, jopt, first, jax.random.PRNGKey(0), n_workers=N)
    momentum = {"m": jax.tree.map(
        lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32)),
        base.opt_state["m"])}
    sizes = {jax.tree_util.keystr(p): int(np.prod(v.shape))
             for p, v in jax.tree_util.tree_flatten_with_path(base.params)[0]}
    out = {}
    for label, (name, codec, groups, _, _) in STEPS.items():
        jcfg = _jcfg(name, False, codec, groups, STEP_CHUNK, 512, 0.1)
        G = groups or N
        residues = {p: _encode(jnp.asarray(
            0.01 * rng.standard_normal((G, sizes[p])).astype(np.float32)), codec, (sizes[p],))
            for p in base.sc_state.residues}
        js = type(base)(params=base.params, opt_state=momentum,
                        sc_state=JState(residues=residues, t=jnp.int32(STEP_T)),
                        step=jnp.int32(3))
        out[label] = (jcfg, js)
    return out


def _flat(t) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _step_grads(jmodel, params, batch) -> dict:
    """The reference's per-worker gradients (one for all labels: the states
    share their parameters)."""
    fn = jax.jit(jax.vmap(jax.grad(jmodel.loss, has_aux=True), in_axes=(None, 0)))
    return _flat(fn(params, batch)[0])


def _step_refs(jmodel, states, batch, label, g) -> dict:
    """JAX's unsharded steps from ``label``'s state (jitted), and the key
    each compressed tensor's selection ran on (the leader's EF, or the
    mean's), from the reference's own per-worker gradients ``g``."""
    jopt = jmake_opt("sgdm")
    out = {}
    for name, codec, groups, stats, modes in [STEPS[label]]:
        jcfg, js = states[label]
        G = groups or N
        keys = {}
        for path, enc in js.sc_state.residues.items():
            size = g[path][0].size
            ef = jstate.CODECS[codec].decode(enc, (size,)) + _fold(g[path].reshape(N, size), G)
            keys[path] = np.asarray(ef[STEP_T % G] if name == "clt_k" else jnp.mean(ef, axis=0))
        for mode in modes:
            fn = jax.jit(jbuild_step(jmodel, jopt, jschedule.constant(STEP_LR), jcfg,
                                     n_workers=N, mode=mode, compute_stats=stats))
            new, metrics = fn(js, batch)
            out[(label, mode)] = {"params": _flat(new.params),
                                  "metrics": {k: float(v) for k, v in metrics.items()},
                                  "keys": keys}
    return out


def _step_job(states, batch) -> dict:
    dithers = {}
    for label, (name, codec, groups, _, _) in STEPS.items():
        _, js = states[label]
        if codec not in ("bf16", "fp8_ec"):
            continue
        for path, enc in js.sc_state.residues.items():
            size = int(np.prod(enc["q"].shape[1:])) if codec == "bf16" else None
            shape = (groups or N, size) if codec == "bf16" else tuple(enc["c"].shape)
            dithers[(path, STEP_T, shape)] = _jax_dither(path, STEP_T, shape)
    return {"states": {label: {"params": jax.tree.map(np.asarray, js.params),
                               "opt_m": jax.tree.map(np.asarray, js.opt_state["m"]),
                               "residues": jax.tree.map(np.asarray, js.sc_state.residues),
                               "t": int(js.sc_state.t), "step": int(js.step)}
                       for label, (_, js) in states.items()},
            "configs": STEPS, "batch": batch, "chunk": STEP_CHUNK, "min_size": 512, "beta": 0.1,
            "lr": STEP_LR, "dithers": dithers}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_configs")
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(WORLD)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()  # a rank that dies then breaks its pipe: no send waits on it
    try:
        # the jobs while the ranks start
        red = _reduce_job(np.random.default_rng(0))
        job = {"draws": red.pop("draws"), "dithers": red.pop("dithers"),
               "reduce": {"shapes": {k: s for k, (s, _) in TREE.items()},
                          "axes": {k: a for k, (_, a) in TREE.items()}, "grads": red["grads"],
                          "residues": red["residues"], "configs": REDUCES, "chunk": CHUNK,
                          "beta": BETA, "min_size": MIN_SIZE, "nan": red["nan"]}}
        for parent, _ in pipes:
            parent.send(job)
        # the references in threads beside each other (XLA compiles, and
        # much of eager dispatch, run without the interpreter lock): the
        # reduces from now, the steps once their states exist
        groups = [COMPRESSOR_LABELS[i:i + 3] for i in range(0, len(COMPRESSOR_LABELS), 3)] + [
            (label,) for label in REDUCES if label not in COMPRESSOR_LABELS]
        with concurrent.futures.ThreadPoolExecutor(len(STEPS) + len(groups)) as pool:
            reds = [pool.submit(_reduce_refs, red, labels) for labels in groups]
            jmodel = _step_model()
            states = _step_states(jmodel, np.random.default_rng(1))
            batch = next(iter(jmake_batches(512, N, 2, 32, seed=2, steps=1)))
            step_job = _step_job(states, batch)
            for parent, _ in pipes:
                parent.send(step_job)
            g = _step_grads(jmodel, states["true_topk"][1].params, batch)
            steps = [pool.submit(_step_refs, jmodel, states, batch, label, g) for label in STEPS]
            red_refs, step_refs = {}, {}
            for f in reds:
                red_refs.update(f.result(TIMEOUT_S))
            for f in steps:
                step_refs.update(f.result(TIMEOUT_S))
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
    return {"ranks": {(res["coords"]["data"], res["coords"]["model"]): res for res in results},
            "red": red, "red_refs": red_refs, "step_refs": step_refs}


def _specs(tree_or_arch, shape=GRID) -> dict:
    if isinstance(tree_or_arch, str):
        model = build_model(registry.smoke(tree_or_arch))
        abstract, axes = model.abstract_params(), model.logical_axes()
    else:
        import torch

        abstract = {k: torch.empty(s, device="meta") for k, (s, _) in tree_or_arch.items()}
        axes = {k: a for k, (_, a) in tree_or_arch.items()}
    return dict(tree.flatten_with_path(specs_for_axes(abstract, axes, "tp",
                                                      Mesh(("data", "model"), shape))))


def _slice(x: np.ndarray, spec, m: int) -> np.ndarray:
    for d, ax in enumerate(spec):
        if ax == "model":
            w = x.shape[d] // GRID[1]
            x = np.take(x, range(m * w, (m + 1) * w), axis=d)
    return x


def _whole(per_model: list, spec) -> np.ndarray:
    dims = [d for d, ax in enumerate(spec) if ax == "model"]
    return np.concatenate(per_model, axis=dims[0]) if dims else per_model[0]


def _shards(label: str, m: int) -> dict:
    """The port's plan of the tree on model rank ``m``, by leaf."""
    name, exact, codec, groups, _, _, _, layout = REDUCES[label]
    cfg = ScaleComConfig(compressor=CompressorConfig(name, chunk=CHUNK, exact=exact),
                         min_size=MIN_SIZE, residue_dtype=codec, groups=groups, layout=layout)
    specs = _specs(TREE)
    plans = plan_tensors(tuple((f"['{k}']", s, N) for k, (s, _) in TREE.items()), cfg,
                         frozenset(f"['{k}']" for k in COMPRESSED))
    got = plan_shards(plans, [specs[f"['{k}']"] for k in TREE], GRID[1], m)
    return {k: sp for k, sp in zip(TREE, got)}


def _chunk_ids(k: str, m: int, label: str) -> np.ndarray:
    """The logical chunks of model rank ``m``'s rows of leaf ``k`` under
    ``label``'s layout (flat: chunks of the flat view; rowwise: of each
    row, numbered row by row), in the order its reduce runs them."""
    sp = _shards(label, m)[k]
    shape = TREE[k][0]
    if len(sp.plan.work) > 1:  # rowwise
        per_row = -(-shape[-1] // CHUNK)
        ids = np.arange(sp.plan.n_chunks).reshape(shape[:-1] + (per_row,))
        if sp.route == "part":
            lo, hi = sp.bounds[m]
            return ids.reshape(-1, per_row)[lo:hi].reshape(-1)
        w = ids.shape[sp.dim] // GRID[1]
        return np.take(ids, range(m * w, (m + 1) * w), axis=sp.dim).reshape(-1)
    if sp.route == "part":
        lo, hi = sp.bounds[m]
        return np.arange(lo, hi)
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    return _slice(ids, _specs(TREE)[f"['{k}']"], m).reshape(-1)[::CHUNK] // CHUNK


@pytest.mark.parametrize("label,t", COMPRESSOR_CASES)
def test_tp_compressor_matches_jax_stacked_reduce(world, label, t):
    name, exact = REDUCES[label][:2]
    ref = world["red_refs"][(label, t)]
    specs = _specs(TREE)
    for (d, m), res in world["ranks"].items():
        got = res["reduce"][(label, t)]
        assert got["t"] == t + 1
        assert len(got["offsets"]) == len(COMPRESSED)
        for k, idx in zip(COMPRESSED, got["offsets"]):
            want = ref["offsets"][k]
            if name == "local_topk":
                want = want[d]
            if not exact:
                want = want.reshape(-1)[_chunk_ids(k, m, label)]
            np.testing.assert_array_equal(idx.reshape(-1), want,
                                          err_msg=f"{label} {k} t={t} rank {(d, m)}")
        for k, (shape, _) in TREE.items():
            path = f"['{k}']"
            np.testing.assert_allclose(got["ghat"][path], _slice(ref["ghat"][k], specs[path], m),
                                       err_msg=f"{label} ghat {k} t={t}", **RING_TOL)
            other = world["ranks"][(1 - d, m)]["reduce"][(label, t)]["ghat"][path]
            np.testing.assert_array_equal(_bits(got["ghat"][path]), _bits(other))
            if k in COMPRESSED:
                np.testing.assert_allclose(got["rows"][path]["q"][0].view(np.float32),
                                           ref["residues"][path]["q"][d],
                                           err_msg=f"{label} m' {k} t={t}", **RING_TOL)


def _fp8_steps(got: np.ndarray, want: np.ndarray) -> int:
    """Codes that differ, each by at most one e4m3 step (raises otherwise)."""
    g = got.view(np.uint8).astype(np.int16)
    w = want.view(np.uint8).astype(np.int16)
    diff = g != w
    assert np.all(np.abs(g[diff] - w[diff]) <= 1), "an fp8 code more than one step from JAX's"
    return int(diff.sum())


def _slice_of(path: str, m: int) -> slices.Slice:
    shape = TREE[path[2:-2]][0]
    dim = next((i for i, ax in enumerate(_specs(TREE)[path]) if ax == "model"), None)
    return slices.Slice(shape, [] if dim is None else [(dim, "model", GRID[1], m)])


def _cut_row(field: str, row: np.ndarray, path: str, m: int, layout: str) -> np.ndarray:
    """Model rank ``m``'s slice of a residue row's ``field`` (bits): flat,
    the codes at the slice's logical offsets; rowwise, the slice; fp8's
    scales whole where their blocks or rows cross the slices, else the
    slice's rows."""
    sl = _slice_of(path, m)
    rowwise = layout == "rowwise" and len(sl.shape) > 1
    if field == "scale":
        if not rowwise or sl.crosses("rowwise"):
            return row
        return _slice(row, _specs(TREE)[path][:-1], m)
    if rowwise:
        return _slice(row, _specs(TREE)[path], m)
    return row[sl.flat_ids("cpu").numpy()]


@pytest.mark.parametrize("label,t", CODEC_CASES)
def test_tp_codec_codes_match_jax(world, label, t):
    """Each slice's codes, joined back into its worker's row, bitwise JAX's
    row: every field; each slice's fields that row's at its positions, fp8's
    scales the logical blocks' or rows' (the whole vector on every model
    rank where they cross the slices)."""
    ref = world["red_refs"][(label, t)]
    layout = REDUCES[label][7]
    for (d, m), res in world["ranks"].items():
        got = res["reduce"][(label, t)]
        for path, enc in ref["residues"].items():
            assert sorted(got["rows"][path]) == sorted(enc)
            for field, want in enc.items():
                np.testing.assert_array_equal(got["rows"][path][field][0], _bits(want)[d],
                                              err_msg=f"{label} {path} {field} t={t}")
                np.testing.assert_array_equal(
                    got["slices"][path][field][0],
                    _cut_row(field, _bits(want)[d], path, m, layout),
                    err_msg=f"{label} {path} {field} t={t} slice")


@pytest.mark.parametrize("t", TS2)
def test_tp_groups_fp8_within_a_code_step(world, t):
    """``groups=1``: both data ranks hold the group's row; a code may sit one
    step from JAX's where the intra-group mean rounds differently; the
    scales within rtol 1e-6; ĝ to JAX's within the ring's tolerance."""
    label = "groups_fp8"
    ref = world["red_refs"][(label, t)]
    specs = _specs(TREE)
    steps = total = 0
    for (d, m), res in world["ranks"].items():
        got = res["reduce"][(label, t)]
        for path, enc in ref["residues"].items():
            steps += _fp8_steps(got["rows"][path]["q"][0], _bits(enc["q"])[0])
            total += enc["q"][0].size
            np.testing.assert_allclose(got["rows"][path]["scale"][0].view(np.float32),
                                       enc["scale"][0], rtol=1e-6)
            replica = world["ranks"][(1 - d, m)]["reduce"][(label, t)]["slices"][path]
            for field, bits in got["slices"][path].items():
                np.testing.assert_array_equal(bits, replica[field])
        for k in TREE:
            np.testing.assert_allclose(got["ghat"][f"['{k}']"],
                                       _slice(ref["ghat"][k], specs[f"['{k}']"], m),
                                       rtol=1e-6, atol=1e-6)
    print(f"groups_fp8 t={t}: {steps} of {total} fp8 codes one step from JAX's")
    assert steps <= CODE_STEPS_MAX * total, (steps, total)


@pytest.mark.parametrize("label", GAMMA_LABELS)
def test_tp_contraction_gamma_matches_jax(world, label):
    for t in REDUCES[label][6]:
        want = world["red_refs"][(label, t)]["stats"]["contraction_gamma"]
        gammas = [res["reduce"][(label, t)]["stats"]["contraction_gamma"]
                  for res in world["ranks"].values()]
        assert len(set(gammas)) == 1, gammas
        np.testing.assert_allclose(gammas[0], want, rtol=1e-5)


def _own(sp, m: int) -> int:
    """The elements of a compressed tensor that model rank ``m`` reduces:
    its range of chunks ("part"), its slice (split), or of a replicated
    exact tensor its even range."""
    if sp.route == "part":
        lo, hi = sp.bounds[m]
        return min(hi * sp.unit, sp.plan.size) - lo * sp.unit
    if sp.dim is not None:
        return int(np.prod(sp.local_shape))
    q, r = divmod(sp.plan.size, GRID[1])
    return q + (m < r)


@pytest.mark.parametrize("label", list(REDUCES))
def test_tp_reduce_payload_is_the_plans(world, label):
    """Each data group's counted payload averages to its model rank's share
    of the plan; the shares sum to the logical plan's bytes, JAX's; the
    oracle's and the stats' all-reduces and the intra-group gather beside
    it, each a rank's own part."""
    name, exact, _, groups, _, stats, t_list, _ = REDUCES[label]
    for t in t_list:
        shares = []
        for m in range(GRID[1]):
            runs = [world["ranks"][(d, m)]["reduce"][(label, t)] for d in range(N)]
            share = runs[0]["stats"]["comm_bytes_per_shard"]
            assert sum(r["payload"] for r in runs) / N == share
            assert share == sum(sp.bytes_payload for sp in _shards(label, m).values())
            shares.append(share)
            own = sum(_own(sp, m) for sp in _shards(label, m).values() if not sp.plan.dense)
            for r in runs:
                assert r["sent"]["oracle"] == (4 * own if name == "true_topk" else 0)
                assert r["sent"]["stats"] == (4 * own if stats else 0)
                assert (r["sent"]["intra"] > 0) == (groups is not None)
        total = runs[0]["stats"]["comm_bytes_per_worker"]
        assert sum(shares) == total
        assert np.float32(total) == np.float32(world["red_refs"][(label, t)]["stats"][
            "comm_bytes_per_worker"])


@pytest.mark.parametrize("label", list(REDUCES))
def test_tp_share_cuts_and_joins_every_field(world, label):
    """``shard_train_state(mesh=, groups=)`` of JAX's stacked residues: the
    slice joined back is the row of the rank's worker (or group) bitwise;
    the slice holds the row's codes at its logical positions."""
    groups, layout = REDUCES[label][3], REDUCES[label][7]
    for (d, m), res in world["ranks"].items():
        got = res["reduce"][(label, "share")]
        row = d if groups is None else d // (N // groups)
        for path, enc in world["red"]["residues"][label].items():
            for field, want in enc.items():
                np.testing.assert_array_equal(got["rows"][path][field][0], _bits(want)[row],
                                              err_msg=f"{label} {path} {field}")
                np.testing.assert_array_equal(
                    got["slices"][path][field][0],
                    _cut_row(field, _bits(want)[row], path, m, layout),
                    err_msg=f"{label} {path} {field} slice")


def _flips(ghat: np.ndarray, key: np.ndarray, chunk: int) -> np.ndarray:
    """Chunks where the step's ĝ has its lane elsewhere than the
    reference's selection (the arg-max of |key|); each must be a near tie
    of the key. Returns the flipped chunks' mask."""
    pad = (-key.size) % chunk
    e = np.abs(np.pad(key, (0, pad))).reshape(-1, chunk)
    a = np.pad(ghat.reshape(-1), (0, pad)).reshape(-1, chunk) != 0
    want = np.argmax(e, axis=1)
    lane = np.argmax(a, axis=1)
    flip = a.any(axis=1) & (lane != want)
    rows = np.nonzero(flip)[0]
    top, other = e[rows, want[rows]], e[rows, lane[rows]]
    assert np.all(top - other <= NEAR_TIE_RTOL * top), (
        f"chunks {rows[top - other > NEAR_TIE_RTOL * top]} select another lane without a near tie")
    return flip


@pytest.mark.parametrize("label,mode", STEP_CASES)
def test_tp_step_matches_reference(world, label, mode):
    ref = world["step_refs"][(label, mode)]
    specs = _specs(ranks.ARCH)
    by = world["ranks"]
    skip, flipped = {}, 0
    if mode == "scalecom":
        for path, key in ref["keys"].items():
            ghat = _whole([by[(0, m)]["steps"][(label, mode)]["ghat"][path]
                           for m in range(GRID[1])], specs[path])
            flip = _flips(ghat, key, STEP_CHUNK)
            flipped += int(flip.sum())
            skip[path] = np.repeat(flip, STEP_CHUNK)[:key.size].reshape(ghat.shape)
    for (d, m), res in by.items():
        got = res["steps"][(label, mode)]
        assert sorted(got["params"]) == sorted(ref["params"])
        for path, want in ref["params"].items():
            keep = (~_slice(skip[path], specs[path], m) if path in skip
                    else np.ones(got["params"][path].shape, bool))
            np.testing.assert_allclose(got["params"][path][keep],
                                       _slice(want, specs[path], m)[keep],
                                       err_msg=f"{label} {mode} rank {(d, m)} {path}", **STEP_TOL)
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-4)
        if "contraction_gamma" in ref["metrics"]:
            np.testing.assert_allclose(got["metrics"]["contraction_gamma"],
                                       ref["metrics"]["contraction_gamma"], rtol=1e-4)
    print(f"{label} {mode}: {flipped} chunks selected another lane at a near tie")
    assert flipped <= 4, flipped
    if mode == "scalecom":
        shares = []
        for m in range(GRID[1]):
            runs = [by[(d, m)]["steps"][(label, mode)] for d in range(N)]
            share = runs[0]["metrics"]["comm_bytes_per_shard"]
            assert sum(r["payload"] for r in runs) / N == share
            shares.append(share)
        total = runs[0]["metrics"]["comm_bytes_per_worker"]
        assert sum(shares) == total
        assert np.float32(total) == np.float32(ref["metrics"]["comm_bytes_per_worker"])


@pytest.mark.parametrize("codec,layout,holder", NAN_CASES)
def test_tp_fp8_nan_in_a_crossing_block_is_the_stacked_encode(world, codec, layout, holder):
    """A NaN in a block (flat fp8) or row (rowwise fp8_ec) that crosses the
    slices of leaf "a", on model rank ``holder``: every rank's slice codes,
    joined into the row, and every field of the slice, bitwise JAX's
    stacked encode of the logical row (the block's or row's scale 1.0,
    where the NaN's amax is no positive number)."""
    row = world["red"]["nan"][(codec, layout, holder)]
    store = _storage(TREE["a"][0], layout)
    # eagerly: jitted, XLA's CPU divides by 448 through its reciprocal and
    # contracts fp8_ec's m - q * scale into an FMA
    want = jax.tree.map(np.asarray, jstate.CODECS[codec].encode(jnp.asarray(row), store))
    at = 5 if layout == "rowwise" else (5 * TREE["a"][0][1] + NAN_COLUMN[holder]) // 512
    assert want["scale"].reshape(-1)[at] == 1.0
    for (d, m), res in world["ranks"].items():
        got = res["nan"][(codec, layout, holder)]
        assert sorted(got["row"]) == sorted(want)
        for field, x in want.items():
            np.testing.assert_array_equal(got["row"][field], _bits(x),
                                          err_msg=f"{codec} {layout} {field} rank {(d, m)}")
            np.testing.assert_array_equal(got["slice"][field][0],
                                          _cut_row(field, _bits(x)[0], "['a']", m, layout),
                                          err_msg=f"{codec} {layout} {field} slice")


@pytest.mark.parametrize("groups", [None, 1])
@pytest.mark.parametrize("codec", ["fp32", "bf16", "fp8", "fp8_ec"])
def test_tp_init_makes_every_codec_field(world, codec, groups):
    """``init_train_state(mesh=)`` gives each rank zero residue slices with
    the fields, shapes and dtypes of ``shard_train_state(mesh=)``'s cut of
    the stacked init, in every codec."""
    for res in world["ranks"].values():
        got = res["inits"][(codec, groups)]
        assert got["mine"] and got["zero"]
        assert got["mine"] == got["want"]
