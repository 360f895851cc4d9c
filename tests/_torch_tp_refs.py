"""The reference's side of the sharded-step tests
(``test_torch_tp_families.py``, ``test_torch_tp_hybrid_encdec.py``,
``test_torch_tp_configs.py``, ``test_torch_fsdp.py``): a SMOKE arch's
carried-across state and batches with a function that runs the
reference's unsharded step on them, the reference's random_k draws and
stochastic-rounding bits, and the numpy helpers that hold a rank's slices
against it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import _torch_arch_parity as parity
import _torch_tp_family_ranks as ranks
from repro.configs import registry as jregistry
from repro.core import state as jstate
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.data import make_batches as jmake_batches
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import init_train_state as jinit
from repro.training.train_step import build_train_step as jbuild_step
from repro_torch import tree
from repro_torch.distributed.sharding import specs_for_axes
from repro_torch.launch.mesh import Mesh

MODES = ranks.MODES
CHUNK, LR = ranks.CHUNK, ranks.LR
# a chunk may select another lane than the reference only where the two
# runs' ef, this close at both lanes, explain the swap (chip_smoke.py's
# [tp] rule): at SMOKE width RWKV-6's group norm sets the two frameworks'
# gradients ~1e-4 apart (ROADMAP Queue 3), enough to swap a chunk's lanes
NEAR_TIE_RTOL = 1e-2


def jcfg(codec: str, chunk: int = CHUNK) -> JCfg:
    return JCfg(compressor=JComp("clt_k", chunk=chunk), beta=ranks.BETA, min_size=ranks.MIN_SIZE,
                residue_dtype=codec, backend="jnp", fused=False, layout="flat")


def flat(t) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def arch_job(arch: str, n: int, codecs, modes=MODES, local_b=2, seq=32, overrides=None,
             perturb=None, chunk=CHUNK):
    """The carried-across state and batches of one arch (its SMOKE config
    with ``overrides``) at ``n`` workers, ``local_b`` x ``seq`` tokens a
    worker (an encoder-decoder's frames and a VLM's vision prefix too), and
    a function that runs the reference (clt_k at ``chunk``) on them: per
    codec (``run(codecs)``: a subset, by default all), the params after
    each step, the metrics and, before each compressed step, the leader
    (``lead``), its ef and the per-worker gradients.
    ``perturb`` (default: RWKV-6 only) sets every
    constant-initialised leaf off its constant
    (``_torch_arch_parity.perturb_constants``)."""
    cfg = dataclasses.replace(jregistry.smoke(arch), **(overrides or {}))
    jmodel = jbuild(cfg, compute_dtype="float32", loss_chunk=16)
    jopt = jmake_opt("sgdm")
    js0 = jinit(jmodel, jopt, jcfg("fp32", chunk), jax.random.PRNGKey(0), n_workers=n)[0]
    zeros = {c: jstate.init_state(js0.params, n, c, ranks.MIN_SIZE, "flat") for c in codecs}
    params = jax.tree.map(np.asarray, js0.params)
    if perturb is None:
        perturb = cfg.arch_type == "ssm"
    if perturb:
        params = parity.perturb_constants(params, 0)
    inputs = dict(vision_tokens=cfg.vision_tokens if cfg.arch_type == "vlm" else 0,
                  encoder_seq=cfg.encoder_seq if cfg.is_encdec else 0, d_model=cfg.d_model)
    batches = list(jmake_batches(cfg.vocab, n, local_b, seq, seed=1, steps=3, **inputs))
    job = {"arch": arch, "overrides": dict(overrides or {}), "chunk": chunk, "params": params,
           "opt_m": jax.tree.map(np.asarray, js0.opt_state["m"]),
           "residues": {c: jax.tree.map(np.asarray, z.residues) for c, z in zeros.items()},
           "t": int(js0.sc_state.t), "step": int(js0.step), "batches": batches}
    assert modes[0] == "dense" and set(modes[1:]) <= {"scalecom"}

    def run(only=codecs):
        grads_fn = jax.jit(jax.vmap(jax.grad(jmodel.loss, has_aux=True), in_axes=(None, 0)))
        dense = jax.jit(jbuild_step(jmodel, jopt, jschedule.constant(LR), jcfg("fp32", chunk),
                                    n_workers=n, mode="dense"))
        js = type(js0)(params=jax.tree.map(jnp.asarray, params), opt_state=js0.opt_state,
                       sc_state=zeros[codecs[0]], step=js0.step)
        warm, metrics = dense(js, batches[0])
        # the dense step leaves the residues as they were: each codec's run
        # takes its zero residues from there
        first = {"params": flat(warm.params), "ef": None, "sel": None, "grads": None,
                 "metrics": {k: float(v) for k, v in metrics.items()}}
        out = {}
        for codec in only:
            fn = jax.jit(jbuild_step(jmodel, jopt, jschedule.constant(LR), jcfg(codec, chunk),
                                     n_workers=n, mode="scalecom"))
            js = type(warm)(params=warm.params, opt_state=warm.opt_state,
                            sc_state=jstate.ScaleComState(zeros[codec].residues, warm.sc_state.t),
                            step=warm.step)
            steps = [first]
            for batch in batches[1:len(modes)]:
                m_before = flat(js.opt_state["m"])
                g = flat(grads_fn(js.params, batch)[0])
                lead = int(js.sc_state.t) % n
                ef = {p: np.asarray(jstate.CODECS[codec].decode(e, (g[p][0].size,)))[lead]
                      + g[p][lead].reshape(-1) for p, e in js.sc_state.residues.items()}
                js, metrics = fn(js, batch)
                # the lanes the step selected: where m' = 0.9 m + ĝ is not 0.9 m
                m_after = flat(js.opt_state["m"])
                sel = {p: (m_after[p] != np.float32(0.9) * m_before[p]).reshape(-1) for p in ef}
                steps.append({"params": flat(js.params), "ef": ef, "sel": sel, "grads": g,
                              "lead": lead, "metrics": {k: float(v) for k, v in metrics.items()}})
            out[codec] = steps
        return out

    return job, run


def specs_of(model, grid) -> dict:
    """Path -> the tp spec of each leaf of the port's ``model`` on a grid of
    (data, model) sizes ``grid``."""
    return dict(tree.flatten_with_path(specs_for_axes(
        model.abstract_params(), model.logical_axes(), "tp", Mesh(("data", "model"), grid))))


def take_slice(x: np.ndarray, spec, coords: dict, grid) -> np.ndarray:
    """The slice of ``x`` that the rank at ``coords`` holds under ``spec``."""
    sizes = dict(zip(("data", "model"), grid))
    for d, ax in enumerate(spec):
        if ax is not None:
            w = x.shape[d] // sizes[ax]
            x = np.take(x, range(coords[ax] * w, (coords[ax] + 1) * w), axis=d)
    return x


def whole(per_model: list, spec) -> np.ndarray:
    """The logical array from the slices of model ranks 0, 1, ..."""
    dims = [d for d, ax in enumerate(spec) if ax == "model"]
    return np.concatenate(per_model, axis=dims[0]) if dims else per_model[0]


def flips(ghat: np.ndarray, ef: np.ndarray, own: np.ndarray, sel: np.ndarray, chunk=CHUNK,
          rtol=NEAR_TIE_RTOL) -> np.ndarray:
    """Chunks where the step's ĝ has its lane elsewhere than the
    reference's selection (``sel``, the lanes its step updated; ``ef``, the
    leader's ef recomputed apart, may order an exact tie otherwise). Each must be
    a near tie that the two runs' ef explain: the step's own ef (``own``,
    its leader's residue plus gradient) within ``rtol`` of the
    reference's at both lanes, the reference's two |ef| no further apart
    than the two runs' ef differ there, and the step's own |ef| ordered
    the step's way. Returns the flipped chunks' mask."""
    pad = (-ef.size) % chunk
    e = np.pad(ef, (0, pad)).reshape(-1, chunk)
    o = np.pad(own.reshape(-1), (0, pad)).reshape(-1, chunk)
    a = np.pad(ghat.reshape(-1), (0, pad)).reshape(-1, chunk) != 0
    s = np.pad(sel, (0, pad)).reshape(-1, chunk)
    want = np.where(s.any(axis=1), np.argmax(s, axis=1), np.argmax(np.abs(e), axis=1))
    lane = np.argmax(a, axis=1)
    flip = a.any(axis=1) & (lane != want)
    for c in np.nonzero(flip)[0]:
        ra, rb, ta, tb = e[c, want[c]], e[c, lane[c]], o[c, want[c]], o[c, lane[c]]
        close = abs(ta - ra) <= rtol * abs(ra) and abs(tb - rb) <= rtol * abs(rb)
        explained = abs(ra) - abs(rb) <= abs(ta - ra) + abs(tb - rb)
        assert close and explained and abs(ta) <= abs(tb), (
            f"chunk {c}: the reference's ef {ra!r} / {rb!r}, the step's {ta!r} / {tb!r}: "
            f"another lane without a near tie")
    return flip


def jax_draw(t, shape, high=None):
    """The reference's random_k draw at step ``t`` (``repro.core.compressors``'
    key), for ``core.compressors.random_draw``'s place on the ranks."""
    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
    if high is None:
        return np.array(jax.random.uniform(key, tuple(shape)))
    return np.array(jax.random.randint(key, tuple(shape), 0, high, dtype=jnp.int32))


@functools.partial(jax.jit, static_argnums=1)
def _bits16(key, shape):
    return jax.random.bits(key, shape, jnp.uint32) >> 16


def jax_dither(path, t, shape):
    """The stochastic-rounding bits of ``codec_key(path, t)`` over ``shape``,
    as the reference's encode draws them."""
    return np.asarray(_bits16(jstate.codec_key(path, jnp.int32(t)), tuple(shape))).astype(np.int32)


def padded(size: int) -> int:
    """``size`` up to whole fp8 blocks of 512."""
    return -(-size // 512) * 512
