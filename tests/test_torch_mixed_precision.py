"""repro_torch's mixed precision against ``repro.models``' ``compute_dtype``
and ``param_dtype``.

``build_model`` takes the reference's dtype names and defaults (bf16
compute over fp32 parameters); a bf16-parameter init is the fp32 init
rounded to nearest even, bit for bit. For each model family at its SMOKE
width (the paper transformer, starcoder2: GQA, RMSNorm, SwiGLU; phi3.5-moe,
rwkv6, recurrentgemma, whisper, internvl2), from JAX-initialised fp32
weights (``_torch_arch_parity.jax_params``) and one batch, the port's bf16
loss, aux values and every gradient are held against the reference's bf16
compute, with tolerances that are multiples of the reference's own
bf16-against-fp32 gap on the same inputs (``LOSS_K``, ``GRAD_K``): the two
frameworks round bf16 at other places (XLA's CPU keeps some bf16
intermediates in fp32, PyTorch rounds every op), so a bf16 result differs
from the reference's by about as much as the reference's differs from
fp32. The JAX side runs in this process, excess precision allowed (its
default). What the tolerances cannot see, a path that quietly computes in
fp32, is held apart: every matrix product of a bf16 forward pass runs in
bf16 but RWKV-6's fp32 decay and recurrence. Caches and recurrent states
have the reference's dtypes; prefill and decode logits under bf16
parameters and compute agree with the reference's to ``SERVE_REL`` of the
largest logit; one compressed train step under bf16 compute gives the
reference's loss and bytes; under bf16 parameters the reduce, fed the
reference's gradients, gives its bf16 ĝ and its residues bit for bit, in
the codec's dtype, and the step's SGD-momentum update is the reference's
to a few bf16 ulps; bf16 parameters round-trip through both packages'
checkpoints.

JAX's jitted functions compile in threads, started once for the module, and
the port runs on one torch thread (RWKV-6's time loop is many small ops).
"""

import concurrent.futures
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_arch_parity as parity
from repro import checkpoint as jcheckpoint
from repro.core import scalecom as jsc
from repro.core import state as jstate
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.state import ScaleComState as JState
from repro.data import make_batches as jmake_batches
from repro.models import _DTYPES as JDTYPES
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import init_train_state as jinit
from repro.training.train_step import build_train_step as jbuild_step
from repro_torch import checkpoint, tree
from repro_torch.configs import registry
from repro_torch.core import scalecom as tsc
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import model_inputs
from repro_torch.models import DTYPES, build_model
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainState, build_train_step
from repro_torch.training import train_step
from repro_torch.training.train_step import per_worker_grads

FAMILIES = ["paper-transformer-base", "starcoder2-3b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b",
            "recurrentgemma-2b", "whisper-medium", "internvl2-26b"]
PAPER, RWKV = "paper-transformer-base", "rwkv6-3b"
# The port's bf16 loss against the reference's, in multiples of the
# reference's own |bf16 - fp32| loss gap on the same inputs. Measured on this
# CPU: 0.39-1.43 for six families, 2.88 for rwkv6 (whose per-head group norm
# magnifies rounding, ROADMAP Queue 3).
LOSS_K = 5.0
# Every gradient leaf's relative error against the reference's bf16 one, in
# multiples of the largest per-leaf relative gap |bf16 - fp32| of the
# reference (measured 0.58-1.12). A leaf is measured against
# max(|its fp32 gradient|, GRAD_FLOOR x the largest leaf's): Whisper's key
# biases have no gradient in exact arithmetic (no RoPE: a key bias shifts
# every score of a query by the same amount), only rounding.
GRAD_K = 2.0
GRAD_FLOOR = 1e-3
# prefill and decode logits, bf16 parameters and compute, against the
# reference's: the largest difference over the largest |logit| (~3.3 here),
# about 8 bf16 ulps at that scale. Measured: up to 1.64e-2 (rwkv6); the
# reference's own bf16-against-fp32-compute gap on these inputs reaches 1.08e-2.
SERVE_REL = 3e-2
PROMPT, STEPS = 16, 2
N, CHUNK, MIN_SIZE = 4, 16, 512


def _f32(x):
    return np.asarray(x, np.float32)


def _jax_loss(name, dtype):
    """The reference's loss, aux and gradients of ``name`` in ``dtype``
    compute from ``jax_params``' fp32 weights on ``parity.batch``."""
    jcfg, _ = parity.configs(name, "smoke")
    jp, b = parity.jax_params(jcfg), parity.batch(jcfg)
    model = jbuild(jcfg, compute_dtype=dtype, loss_chunk=parity.LOSS_CHUNK)
    (loss, aux), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b))
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [_f32(g) for g in jax.tree.leaves(grads)])


def _bf16_params(name):
    jcfg, _ = parity.configs(name, "smoke")
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), parity.jax_params(jcfg))


def _prompt(b):
    return {k: (v[:, :PROMPT] if k == "tokens" else v) for k, v in b.items()
            if k not in ("labels", "mask")}


def _ctx(cfg):
    return PROMPT + (cfg.vision_tokens if cfg.arch_type == "vlm" else 0)


def _jax_serve(name):
    """The reference's prefill of ``PROMPT`` tokens and ``STEPS``
    teacher-forced decode steps under bf16 parameters and compute: the
    logits and the dtypes of its decode states (initial, after prefill)."""
    jcfg, _ = parity.configs(name, "smoke")
    jm = jbuild(jcfg, compute_dtype="bfloat16", param_dtype="bfloat16")
    jp = _bf16_params(name)
    b = parity.batch(jcfg, seq=PROMPT + STEPS)
    ctx = _ctx(jcfg)
    cap = ctx + STEPS + 2
    logits, st = jax.jit(lambda p, b_: jm.prefill(p, b_, cap))(
        jp, jax.tree.map(jnp.asarray, _prompt(b)))
    dtypes = {"init": _dtypes(jm.init_decode_state(b["tokens"].shape[0], cap)),
              "prefill": _dtypes(st)}
    out = [_f32(logits)]
    decode = jax.jit(jm.decode_step)
    for i in range(STEPS):
        logits, st = decode(jp, st, jnp.asarray(b["tokens"][:, PROMPT + i]), jnp.int32(ctx + i))
        out.append(_f32(logits))
    return out, dtypes


def _dtypes(state):
    """{keystr path: dtype name} of a JAX or port decode state."""
    if isinstance(jax.tree.leaves(state)[0], torch.Tensor):
        return {p: str(t.dtype).removeprefix("torch.") for p, t in tree.flatten_with_path(state)}
    return {jax.tree_util.keystr(p): str(v.dtype)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def _jax_step():
    """The reference's compressed CLT-k step of the paper model in bf16
    compute over fp32 parameters, from a mid-run state: (metrics, state
    before, batch)."""
    jcfg_m, _ = parity.configs(PAPER, "smoke")
    jcfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), backend="jnp", fused=False, beta=0.1,
                min_size=MIN_SIZE, warmup_steps=2)
    jmodel = jbuild(jcfg_m, loss_chunk=parity.LOSS_CHUNK)  # bf16 compute, the default
    jopt = jmake_opt("sgdm")
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    rng = np.random.default_rng(1)
    noise = lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape).astype(np.float32))
    js.params = jax.tree.map(jnp.asarray, parity.perturb_constants(js.params, 0))
    js.opt_state = {"m": jax.tree.map(noise, js.opt_state["m"])}
    js.sc_state = JState(residues=jax.tree.map(noise, js.sc_state.residues), t=jnp.int32(7))
    js.step = jnp.int32(3)
    before = jax.tree.map(np.asarray, (js.params, js.opt_state, js.sc_state.residues))
    b = next(jmake_batches(jcfg_m.vocab, N, 2, 32, seed=2))
    step = jax.jit(jbuild_step(jmodel, jopt, jschedule.linear_warmup(jschedule.constant(0.05), 2),
                               jcfg, n_workers=N, mode="scalecom"))
    _, jm = step(js, b)
    return {k: float(v) for k, v in jm.items()}, before, b


def _jax_worker_grads():
    """The reference's per-worker gradients of the paper model under bf16
    parameters and compute (bf16 leaves), one worker batch each."""
    jcfg, _ = parity.configs(PAPER, "smoke")
    jm = jbuild(jcfg, compute_dtype="bfloat16", param_dtype="bfloat16",
                loss_chunk=parity.LOSS_CHUNK)
    b = next(jmake_batches(jcfg.vocab, N, 2, 32, seed=3))
    fn = jax.jit(jax.vmap(jax.grad(lambda p, x: jm.loss(p, x)[0]), in_axes=(None, 0)))
    return fn(_bf16_params(PAPER), jax.tree.map(jnp.asarray, b))


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX result of the module, compiled and run in threads."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    jobs = {("step",): pool.submit(_jax_step), ("grads",): pool.submit(_jax_worker_grads)}
    for name in FAMILIES:
        for dt in ("bfloat16", "float32"):
            jobs[("loss", name, dt)] = pool.submit(_jax_loss, name, dt)
        jobs[("serve", name)] = pool.submit(_jax_serve, name)
    yield lambda *key: jobs[key].result()
    pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_build_model_defaults_and_dtypes_are_the_reference_s():
    """bf16 compute over fp32 parameters by default, the reference's three
    dtype names, and an unknown name raises naming them."""
    model = build_model(registry.smoke(PAPER))
    assert (model.compute_dtype, model.param_dtype) == (torch.bfloat16, torch.float32)
    jdefaults = {k: v.default for k, v in inspect.signature(jbuild).parameters.items()}
    tdefaults = {k: v.default for k, v in inspect.signature(build_model).parameters.items()}
    for k in ("compute_dtype", "param_dtype", "loss_chunk", "decode_window"):
        assert tdefaults[k] == jdefaults[k], k
    assert list(DTYPES) == list(JDTYPES)
    for k in DTYPES:
        assert str(DTYPES[k]).removeprefix("torch.") == jnp.dtype(JDTYPES[k]).name
    for arg in ("compute_dtype", "param_dtype"):
        with pytest.raises(ValueError, match="'float32', 'bfloat16', 'float16'"):
            build_model(registry.smoke(PAPER), **{arg: "fp16"})


@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_precision_init_is_the_fp32_init_rounded(name):
    """Drawn in fp32 and cast (round to nearest even), leaf for leaf: bf16
    and fp16 inits are the fp32 init's values rounded, bit for bit."""
    cfg = registry.smoke(name)
    init = {dt: build_model(cfg, param_dtype=dt).init(torch.Generator().manual_seed(3), "cpu")
            for dt in DTYPES}
    for dt in ("bfloat16", "float16"):
        got = tree.flatten_with_path(init[dt])
        want = tree.flatten_with_path(init["float32"])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == DTYPES[dt], path
            assert torch.equal(g.view(torch.int16), w.to(DTYPES[dt]).view(torch.int16)), path


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_loss_and_gradients_match_the_reference(name, jax_results):
    """From the same fp32 weights and batch, bf16 compute: the loss within
    ``LOSS_K`` times the reference's own bf16-fp32 loss gap, each aux within
    ``LOSS_K`` times its gap (the drop share equal), every gradient leaf
    within ``GRAD_K`` times the largest leaf gap. Gradients of fp32
    parameters are fp32."""
    jl32, ja32, jg32 = jax_results("loss", name, "float32")
    jl, ja, jg = jax_results("loss", name, "bfloat16")
    jcfg, tcfg = parity.configs(name, "smoke")
    b = parity.batch(jcfg)
    model = build_model(tcfg, loss_chunk=parity.LOSS_CHUNK)
    tp = tree.tree_map(lambda p: p.requires_grad_(True),
                       params_from_jax(parity.jax_params(jcfg), "cpu"))
    loss, aux = model.loss(tp, {k: parity._t(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, tree.leaves(tp))

    gap = abs(jl - jl32)
    assert 0 < gap < 1e-3 * abs(jl32)  # bf16 moved the reference's loss, a little
    assert abs(loss.item() - jl) <= LOSS_K * gap, (loss.item(), jl, jl32)
    assert sorted(aux) == sorted(ja)
    for k in ja:
        if k == "moe_dropped_frac":  # the same drops (XLA's jitted division: an FMA)
            np.testing.assert_allclose([aux[k].item(), ja[k]], ja32[k], rtol=1e-6)
            continue
        assert abs(aux[k].item() - ja[k]) <= LOSS_K * max(abs(ja[k] - ja32[k]),
                                                          1e-6 * abs(ja32[k])), k
    assert len(grads) == len(jg)
    top = max(np.linalg.norm(g) for g in jg32)
    norm = [max(np.linalg.norm(g), GRAD_FLOOR * top) for g in jg32]
    gaps = [np.linalg.norm(a - c) / s for a, c, s in zip(jg, jg32, norm)]
    paths = [p for p, _ in tree.flatten_with_path(tp)]
    for path, g, want, s in zip(paths, grads, jg, norm):
        assert g.dtype == torch.float32, path
        err = np.linalg.norm(g.numpy() - want) / s
        assert err <= GRAD_K * max(gaps), (path, err, max(gaps))


class _Gemms(TorchDispatchMode):
    """Counts the matrix products by the dtype they run in."""

    OPS = ("mm", "bmm", "addmm", "baddbmm")

    def __init__(self):
        super().__init__()
        self.by_dtype = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            dt = args[-1].dtype
            self.by_dtype[dt] = self.by_dtype.get(dt, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", FAMILIES)
def test_no_matrix_product_quietly_in_fp32(name):
    """Under bf16 compute every matrix product of the loss's forward pass
    (the norms, RoPE and softmaxes are fp32 elementwise islands) takes bf16
    operands, but RWKV-6's fp32 ones: per layer the decay's two adapter
    products and one state product per position."""
    jcfg, tcfg = parity.configs(name, "smoke")
    b = {k: parity._t(v) for k, v in parity.batch(jcfg).items()}
    params = params_from_jax(parity.jax_params(jcfg), "cpu")
    with torch.no_grad(), _Gemms() as gemms:
        build_model(tcfg, loss_chunk=parity.LOSS_CHUNK).loss(params, b)
    fp32 = tcfg.n_layers * (2 + parity.S) if name == RWKV else 0
    assert gemms.by_dtype.get(torch.float32, 0) == fp32, gemms.by_dtype
    assert gemms.by_dtype[torch.bfloat16] > 0
    assert set(gemms.by_dtype) <= {torch.float32, torch.bfloat16}


@pytest.mark.parametrize("name", FAMILIES)
def test_caches_and_states_have_the_reference_dtypes(name, jax_results):
    """Under bf16 compute the attention caches are bf16 (every family's but
    RWKV-6's, which has none), the RWKV-6 and RG-LRU states and
    ``slot_pos`` as the reference holds them, in the empty state and after
    prefill."""
    _, want = jax_results("serve", name)
    jcfg, tcfg = parity.configs(name, "smoke")
    model = build_model(tcfg, param_dtype="bfloat16")
    cap = _ctx(jcfg) + STEPS + 2
    b = parity.batch(jcfg, seq=PROMPT)
    got = {"init": _dtypes(model.init_decode_state(b["tokens"].shape[0], cap, "cpu"))}
    params = params_from_jax(_bf16_params(name), "cpu")
    _, state = model.prefill(params, {k: parity._t(v) for k, v in _prompt(b).items()}, cap)
    got["prefill"] = _dtypes(state)
    assert got == want
    assert ("bfloat16" in want["init"].values()) == (tcfg.arch_type != "ssm")


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_prefill_and_decode_match_the_reference(name, jax_results):
    """bf16 parameters (the reference's fp32 draw rounded) and bf16 compute,
    as the reference serves in production: the prefill's last logits and
    ``STEPS`` teacher-forced decode steps' within ``SERVE_REL`` of the
    largest |logit|, the logits in bf16."""
    want, _ = jax_results("serve", name)
    jcfg, tcfg = parity.configs(name, "smoke")
    model = build_model(tcfg, param_dtype="bfloat16")
    params = params_from_jax(_bf16_params(name), "cpu")
    b = parity.batch(jcfg, seq=PROMPT + STEPS)
    ctx = _ctx(jcfg)
    logits, st = model.prefill(params, {k: parity._t(v) for k, v in _prompt(b).items()},
                               ctx + STEPS + 2)
    got = [logits]
    for i in range(STEPS):
        logits, st = model.decode_step(params, st, parity._t(b["tokens"][:, PROMPT + i]), ctx + i)
        got.append(logits)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= SERVE_REL, (i, err)


def test_compressed_step_under_bf16_compute_matches_the_reference(jax_results, monkeypatch):
    """One compressed CLT-k step of the paper model in bf16 compute over
    fp32 parameters, from the reference's mid-run state: the loss within
    ``LOSS_K`` times the paper model's bf16-fp32 loss gap, the bytes equal;
    the gradients the reduce receives, the momentum and the residues fp32."""
    jm, (jparams, jopt, jres), b = jax_results("step")
    jl32, _, _ = jax_results("loss", PAPER, "float32")
    jl, _, _ = jax_results("loss", PAPER, "bfloat16")
    _, tcfg_m = parity.configs(PAPER, "smoke")
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), backend="torch",
                          beta=0.1, min_size=MIN_SIZE, warmup_steps=2)
    model = build_model(tcfg_m, loss_chunk=parity.LOSS_CHUNK)
    ts = TrainState(params=params_from_jax(jparams, "cpu"),
                    opt_state={"m": params_from_jax(jopt["m"], "cpu")},
                    sc_state=tstate.ScaleComState(
                        residues={p: {"q": parity._t(e["q"])} for p, e in jres.items()}, t=7),
                    step=3)
    seen = []
    real = tsc.scalecom_reduce

    def spy(gpw, *a, **kw):
        seen.extend(g.dtype for g in tree.leaves(gpw))
        return real(gpw, *a, **kw)

    monkeypatch.setattr(train_step, "scalecom_reduce", spy)
    step = build_train_step(model, make_optimizer("sgdm"),
                            schedule.linear_warmup(schedule.constant(0.05), 2), tcfg,
                            n_workers=N, mode="scalecom")
    ts2, tm = step(ts, b)
    assert seen and set(seen) == {torch.float32}
    assert abs(float(tm["loss"]) - jm["loss"]) <= LOSS_K * abs(jl - jl32) * jm["loss"] / jl
    for k in ("comm_bytes_per_worker", "comm_bytes_dense"):
        assert float(tm[k]) == np.float32(jm[k]), k
    assert {t.dtype for t in tree.leaves(ts2.params) + tree.leaves(ts2.opt_state["m"])} == {
        torch.float32}
    assert {e["q"].dtype for e in ts2.sc_state.residues.values()} == {torch.float32}


def _jax_dither(key, shape, device):
    """JAX's stochastic-rounding bits for ``key = (path, t)``, as the port's draw."""
    path, t = key
    bits = jax.random.bits(jstate.codec_key(path, jnp.int32(t)), tuple(shape), jnp.uint32) >> 16
    return torch.from_numpy(np.asarray(bits).astype(np.int32)).to(device)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({2: torch.int16, 4: torch.int32, 1: torch.uint8}[t.element_size()]).numpy()


def _jbits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32, 1: np.uint8}[a.dtype.itemsize])


@pytest.mark.parametrize("codec", ["fp32", "bf16"])
def test_reduce_under_bf16_params_is_the_reference_s(codec, jax_results, monkeypatch):
    """bf16 parameters: the reduce, fed the reference's per-worker bf16
    gradients and residues, folds in fp32 and casts ĝ back: ĝ bf16 and its
    bits, the CLT-k picks and the new residues (in the codec's dtype) the
    reference's, bit for bit."""
    monkeypatch.setattr(tstate, "codec_dither", _jax_dither)
    jgrads = jax_results("grads")
    jparams = _bf16_params(PAPER)
    kw = dict(beta=0.1, min_size=MIN_SIZE, residue_dtype=codec)
    jcfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), backend="jnp", fused=False, **kw)
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), backend="torch", **kw)
    js = jstate.init_state(jparams, N, codec, MIN_SIZE)
    rng = np.random.default_rng(4)
    js = JState(residues={p: {k: (jnp.asarray(0.01 * rng.standard_normal(v.shape), v.dtype)
                                  if v.dtype != jnp.int32 else v) for k, v in e.items()}
                          for p, e in js.residues.items()}, t=jnp.int32(5))
    jghat, jnew, _ = jsc.scalecom_reduce(jgrads, js, jcfg)
    tghat, tnew, _ = tsc.scalecom_reduce(params_from_jax(jgrads, "cpu"), state_from_jax(js, "cpu"),
                                         tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jghat)[0]
    tflat = tree.flatten_with_path(tghat)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, w), (_, g) in zip(jflat, tflat):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(g), _jbits(w), err_msg=jax.tree_util.keystr(path))
    assert sorted(tnew.residues) == sorted(jnew.residues)
    for path, enc in jnew.residues.items():
        for k, v in enc.items():
            got = tnew.residues[path][k]
            assert str(got.dtype).removeprefix("torch.") == str(v.dtype), (path, k)
            np.testing.assert_array_equal(_bits(got), _jbits(v), err_msg=f"{path} {k}")


def test_bf16_parameters_train_in_bf16():
    """A compressed step of the port under bf16 parameters: each worker's
    gradients are bf16, ĝ updates the bf16 parameters and momentum in place
    (they stay bf16), the fp32 residues stay fp32, the loss is finite."""
    _, tcfg_m = parity.configs(PAPER, "smoke")
    model = build_model(tcfg_m, param_dtype="bfloat16", loss_chunk=parity.LOSS_CHUNK)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in
         next(jmake_batches(tcfg_m.vocab, N, 2, 32, seed=3, **model_inputs(tcfg_m))).items()}
    _, _, gpw = per_worker_grads(model, params, b, N)
    assert {g.dtype for g in tree.leaves(gpw)} == {torch.bfloat16}
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), backend="torch",
                          beta=0.1, min_size=MIN_SIZE, warmup_steps=0)
    opt = make_optimizer("sgdm")
    state = TrainState(params, opt.init(params), tstate.init_state(params, N, "fp32", MIN_SIZE))
    step = build_train_step(model, opt, schedule.constant(0.05), tcfg, n_workers=N)
    before = tree.tree_map(torch.clone, params)
    state, metrics = step(state, b)
    assert np.isfinite(float(metrics["loss"]))
    assert {t.dtype for t in tree.leaves(state.params) + tree.leaves(state.opt_state["m"])} == {
        torch.bfloat16}
    assert {e["q"].dtype for e in state.sc_state.residues.values()} == {torch.float32}
    assert any(not torch.equal(a, c) for a, c in zip(tree.leaves(state.params),
                                                      tree.leaves(before)))


def _ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |x| (8 significant bits), the smallest normal's at 0."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def test_bf16_parameter_step_applies_the_reference_s_update(jax_results, monkeypatch):
    """bf16 parameters: one port step, fed the reference's per-worker bf16
    gradients (so ĝ is the reference's, bit for bit), against the reference's
    reduce and SGD-momentum update from the same state, and both against
    m' = 0.9 m + ĝ and p' = p - lr m' in float64. The reference rounds 0.9
    to bf16 and keeps p' in fp32 (its lr is fp32, ROADMAP Queue 3); the
    port multiplies in fp32 and rounds each op to bf16. So each result is
    held to ``STEP_ULPS`` bf16 ulps at the scale of its largest term
    (|0.9 m|, |ĝ|, |m'|; |p|, |lr m'|, |p'|), the port's p' against the
    reference's rounded to bf16 (measured: at most 3). The momentum is
    drawn at unit scale, so the update moves the median parameter by more
    than 8 x ``STEP_ULPS`` ulps (measured 90): a wrong lr, sign or momentum
    shows."""
    STEP_ULPS, LR, MU = 4, 0.05, 0.9
    jgrads = jax_results("grads")
    jparams = _bf16_params(PAPER)
    rng = np.random.default_rng(5)
    jmom = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.bfloat16), jparams)
    kw = dict(beta=0.1, min_size=MIN_SIZE)  # fp32 residues
    jcfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), backend="jnp", fused=False, **kw)
    js = jstate.init_state(jparams, N, "fp32", MIN_SIZE)
    js = JState(residues={p: {k: jnp.asarray(0.01 * rng.standard_normal(v.shape), v.dtype)
                              for k, v in e.items()} for p, e in js.residues.items()},
                t=jnp.int32(5))
    jghat, _, _ = jsc.scalecom_reduce(jgrads, js, jcfg)
    jp2, jo2 = jmake_opt("sgdm", momentum=MU).update(jghat, {"m": jmom}, jparams,
                                                     jschedule.constant(LR)(jnp.int32(0)))

    _, tcfg_m = parity.configs(PAPER, "smoke")
    model = build_model(tcfg_m, param_dtype="bfloat16", loss_chunk=parity.LOSS_CHUNK)
    gpw = params_from_jax(jgrads, "cpu")
    monkeypatch.setattr(train_step, "per_worker_grads",
                        lambda *a, **k: (torch.tensor(0.0), {}, gpw))
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), backend="torch", **kw)
    state = TrainState(params_from_jax(jparams, "cpu"), {"m": params_from_jax(jmom, "cpu")},
                       state_from_jax(js, "cpu"), step=0)
    b = {k: torch.from_numpy(v) for k, v in next(jmake_batches(tcfg_m.vocab, N, 2, 32)).items()}
    step = build_train_step(model, make_optimizer("sgdm", momentum=MU), schedule.constant(LR),
                            tcfg, n_workers=N)
    state, _ = step(state, b)

    moved = []
    leaves = zip(tree.flatten_with_path(state.params), tree.leaves(state.opt_state["m"]),
                 *(jax.tree.leaves(t) for t in (jparams, jmom, jghat, jp2, jo2["m"])))
    for (path, tp2), tm2, p, m, g, rp2, rm2 in leaves:
        assert tp2.dtype == tm2.dtype == torch.bfloat16 and rm2.dtype == jnp.bfloat16, path
        assert rp2.dtype == jnp.float32, path  # the reference's, as ROADMAP Queue 3 says
        p, m, g = (np.asarray(x, np.float64) for x in (p, m, g))
        m2 = MU * m + g
        p2 = p - LR * m2
        scale_m = np.maximum.reduce([np.abs(MU * m), np.abs(g), np.abs(m2)])
        scale_p = np.maximum.reduce([np.abs(p), np.abs(LR * m2), np.abs(p2)])
        got_m, got_p = tm2.double().numpy(), tp2.double().numpy()
        ref_m = np.asarray(rm2, np.float64)
        ref_p = np.asarray(jnp.asarray(rp2, jnp.bfloat16), np.float64)
        for what, a, want, scale in (("port m'", got_m, m2, scale_m),
                                     ("reference m'", ref_m, m2, scale_m),
                                     ("port m' - reference m'", got_m, ref_m, scale_m),
                                     ("port p'", got_p, p2, scale_p),
                                     ("reference p'", ref_p, p2, scale_p),
                                     ("port p' - reference p'", got_p, ref_p, scale_p)):
            ulps = np.abs(a - want) / _ulp(scale)
            assert ulps.max() <= STEP_ULPS, (path, what, float(ulps.max()))
        moved.append(np.abs(got_p - p) / _ulp(p))
    assert np.median(np.concatenate([x.ravel() for x in moved])) >= 8 * STEP_ULPS


def test_bf16_parameters_round_trip_through_both_checkpoints(tmp_path):
    """The reference's bf16 parameters carry across bit for bit; saved by
    the port they restore in the reference and back, bit for bit, as bf16."""
    jparams = _bf16_params(PAPER)
    tparams = params_from_jax(jparams, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for (path, w), g in zip(jflat, tree.leaves(tparams)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g), _jbits(w), err_msg=jax.tree_util.keystr(path))
    checkpoint.save(str(tmp_path / "t"), 2, tparams)
    back = jcheckpoint.restore(str(tmp_path / "t"), jparams)
    for (path, w), (_, r) in zip(jflat, jax.tree_util.tree_flatten_with_path(back)[0]):
        assert r.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_jbits(r), _jbits(w), err_msg=jax.tree_util.keystr(path))
    jcheckpoint.save(str(tmp_path / "j"), 3, jparams)
    again = checkpoint.restore(str(tmp_path / "j"), tparams)
    for a, c in zip(tree.leaves(again), tree.leaves(tparams)):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), c.view(torch.int16))
