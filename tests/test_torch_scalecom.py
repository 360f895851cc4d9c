"""repro_torch's ScaleCom reduce against ``repro.core.scalecom`` (jnp backend).

Teacher-forced: both sides start one step from the same residues and step
counter (carried across with ``state_from_jax``) and the same worker-stacked
gradients, made with numpy. ĝ and the residues agree to rtol 1e-6 / atol
1e-7: the worker mean is summed in another order. Plans and wire bytes are
equal field by field.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import resolve_backend as jresolve_backend
from repro.core import plan as jplan
from repro.core import scalecom as jsc
from repro.core import state as jstate
from repro.core.compressors import CompressorConfig as JComp
from repro.core.rates import RateRule as JRule
from repro_torch.backends import resolve_backend
from repro_torch.core import plan as tplan
from repro_torch.core import scalecom as tsc
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.rates import RateRule
from repro_torch.models.convert import state_from_jax

N = 4
CHUNK = 16
MIN_SIZE = 64
T = 5  # leader t mod G is neither 0 nor the last worker
# rowwise tails: 40 and 24 are no multiple of CHUNK; "small" stays dense
SHAPES = {"a": (6, 40), "b": {"w": (3, 64), "z": (2, 5, 24)}, "small": (10,)}


def _tree(fn, shapes, prefix=()):
    return {k: _tree(fn, v, prefix + (k,)) if isinstance(v, dict) else fn(prefix + (k,), v)
            for k, v in shapes.items()}


def _inputs(seed, groups, layout):
    rng = np.random.default_rng(seed)
    grads = _tree(lambda p, s: rng.standard_normal((N,) + s).astype(np.float32), SHAPES)
    params = _tree(lambda p, s: np.zeros(s, np.float32), SHAPES)
    G = groups or N
    js = jstate.init_state(params, G, "fp32", MIN_SIZE, layout)
    residues = {path: {"q": jnp.asarray(rng.standard_normal(enc["q"].shape).astype(np.float32))}
                for path, enc in js.residues.items()}
    return grads, jstate.ScaleComState(residues=residues, t=jnp.int32(T))


def _cfgs(compressor, layout, groups, **kw):
    common = dict(beta=0.1, min_size=MIN_SIZE, layout=layout, groups=groups)
    jkw = {k: v for k, v in kw.items() if k != "rate_rules"}
    jrules = tuple(JRule(r.pattern, r.chunk, r.topm) for r in kw.get("rate_rules", ()))
    jcfg = jsc.ScaleComConfig(compressor=JComp(compressor, chunk=CHUNK), backend="jnp",
                              fused=False, rate_rules=jrules, **common, **jkw)
    tcfg = tsc.ScaleComConfig(compressor=CompressorConfig(compressor, chunk=CHUNK),
                              backend="torch", **common, **kw)
    return jcfg, tcfg


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}['{k}']") if isinstance(v, dict) else {f"{prefix}['{k}']": v})
    return out


def _run_both(compressor, layout, groups, backend="torch", **kw):
    grads, jst = _inputs(zlib.crc32(repr((compressor, layout, groups)).encode()), groups, layout)
    jcfg, tcfg = _cfgs(compressor, layout, groups, **kw)
    tcfg = dataclasses.replace(tcfg, backend=backend)
    jg, jnew, jstats = jsc.scalecom_reduce(_map(jnp.asarray, grads), jst, jcfg,
                                           compute_stats=True, buckets=False)
    tg, tnew, tstats = tsc.scalecom_reduce(_map(torch.from_numpy, grads),
                                           state_from_jax(jst, "cpu"), tcfg, compute_stats=True)
    return (jg, jnew, jstats), (tg, tnew, tstats)


@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("compressor", ["clt_k", "true_topk", "local_topk"])
def test_reduce_step_matches_jax(compressor, layout, groups):
    (jg, jnew, jstats), (tg, tnew, tstats) = _run_both(compressor, layout, groups)
    jflat, tflat = _flat(jg), _flat(tg)
    assert jflat.keys() == tflat.keys()
    for path in jflat:
        np.testing.assert_allclose(tflat[path].numpy(), np.asarray(jflat[path]),
                                   rtol=1e-6, atol=1e-7, err_msg=path)
    assert jnew.residues.keys() == tnew.residues.keys()
    for path, enc in jnew.residues.items():
        np.testing.assert_allclose(tnew.residues[path]["q"].numpy(), np.asarray(enc["q"]),
                                   rtol=1e-6, atol=1e-7, err_msg=path)
    assert tnew.t == int(jnew.t) == T + 1
    for key in ("comm_bytes_per_worker", "comm_bytes_dense"):
        assert np.float32(tstats[key]) == np.asarray(jstats[key]), key
    np.testing.assert_allclose(float(tstats["contraction_gamma"]),
                               float(jstats["contraction_gamma"]), rtol=1e-5)


@pytest.mark.parametrize("compressor", ["clt_k", "true_topk", "local_topk"])
def test_cuda_backend_layout_layer_matches_torch_backend(compressor):
    """The "cuda" backend on CPU tensors: the kernels' plain versions behind
    the cuda layout layer give the torch backend's reduce, bit for bit."""
    _, (tg, tnew, _) = _run_both(compressor, "rowwise", None, backend="torch")
    _, (cg, cnew, _) = _run_both(compressor, "rowwise", None, backend="cuda")
    for path, v in _flat(tg).items():
        assert torch.equal(v, _flat(cg)[path]), path
    for path, enc in tnew.residues.items():
        assert torch.equal(enc["q"], cnew.residues[path]["q"]), path


@pytest.mark.parametrize("mode", ["clt_k", "true_topk"])
@pytest.mark.parametrize("backend,topm", [("torch", 1), ("torch", 2), ("cuda", 1), ("cuda", 2)])
def test_fused_reduce_composition_matches_jax(backend, topm, mode):
    """fused_reduce (the torch backend's composition of the primitives, the
    cuda backend's kernel through its plain version on CPU tensors) against
    the JAX jnp backend's, with a chunk tail."""
    rng = np.random.default_rng(topm)
    m, g = (rng.standard_normal((N, 3, 100)).astype(np.float32) for _ in range(2))
    leader = 2 if mode == "clt_k" else None
    want = jresolve_backend("jnp").fused_reduce(jnp.asarray(m), jnp.asarray(g), 0.1, CHUNK, topm,
                                                mode, None if leader is None else jnp.int32(leader))
    got = resolve_backend(backend).fused_reduce(torch.from_numpy(m), torch.from_numpy(g), 0.1,
                                                CHUNK, topm, mode, leader)
    for name, a, b in zip(("idx", "vals", "m_new", "ghat"), got, want):
        if name in ("idx", "vals"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("groups", [None, 2])
def test_plans_equal_field_by_field(layout, groups):
    rules = (RateRule(r"\['a'\]", 8, 2), RateRule(r"\['z'\]", None))
    grads, jst = _inputs(0, groups, layout)
    jcfg, tcfg = _cfgs("clt_k", layout, groups, rate_rules=rules)
    leaves = tuple((p, g.shape[1:], g.shape[0]) for p, g in _flat(grads).items())
    jp = jplan.plan_tensors(leaves, jcfg, jstate.residue_signature(jst.residues))
    tp = tplan.plan_tensors(leaves, tcfg, tstate.residue_signature(state_from_jax(jst, "cpu").residues))
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        for f in dataclasses.fields(tplan.TensorPlan):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if f.name == "comp":
                va = None if va is None else (va.name, va.chunk, va.topm)
                vb = None if vb is None else (vb.name, vb.chunk, vb.topm)
            assert va == vb, (a.path, f.name, va, vb)
        assert a.dense == b.dense


def test_state_drift_names_the_layout():
    grads, jst = _inputs(0, None, "flat")
    st = state_from_jax(jst, "cpu")
    _, tcfg = _cfgs("clt_k", "rowwise", None)
    with pytest.raises(ValueError, match="initialized under layout='flat'"):
        tsc.scalecom_reduce(_map(torch.from_numpy, grads), st, tcfg)


def test_env_vars_resolve_at_call_time(monkeypatch):
    monkeypatch.delenv("SCALECOM_TORCH_LAYOUT", raising=False)
    monkeypatch.delenv("SCALECOM_TORCH_BACKEND", raising=False)
    monkeypatch.setenv("SCALECOM_LAYOUT", "rowwise")  # the JAX package's name: ignored
    monkeypatch.setenv("SCALECOM_BACKEND", "pallas")
    assert tstate.resolve_layout("auto") == "flat"
    assert resolve_backend("auto", "cpu").name == "torch"
    assert resolve_backend("auto", "cuda").name == "cuda"  # the device decides, no probe
    monkeypatch.setenv("SCALECOM_TORCH_LAYOUT", "rowwise")
    monkeypatch.setenv("SCALECOM_TORCH_BACKEND", "cuda")
    assert tstate.resolve_layout("auto") == "rowwise"
    assert tstate.resolve_layout("flat") == "flat"  # explicit wins
    assert resolve_backend("auto", "cpu").name == "cuda"
    assert resolve_backend("torch", "cpu").name == "torch"
    monkeypatch.setenv("SCALECOM_TORCH_LAYOUT", "diagonal")
    with pytest.raises(ValueError, match="flat"):
        tstate.resolve_layout("auto")
    monkeypatch.setenv("SCALECOM_TORCH_BACKEND", "pallas")
    with pytest.raises(ValueError, match="registered"):
        resolve_backend("auto", "cpu")


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: tsc.ScaleComConfig(telemetry=True, metrics_every=-1), "telemetry"),
        (lambda: tsc.ScaleComConfig(residue_dtype="fp16"), "residue_dtype"),
    ],
)
def test_unported_options_raise(make, match):
    """Telemetry and the lossy codecs are ported now: the options construct,
    and only a bad value raises, naming the option."""
    tsc.ScaleComConfig(telemetry=True, metrics_every=2)
    for dtype in ("fp32", "bf16", "fp8", "fp8_ec"):
        tsc.ScaleComConfig(residue_dtype=dtype)
    with pytest.raises(ValueError, match=match):
        make()
