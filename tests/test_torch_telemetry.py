"""repro_torch's telemetry taps and similarity metrics against ``repro.core``.

The tap key set of a reduce with ``telemetry=True`` equals the JAX
package's, key string for key string (per tensor, per bucket, with
``metrics_every`` 0 and 2). From the same state, gradients and draws
(JAX's random_k offsets and stochastic-rounding bits handed to the port's
draw functions), every tap value agrees to rtol 1e-5 / atol 1e-6: the
similarity metrics, wire bytes measured and planned, build-up, codec
roundtrip error, contraction gamma. Taps are 0-d float32 tensors on the
gradients' device, and ĝ and the residues are bitwise those of telemetry
off. Each ``core.metrics`` function matches its JAX counterpart, ties
included, at the same tolerance; ``contraction_gamma`` of ``compute_stats``
matches to rtol 1e-6 and stays a tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import scalecom as jsc
from repro.core import state as jstate
from repro.core.compressors import CompressorConfig as JComp
from repro.obs import taps as jtaps
from repro_torch.core import compressors as tcomp
from repro_torch.core import metrics as tmetrics
from repro_torch.core import scalecom as tsc
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.models.convert import state_from_jax
from repro_torch.obs import taps

N, CHUNK, MIN_SIZE = 4, 8, 64
SIZES = {"a": (96,), "b": (24, 16), "c": (520,), "d": (3, 5, 40), "tiny": (16,)}
COMPRESSORS = ("clt_k", "true_topk", "local_topk", "random_k")


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's random_k and stochastic-rounding draws return JAX's bits."""
    def draw(t, shape, device, high=None):
        key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
        if high is None:
            return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape)))).to(device)
        return torch.from_numpy(np.array(jax.random.randint(key, tuple(shape), 0, high,
                                                            dtype=jnp.int32))).to(device)

    def dither(key, shape, device):
        bits = jax.random.bits(jstate.codec_key(key[0], jnp.int32(key[1])), tuple(shape),
                               jnp.uint32) >> 16
        return torch.from_numpy(np.asarray(bits).astype(np.int32)).to(device)

    monkeypatch.setattr(tcomp, "random_draw", draw)
    monkeypatch.setattr(tstate, "codec_dither", dither)


def _cfgs(compressor="clt_k", **kw):
    common = dict(beta=0.25, min_size=MIN_SIZE, **kw)
    return (jsc.ScaleComConfig(compressor=JComp(compressor, chunk=CHUNK), backend="jnp",
                               **{"fused": False, **common}),
            tsc.ScaleComConfig(compressor=CompressorConfig(compressor, chunk=CHUNK),
                               backend="torch", **common))


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in SIZES.items()}


def _start(jcfg, seed):
    """A JAX state with random residues (nearest-encoded by the config's
    codec) at step t = 4, and its port copy."""
    rng = np.random.default_rng(seed + 1)
    params = {k: jnp.zeros(s) for k, s in SIZES.items()}
    js = jstate.init_state(params, N, jcfg.residue_dtype, MIN_SIZE, jcfg.layout)
    codec = jstate.CODECS[jcfg.residue_dtype]
    residues = {}
    for path, enc in js.residues.items():
        storage = jstate.storage_shape(SIZES[path[2:-2]], jcfg.layout)
        m = rng.standard_normal((N,) + storage).astype(np.float32)
        residues[path] = codec.encode(jnp.asarray(m), storage)
    return jstate.ScaleComState(residues=residues, t=jnp.int32(4))


def _run_both(jcfg, tcfg, buckets, seed=0, steps=1):
    js = _start(jcfg, seed)
    out = []
    for step in range(steps):
        g = _grads(seed * 10 + step)
        jg, jnew, jstats = jsc.scalecom_reduce({k: jnp.asarray(v) for k, v in g.items()}, js,
                                               jcfg, buckets=buckets)
        tg, tnew, tstats = tsc.scalecom_reduce({k: torch.from_numpy(v) for k, v in g.items()},
                                               state_from_jax(js, "cpu"), tcfg, buckets=buckets)
        out.append((jstats, tstats))
        js = jnew
    return out


def _obs(stats):
    return {k: v for k, v in stats.items() if k.startswith("obs/")}


@pytest.mark.parametrize("metrics_every", [0, 2])
@pytest.mark.parametrize("buckets", [False, 1024], ids=["unbucketed", "bucketed"])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_tap_keys_match_jax(compressor, buckets, metrics_every, jax_draws):
    jcfg, tcfg = _cfgs(compressor, telemetry=True, metrics_every=metrics_every)
    (jstats, tstats), = _run_both(jcfg, tcfg, buckets)
    assert list(_obs(tstats)) == sorted(_obs(jstats))
    assert list(_obs(tstats)) == sorted(_obs(tstats))
    names = {taps.parse_key(k[4:])[0] for k in _obs(tstats)}
    assert ("similarity_sampled" in names) == (metrics_every > 0)
    assert ("bucket_staged_leaves" in names) == (buckets is not False)
    for key, value in _obs(tstats).items():
        assert isinstance(value, torch.Tensor) and value.dim() == 0, key
        assert value.dtype == torch.float32 and value.device.type == "cpu", key


@pytest.mark.parametrize(
    "compressor,residue_dtype,layout,fused,buckets",
    [
        ("clt_k", "fp32", "flat", False, False),
        ("clt_k", "bf16", "rowwise", False, 1024),
        ("clt_k", "fp8_ec", "flat", True, False),
        ("true_topk", "fp8", "rowwise", True, 600),
        ("local_topk", "fp32", "rowwise", False, False),
        ("random_k", "bf16", "flat", False, 1024),
    ],
)
def test_tap_values_match_jax(compressor, residue_dtype, layout, fused, buckets, jax_draws):
    """Three steps from t = 4 with metrics_every 2: sampled, unsampled, sampled."""
    jcfg, tcfg = _cfgs(compressor, telemetry=True, metrics_every=2, residue_dtype=residue_dtype,
                       layout=layout, fused=fused)
    for step, (jstats, tstats) in enumerate(_run_both(jcfg, tcfg, buckets, seed=3, steps=3)):
        jo, to = _obs(jstats), _obs(tstats)
        assert list(to) == sorted(jo)
        for key in jo:
            np.testing.assert_allclose(float(to[key]), float(jo[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {key}")
        sampled = [float(v) for k, v in to.items() if "similarity_sampled" in k]
        assert sampled and set(sampled) == {1.0 if step % 2 == 0 else 0.0}
        if step % 2:  # an unsampled step taps zeros under the same keys
            assert all(float(v) == 0.0 for k, v in to.items() if "spearman_rho" in k)


def test_taps_measure_what_they_name(jax_draws):
    jcfg, tcfg = _cfgs("clt_k", telemetry=True, residue_dtype="bf16")
    (_, tstats), = _run_both(jcfg, tcfg, False)
    for path in ("['a']", "['b']", "['c']", "['d']"):
        measured = tstats[f"obs/bytes_measured{{compressor=clt_k,path={path}}}"]
        planned = tstats[f"obs/bytes_planned{{compressor=clt_k,path={path}}}"]
        assert float(measured) == float(planned) > 0
        assert 0 < float(tstats[f"obs/codec_roundtrip_err{{codec=bf16,path={path}}}"]) < 6e-3
        assert float(tstats[f"obs/fused_launches{{path={path}}}"]) == 3.0
    _, tcfg32 = _cfgs("local_topk", telemetry=True)
    g = {k: torch.from_numpy(v) for k, v in _grads(1).items()}
    st = tstate.init_state({k: torch.zeros(s) for k, s in SIZES.items()}, N, min_size=MIN_SIZE)
    _, _, stats = tsc.scalecom_reduce(g, st, tcfg32)
    k = float(stats["obs/buildup_k{path=['c']}"])
    assert float(stats["obs/buildup_nnz{path=['c']}"]) > k  # union growth
    assert float(stats["obs/codec_roundtrip_err{codec=fp32,path=['c']}"]) == 0.0


def _trajectory(cfg, buckets, steps=4):
    gen = torch.Generator().manual_seed(0)
    state = tstate.init_state({k: torch.zeros(s) for k, s in SIZES.items()}, N,
                              cfg.residue_dtype, MIN_SIZE, cfg.layout)
    out = []
    for _ in range(steps):
        g = {k: torch.randn((N,) + s, generator=gen) for k, s in SIZES.items()}
        ghat, state, stats = tsc.scalecom_reduce(g, state, cfg, compute_stats=True,
                                                 buckets=buckets)
        out.append((ghat, stats))
    return out, state


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("buckets", [False, 1024], ids=["unbucketed", "bucketed"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("residue_dtype,layout", [("fp32", "flat"), ("bf16", "rowwise"),
                                                  ("fp8_ec", "flat")])
def test_telemetry_on_is_bitwise_off(residue_dtype, layout, fused, buckets):
    """The port's own draws on both runs: telemetry changes nothing else."""
    _, off = _cfgs(residue_dtype=residue_dtype, layout=layout, fused=fused)
    on = dataclasses.replace(off, telemetry=True, metrics_every=2)
    (ref, ref_state), (got, got_state) = _trajectory(off, buckets), _trajectory(on, buckets)
    for (ga, sa), (gb, sb) in zip(ref, got):
        for k in SIZES:
            assert torch.equal(_bits(ga[k]), _bits(gb[k])), k
        assert not _obs(sa) and _obs(sb)
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
    for path, enc in ref_state.residues.items():
        for k, v in enc.items():
            assert torch.equal(_bits(v), _bits(got_state.residues[path][k])), (path, k)


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("compressor", ["clt_k", "true_topk", "local_topk"])
def test_compute_stats_gamma_matches_jax_and_stays_a_tensor(compressor, layout):
    jcfg, tcfg = _cfgs(compressor, layout=layout)
    js = _start(jcfg, 5)
    g = _grads(5)
    _, _, jstats = jsc.scalecom_reduce({k: jnp.asarray(v) for k, v in g.items()}, js, jcfg,
                                       compute_stats=True, buckets=False)
    _, _, tstats = tsc.scalecom_reduce({k: torch.from_numpy(v) for k, v in g.items()},
                                       state_from_jax(js, "cpu"), tcfg, compute_stats=True)
    gamma = tstats["contraction_gamma"]
    assert isinstance(gamma, torch.Tensor) and gamma.dim() == 0
    np.testing.assert_allclose(float(gamma), float(jstats["contraction_gamma"]), rtol=1e-6)


def _tied(rng, shape):
    """Integer values in [-3, 3]: most magnitudes tie."""
    return rng.integers(-3, 4, shape).astype(np.float32)


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "ties"])
def test_metrics_match_jax(tied):
    rng = np.random.default_rng(11)
    make = (lambda s: _tied(rng, s)) if tied else (
        lambda s: rng.standard_normal(s).astype(np.float32))
    stacked = make((5, 300))
    x, y = stacked[0], stacked[1]
    J, T = jnp.asarray, torch.from_numpy
    pairs = [
        (jmetrics.cosine_distance(J(x), J(y)), tmetrics.cosine_distance(T(x), T(y))),
        (jmetrics.pairwise_cosine_distance(J(stacked)), tmetrics.pairwise_cosine_distance(T(stacked))),
        (jmetrics.contraction_gamma(J(x), J(y)), tmetrics.contraction_gamma(T(x), T(y))),
        (jmetrics.spearman_rho(J(x), J(y)), tmetrics.spearman_rho(T(x), T(y))),
    ]
    for k in (1, 7, 37, 300):
        pairs += [
            (jmetrics.hamming_distance_topk(J(x), J(y), k),
             tmetrics.hamming_distance_topk(T(x), T(y), k)),
            (jmetrics.topk_overlap(J(x), J(y), k), tmetrics.topk_overlap(T(x), T(y), k)),
        ]
        want = jmetrics.residue_similarity_report(J(stacked), k)
        got = tmetrics.residue_similarity_report(T(stacked), k)
        assert list(got) == list(want)
        pairs += [(want[name], got[name]) for name in want]
    for i, (want, got) in enumerate(pairs):
        assert isinstance(got, torch.Tensor) and got.dim() == 0, i
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6, err_msg=str(i))


def test_topk_mask_breaks_ties_toward_the_lower_index():
    x = np.array([1.0, -3.0, 3.0, 2.0, -3.0, 0.0], np.float32)
    for k in range(1, 7):
        want = np.asarray(jmetrics._topk_mask(jnp.asarray(x), k))
        assert np.array_equal(tmetrics._topk_mask(torch.from_numpy(x), k).numpy(), want), k


def test_tap_collector_is_the_jax_collector():
    """Keys, parsing, no-op without a collector, nesting: as repro.obs.taps."""
    for name, labels in (("a", {}), ("b", {"path": "['x']['y']", "bucket": 3}),
                         ("c", {"overlap": True, "z": 1, "a": "q"})):
        assert taps.tap_key(name, **labels) == jtaps.tap_key(name, **labels)
        key = taps.tap_key(name, **labels)
        assert taps.parse_key(key) == jtaps.parse_key(key)
    assert not taps.active()
    taps.tap("ignored", 1.0)
    with taps.collect() as outer:
        assert taps.active()
        taps.tap("x", 1.0)
        with taps.collect() as inner:
            taps.tap("x", 2.0, path="p")
        taps.tap("y", 3.0)
    assert outer == {"x": 1.0, "y": 3.0} and inner == {"x{path=p}": 2.0}
    assert not taps.active()
