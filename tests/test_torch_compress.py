"""repro_torch's compressors module against ``repro.core.compressors``.

Covers the top-m select and gather kernels (their plain versions through the
cuda backend's layout layer, against the Pallas ``_topm_kernel`` and
``_gather_kernel`` in interpret mode), ``compress()`` for every compressor,
random_k and the exact dense top-k path.

random_k: the port draws from its own ``torch.Generator`` and cannot give
``jax.random``'s bits, so parity tests hand the port JAX's draws through
``repro_torch.core.compressors.random_draw``; the port's own draw is tested
for its tail clamp, distinct top-m offsets and rough uniformity.

Tolerances: indices and selected values bitwise (a select only copies);
worker means (dense ĝ, m') rtol 1e-6 / atol 1e-7, summed in another order.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import resolve_backend as jresolve_backend
from repro.core import chunked as jchunked
from repro.core import compressors as jcomp
from repro.core import scalecom as jsc
from repro.core import state as jstate
from repro.kernels import rowwise
from repro_torch.backends import resolve_backend
from repro_torch.core import compressors as tcomp
from repro_torch.core import scalecom as tsc
from repro_torch.core.chunked import num_chunks
from repro_torch.models.convert import state_from_jax

G = 3
T = 4  # leader t mod G is 1
SHAPES = [(64, 8), (100, 16), (17, 4), (5, 8), (37, 37)]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jpad(x, chunk):
    return jchunked.pad_to_chunks(jnp.asarray(x), chunk)


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("size,chunk", SHAPES)
def test_topm_select_matches_pallas_topm_kernel(size, chunk, ties):
    """cuda backend select at topm 2, 3 and chunk (chunk_topm's plain
    version) against the Pallas _topm_kernel: offsets and signed values."""
    rng = _rng(size, chunk, ties)
    x = (rng.integers(-3, 4, size=(G, 2, size)) if ties
         else rng.standard_normal((G, 2, size))).astype(np.float32)
    for topm in sorted({2, min(3, chunk), chunk}):
        idx, val = resolve_backend("cuda").select(_t(x), chunk, topm)
        pi, pv = rowwise.select_trailing(_jpad(x, chunk), chunk, topm=topm)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pi), err_msg=str(topm))
        np.testing.assert_array_equal(val.numpy(), np.asarray(pv), err_msg=str(topm))


@pytest.mark.parametrize("per_worker", [False, True])
@pytest.mark.parametrize("topm", [1, 2])
@pytest.mark.parametrize("size,chunk", SHAPES)
def test_gather_matches_pallas_gather_kernel(size, chunk, topm, per_worker):
    """cuda backend gather (chunk_gather's plain version) against the Pallas
    _gather_kernel, with one shared index set or one per worker."""
    rng = _rng(size, chunk, topm, per_worker)
    x = rng.standard_normal((G, size)).astype(np.float32)
    ncr = num_chunks(size, chunk)
    perm = np.argsort(rng.random(((G,) if per_worker else ()) + (ncr, chunk)), axis=-1)
    idx = perm[..., :topm].astype(np.int32)
    idx = idx[..., 0] if topm == 1 else idx
    got = resolve_backend("cuda").gather(_t(x), _t(idx), chunk, topm)
    want = rowwise.gather_trailing(_jpad(x, chunk), jnp.asarray(idx), chunk, topm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, resolve_backend("torch").gather(_t(x), _t(idx), chunk, topm))


def _jax_draw(t, shape, high=None):
    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
    if high is None:
        return np.array(jax.random.uniform(key, tuple(shape)))
    return np.array(jax.random.randint(key, tuple(shape), 0, high, dtype=jnp.int32))


@pytest.fixture
def jax_draws(monkeypatch):
    """Make the port's random_k draw return jax.random's bits for the same
    (salt, t). With ``exact`` set to a CompressorConfig, a 1-D draw is the
    exact path's: keys ranking JAX's ``choice(replace=False)`` offsets
    first, in JAX's order."""
    exact = {}

    def draw(t, shape, device, high=None):
        if high is None and len(shape) == 1 and exact:
            size = shape[0]
            k = tcomp.exact_k(size, exact["cfg"])
            key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
            chosen = np.asarray(jax.random.choice(key, size, (k,), replace=False))
            keys = np.full(size, -1.0, np.float32)
            keys[chosen] = np.arange(k, 0, -1, dtype=np.float32)
            return torch.from_numpy(keys).to(device)
        return torch.from_numpy(_jax_draw(t, shape, high)).to(device)

    monkeypatch.setattr(tcomp, "random_draw", draw)
    return exact


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("topm", [1, 2])
@pytest.mark.parametrize("name", ["clt_k", "true_topk", "local_topk", "random_k", "none"])
def test_compress_matches_jax(name, topm, backend, jax_draws):
    rng = _rng(name, topm, backend)
    size, chunk = 100, 16  # a chunk tail of 4 real lanes
    ef = rng.standard_normal((G, size)).astype(np.float32)
    jv, ji, jd = jcomp.compress(jnp.asarray(ef), jnp.int32(T), jcomp.CompressorConfig(name, chunk, topm),
                                backend=jresolve_backend("jnp"))
    tv, ti, td = tcomp.compress(_t(ef), T, tcomp.CompressorConfig(name, chunk, topm),
                                backend=resolve_backend(backend))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(td.numpy(), np.asarray(jd))
    assert ti.dtype == torch.int32 and td.shape == (size,)


@pytest.mark.parametrize("topm", [1, 3])
@pytest.mark.parametrize("name", ["clt_k", "true_topk", "local_topk", "random_k"])
def test_exact_path_matches_jax(name, topm, jax_draws):
    rng = _rng("exact", name, topm)
    size = 300
    ef = rng.standard_normal((G, size)).astype(np.float32)
    jcfg = jcomp.CompressorConfig(name, 16, topm, exact=True)
    tcfg = jax_draws["cfg"] = tcomp.CompressorConfig(name, 16, topm, exact=True)
    jv, ji, jd = jcomp._compress_exact(jnp.asarray(ef), jnp.int32(T), jcfg)
    tv, ti, td = tcomp.compress(_t(ef), T, tcfg)
    assert tcomp.exact_k(size, tcfg) == jcomp.exact_k(size, jcfg) == ti.shape[-1] == ji.shape[-1]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(td.numpy(), np.asarray(jd))


def test_exact_top_k_breaks_ties_to_the_lower_index():
    ef = torch.tensor([[1.0, -3.0, 3.0, 0.0, -3.0, 2.0, 3.0, 1.0]] * 2)
    _, idx, _ = tcomp.compress(ef, 0, tcomp.CompressorConfig("true_topk", 4, 2, exact=True))
    assert idx.tolist() == [1, 2, 4, 6]


def _reduce_inputs(rng, layout, shapes):
    grads = {k: rng.standard_normal((G,) + s).astype(np.float32) for k, s in shapes.items()}
    js = jstate.init_state({k: np.zeros(s, np.float32) for k, s in shapes.items()}, G, "fp32",
                           64, layout)
    res = {p: {"q": jnp.asarray(rng.standard_normal(e["q"].shape).astype(np.float32))}
           for p, e in js.residues.items()}
    return grads, jstate.ScaleComState(residues=res, t=jnp.int32(T))


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("name,exact", [("random_k", False), ("random_k", True),
                                        ("clt_k", True), ("local_topk", True)])
def test_reduce_random_k_and_exact_match_jax(name, exact, layout, jax_draws):
    shapes = {"a": (6, 40), "b": (3, 50)}
    grads, jst = _reduce_inputs(_rng(name, exact, layout), layout, shapes)
    common = dict(beta=0.1, min_size=64, layout=layout, fused=True)  # neither fuses
    jcfg = jsc.ScaleComConfig(compressor=jcomp.CompressorConfig(name, 16, 1, exact=exact),
                              backend="jnp", **common)
    tcfg = tsc.ScaleComConfig(compressor=tcomp.CompressorConfig(name, 16, 1, exact=exact),
                              backend="cuda", **common)
    jax_draws["cfg"] = tcfg.compressor
    jg, jnew, _ = jsc.scalecom_reduce({k: jnp.asarray(v) for k, v in grads.items()}, jst, jcfg,
                                      buckets=False)
    tg, tnew, _ = tsc.scalecom_reduce({k: _t(v) for k, v in grads.items()},
                                           state_from_jax(jst, "cpu"), tcfg)
    for k in grads:
        _close(tg[k].numpy(), np.asarray(jg[k]), k)
    for path, enc in jnew.residues.items():
        _close(tnew.residues[path]["q"].numpy(), np.asarray(enc["q"]), path)


def test_random_draw_is_seeded_by_salt_and_step():
    a = tcomp.random_draw(7, (5, 4), "cpu", high=16)
    assert a.dtype == torch.int32 and torch.equal(a, tcomp.random_draw(7, (5, 4), "cpu", high=16))
    assert not torch.equal(a, tcomp.random_draw(8, (5, 4), "cpu", high=16))
    u = tcomp.random_draw(7, (1000,), "cpu")
    assert u.dtype == torch.float32 and 0.0 <= float(u.min()) and float(u.max()) < 1.0


@pytest.mark.parametrize("topm", [1, 3])
def test_own_random_draw_clamps_tail_and_keeps_top_m_distinct(topm):
    size, chunk = 1000, 64  # 16 chunks, the last with 40 real lanes
    ef = torch.zeros(G, 2, size)
    cfg = tcomp.CompressorConfig("random_k", chunk, topm)
    be = resolve_backend("torch")
    for t in range(40):
        idx = tcomp.select_indices(ef, t, cfg, be)
        assert idx.shape == (2, 16) + (() if topm == 1 else (topm,))
        assert int(idx.min()) >= 0 and int(idx.max()) < chunk
        assert int(idx[:, -1].max()) < 40
        if topm > 1:
            s = torch.sort(idx, dim=-1).values
            assert bool((s[..., 1:] > s[..., :-1]).all())


def test_own_random_draw_is_roughly_uniform():
    chunk, steps = 8, 400
    cfg = tcomp.CompressorConfig("random_k", chunk, 1)
    ef = torch.zeros(1, 64 * chunk)
    counts = torch.zeros(chunk)
    for t in range(steps):
        idx = tcomp.select_indices(ef, t, cfg, resolve_backend("torch"))
        counts += torch.bincount(idx.long(), minlength=chunk)
    expected = steps * 64 / chunk  # 3200 per offset
    assert float((counts - expected).abs().max()) < 0.1 * expected
