"""repro_torch's residue codecs, remap and codec reduce against ``repro.core.state``.

Nearest rounding is bitwise. Stochastic rounding is bitwise given JAX's own
dither (``jax.random.bits(codec_key(path, t)) >> 16``), handed to the port
through its one draw function ``codec_dither``; the port's own draw is held
to being seeded by (path, t) and unbiased. Decodes are bitwise (NaN where
NaN). ``remap_state`` agrees after decode to rtol 1e-6 and round-trips
8 -> 4 -> 8 bitwise for fp32. A 5-step teacher-forced reduce per codec, both
layouts, fused and unfused, gives JAX's residues bit for bit and its ĝ (and
so its indices: the nonzero pattern) to rtol 1e-6 / atol 1e-7, the worker
mean being summed in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scalecom as jsc
from repro.core import state as jstate
from repro.core.compressors import CompressorConfig as JComp
from repro_torch.core import scalecom as tsc
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.models.convert import residue_bits, state_from_jax

CODECS = ("fp32", "bf16", "fp8", "fp8_ec")
LOSSY = ("bf16", "fp8", "fp8_ec")
# flat sizes on and off the 512-element fp8 block; rowwise shapes with a
# last dim off the chunk, and a 1-D rowwise tensor (fp8 pads it like flat)
STORAGES = [(1000,), (1024,), (3, 7, 40), (5, 1030)]
N, CHUNK, MIN_SIZE, T = 4, 16, 64, 5
SHAPES = {"a": (6, 40), "b": {"w": (3, 64), "z": (2, 5, 24)}, "big": (1100,), "small": (10,)}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(_UINT[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    return _bits(t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()]).numpy())


def _jax_dither(key, shape, device):
    """JAX's stochastic-rounding bits for ``key = (path, t)``, as the port's draw."""
    path, t = key
    bits = jax.random.bits(jstate.codec_key(path, jnp.int32(t)), tuple(shape), jnp.uint32) >> 16
    return torch.from_numpy(np.asarray(bits).astype(np.int32)).to(device)


@pytest.fixture
def jax_dither(monkeypatch):
    monkeypatch.setattr(tstate, "codec_dither", _jax_dither)


def _residue(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    flat[::37], flat[5::41] = 0.0, -0.0
    return x


def _assert_enc_equal(jenc, tenc, what):
    assert sorted(jenc) == sorted(tenc), what
    for k in jenc:
        assert np.array_equal(_bits(jenc[k]), _tbits(tenc[k])), (what, k)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("storage", STORAGES, ids=str)
@pytest.mark.parametrize("name", CODECS)
def test_encode_decode_match_jax(name, storage, rounding, jax_dither):
    rng = np.random.default_rng(len(storage) * 1000 + storage[-1])
    for scale in (1.0, 1e-4, 3e3):
        x = _residue(rng, (N,) + storage, scale)
        jkey = None if rounding == "nearest" else jstate.codec_key("['w']", jnp.int32(T))
        tkey = None if rounding == "nearest" else tstate.codec_key("['w']", T)
        jenc = jstate.CODECS[name].encode(jnp.asarray(x), storage, key=jkey)
        tenc = tstate.CODECS[name].encode(torch.from_numpy(x), storage, key=tkey)
        _assert_enc_equal(jenc, tenc, (name, storage, scale, rounding))
        jd = np.asarray(jstate.CODECS[name].decode(jenc, storage))
        td = tstate.CODECS[name].decode(tenc, storage)
        assert td.shape == jd.shape and td.dtype == torch.float32
        assert np.array_equal(_bits(jd), _tbits(td)), (name, storage, scale, "decode")


def _edges(fp32_subnormals=True):
    rng = np.random.default_rng(7)
    payload = (np.uint32(0x7F800000) | rng.integers(1, 1 << 22, 16).astype(np.uint32))
    nans = payload.view(np.float32)
    specials = np.array(
        [0.0, -0.0, 448.0, 448.01, 455.0, 463.99, 464.0, 464.01, 470.0, 479.9, 480.0, 1e9,
         3.39e38, 3.4028235e38, np.inf, np.nan, 2.0**-9, 2.0**-10, 1.5 * 2.0**-9, 2.0**-7,
         1.0001 * 2.0**-10, 1e-30, 1e-40, 2e-45, 1.0 + 2.0**-9, 1.0 + 3 * 2.0**-9], np.float32)
    normal = rng.standard_normal(4096).astype(np.float32) * np.float32(100)
    x = np.concatenate([specials, -specials, nans, -nans, normal])
    if not fp32_subnormals:
        x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    return x


def test_casts_match_ml_dtypes_at_the_edges():
    """The e4m3 and bf16 casts against JAX's (ml_dtypes) bit for bit: a hair
    above 448, 464 (the tie), overflow and +-inf (NaN, not saturated), NaN
    payloads of both signs, subnormals, +-0."""
    x = _edges()
    want8 = _bits(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    want16 = _bits(jnp.asarray(x).astype(jnp.bfloat16))
    assert np.array_equal(_tbits(tstate._to_e4m3(torch.from_numpy(x))), want8)
    assert np.array_equal(_tbits(tstate._to_bf16(torch.from_numpy(x))), want16)


@pytest.mark.parametrize("name", LOSSY)
def test_encode_with_non_finite_residues_matches_jax(name, jax_dither):
    """Whole blocks of inf, NaN and overflow through encode, on the CPU.
    Without fp32 subnormals: XLA's CPU arithmetic flushes them to zero (in
    fp8_ec's m - q * scale), PyTorch's does not."""
    e = _edges(fp32_subnormals=False)
    x = np.stack([np.resize(e, 1030), np.resize(e[::-1], 1030)])
    for key in (None, ("['w']", 3)):
        jkey = None if key is None else jstate.codec_key(key[0], jnp.int32(key[1]))
        jenc = jstate.CODECS[name].encode(jnp.asarray(x), (1030,), key=jkey)
        tenc = tstate.CODECS[name].encode(torch.from_numpy(x), (1030,), key=key)
        _assert_enc_equal(jenc, tenc, (name, key))


def test_stochastic_round_matches_jax_given_its_bits():
    x = _edges()
    key = jstate.codec_key("['blocks']['w']", jnp.int32(11))
    want = _bits(jstate.stochastic_round(jnp.asarray(x), key, jnp.bfloat16))
    got = tstate.stochastic_round(torch.from_numpy(x),
                                  _jax_dither(("['blocks']['w']", 11), x.shape, "cpu"))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_tbits(got), want)


def test_dither_is_seeded_by_path_and_step():
    d = tstate.codec_dither(("['w']", 3), (4, 1000), "cpu")
    assert d.dtype == torch.int32 and d.shape == (4, 1000)
    assert int(d.min()) >= 0 and int(d.max()) < 1 << 16
    assert torch.equal(d, tstate.codec_dither(("['w']", 3), (4, 1000), "cpu"))
    assert not torch.equal(d, tstate.codec_dither(("['w']", 4), (4, 1000), "cpu"))
    assert not torch.equal(d, tstate.codec_dither(("['v']", 3), (4, 1000), "cpu"))
    # the reduce's draw: an encode keyed by (path, t) repeats, and moves with t
    m = torch.randn(4, 1000, generator=torch.Generator().manual_seed(0))
    codec = tstate.CODECS["bf16"]
    a = codec.encode(m, (1000,), key=tstate.codec_key("['w']", 3))["q"]
    assert torch.equal(a.view(torch.int16),
                       codec.encode(m, (1000,), key=("['w']", 3))["q"].view(torch.int16))
    assert not torch.equal(a.view(torch.int16),
                           codec.encode(m, (1000,), key=("['w']", 4))["q"].view(torch.int16))


def test_stochastic_rounding_is_unbiased():
    """The port's own draws: the mean over 4096 steps' dithers converges to
    the fp32 value (bias under a fifth of nearest rounding's, as the JAX
    package's test), which nearest rounding does not."""
    x = torch.tensor([1.0 + 2.0**-9, -0.3, 3.14159e-3])
    samples = torch.stack([
        tstate.stochastic_round(x, tstate.codec_dither(("['w']", t), x.shape, "cpu")).float()
        for t in range(4096)])
    sr_bias = (samples.mean(0) - x).abs()
    rn_bias = (x.to(torch.bfloat16).float() - x).abs()
    assert bool(torch.all(sr_bias < 0.2 * torch.clamp_min(rn_bias, 1e-7))), (sr_bias, rn_bias)


@pytest.mark.parametrize(
    "name,per_step_bound", [("fp32", 1e-12), ("bf16", 6e-3), ("fp8", 6e-2), ("fp8_ec", 5e-4)])
def test_codec_roundtrip_error_within_the_jax_bounds(name, per_step_bound):
    """The bounds of the JAX package's 50-step contraction test, on the
    port's own draws: worst per-step error under the format's floor, drift
    under ten times it."""
    r = tstate.codec_roundtrip_error(name, steps=50)
    assert r["worst_step"] < per_step_bound, r
    assert r["drift"] < max(10 * per_step_bound, 1e-12), r


@pytest.mark.parametrize("name,tol", [("bf16", 2e-2), ("fp8", 8e-2), ("fp8_ec", 2e-2)])
def test_lossy_reduce_stays_close_to_fp32(name, tol):
    """The error bound of the JAX package's 5-step codec test on the port's
    reduce: the quantized residue within ``tol`` (relative) of the fp32 one."""
    n, size = 4, 2048
    params = {"w": torch.zeros(size)}
    cfg = dict(compressor=CompressorConfig("clt_k", chunk=8), beta=0.2, min_size=1,
               backend="torch")
    sq = tstate.init_state(params, n, name, min_size=1)
    s32 = tstate.init_state(params, n, min_size=1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        g = {"w": torch.randn(n, size, generator=gen)}
        _, sq, _ = tsc.scalecom_reduce(g, sq, tsc.ScaleComConfig(residue_dtype=name, **cfg))
        _, s32, _ = tsc.scalecom_reduce(g, s32, tsc.ScaleComConfig(**cfg))
    mq = tstate.CODECS[name].decode(sq.residues["['w']"], (size,))
    m32 = s32.residues["['w']"]["q"]
    assert float(torch.linalg.norm(mq - m32) / torch.linalg.norm(m32)) < tol


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("name", CODECS)
def test_signature_and_bytes_match_jax(name, layout):
    shapes = [(1000,), (1024,), (7, 40), (2, 5, 1030), (37000, 512)]
    for shape in shapes:
        storage = tstate.storage_shape(shape, layout)
        assert tstate.codec_signature(name, 8, storage) == jstate.codec_signature(
            name, 8, storage), (shape, layout)
    jparams = {f"p{i}": jax.ShapeDtypeStruct(s, jnp.float32) for i, s in enumerate(shapes)}
    tparams = {f"p{i}": torch.empty(s, device="meta") for i, s in enumerate(shapes)}
    assert tstate.residue_bytes(tparams, 8, name, 1024, layout) == jstate.residue_bytes(
        jparams, 8, name, 1024, layout)
    # init_state allocates what residue_bytes counts
    small = {k: v for k, v in tparams.items() if math.prod(v.shape) < 1 << 20}
    st = tstate.init_state({k: torch.zeros(v.shape) for k, v in small.items()}, 8, name,
                           1024, layout)
    held = sum(t.numel() * t.element_size() for enc in st.residues.values() for t in enc.values())
    assert held == tstate.residue_bytes(small, 8, name, 1024, layout)


def _jax_state(name, layout, n, seed):
    """A JAX state with random residues of every size, encoded by ``name``."""
    rng = np.random.default_rng(seed)
    params = {"a": jnp.zeros((6, 40)), "big": jnp.zeros((1100,)), "c": jnp.zeros((3, 7, 64))}
    js = jstate.init_state(params, n, name, MIN_SIZE, layout)
    residues = {}
    for path, leaf in zip(sorted(params), ("a", "big", "c")):
        shape = tuple(params[leaf].shape)
        storage = jstate.storage_shape(shape, layout)
        m = jnp.asarray(_residue(rng, (n,) + storage))
        residues[f"['{leaf}']"] = jstate.CODECS[name].encode(m, storage)
    assert residues.keys() == js.residues.keys()
    return jstate.ScaleComState(residues=residues, t=jnp.int32(T))


def _decoded(codec, residues):
    """path -> decoded fp32 numpy, against the encoded trailing shape."""
    return {p: np.asarray(codec.decode(enc, tuple(enc["q"].shape[1:])))
            if not isinstance(enc["q"], torch.Tensor)
            else codec.decode(enc, tuple(enc["q"].shape[1:])).numpy()
            for p, enc in residues.items()}


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("name", CODECS)
def test_state_from_jax_round_trips_bit_for_bit(name, layout):
    js = _jax_state(name, layout, N, 1)
    ts = state_from_jax(js, "cpu")
    assert ts.t == T
    got = residue_bits(ts)
    for path, enc in js.residues.items():
        for k, leaf in enc.items():
            assert ts.residues[path][k].shape == leaf.shape
            assert np.array_equal(got[path][k], _bits(leaf)), (path, k)
    assert tstate.residue_signature(ts.residues) == jstate.residue_signature(js.residues)


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("name", CODECS)
def test_remap_matches_jax(name, layout):
    for old_n, new_n in ((4, 6), (8, 7), (8, 4)):
        js = _jax_state(name, layout, old_n, old_n * 10 + new_n)
        jr = jstate.remap_state(js, old_n, new_n, name)
        tr = tstate.remap_state(state_from_jax(js, "cpu"), old_n, new_n, name)
        assert tr.t == T
        assert tstate.residue_signature(tr.residues) == jstate.residue_signature(jr.residues)
        want = _decoded(jstate.CODECS[name], jr.residues)
        got = _decoded(tstate.CODECS[name], tr.residues)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {old_n}->{new_n} {path}")


def test_remap_fp32_round_trip_is_bitwise_and_keeps_the_mean():
    """8 -> 4 -> 8: the expand repeats each of the 4 rows bit for bit, and
    folding back gives the 4-worker state bit for bit; 8 -> 6 (through lcm
    24) keeps the worker mean."""
    ts = state_from_jax(_jax_state("fp32", "flat", 8, 3), "cpu")
    four = tstate.remap_state(ts, 8, 4)
    eight = tstate.remap_state(four, 4, 8)
    back = tstate.remap_state(eight, 8, 4)
    for path, enc in four.residues.items():
        q8 = eight.residues[path]["q"]
        assert np.array_equal(_tbits(q8[0::2]), _tbits(enc["q"])), path
        assert np.array_equal(_tbits(q8[1::2]), _tbits(enc["q"])), path
        assert np.array_equal(_tbits(back.residues[path]["q"]), _tbits(enc["q"])), path
    six = tstate.remap_state(ts, 8, 6)
    for path, enc in ts.residues.items():
        assert six.residues[path]["q"].shape[0] == 6
        torch.testing.assert_close(six.residues[path]["q"].mean(0), enc["q"].mean(0),
                                   rtol=1e-5, atol=1e-6)


def test_remap_rejects_bad_counts_and_worker_axes():
    ts = state_from_jax(_jax_state("bf16", "flat", 4, 0), "cpu")
    for old_n, new_n in ((0, 4), (4, 0), (-1, 2)):
        with pytest.raises(ValueError, match="positive"):
            tstate.remap_state(ts, old_n, new_n, "bf16")
    with pytest.raises(ValueError, match="worker axis 4"):
        tstate.remap_state(ts, 8, 4, "bf16")


def test_state_drift_names_the_codec_and_the_worker_count():
    grads = {"a": torch.zeros(N, 6, 40), "big": torch.zeros(N, 1100), "c": torch.zeros(N, 3, 7, 64)}
    cfg = tsc.ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), min_size=MIN_SIZE,
                             layout="flat", residue_dtype="fp8")
    bf16 = state_from_jax(_jax_state("bf16", "flat", N, 0), "cpu")
    with pytest.raises(ValueError, match="encoded by the 'bf16' codec"):
        tsc.scalecom_reduce(grads, bf16, cfg)
    fp8_of_8 = state_from_jax(_jax_state("fp8", "flat", 8, 0), "cpu")
    with pytest.raises(ValueError, match=r"remap_state\(state, 8, 4\)"):
        tsc.scalecom_reduce(grads, fp8_of_8, cfg)


def _grads(rng):
    def make(shape):
        return rng.standard_normal((N,) + shape).astype(np.float32)

    return {"a": make((6, 40)), "b": {"w": make((3, 64)), "z": make((2, 5, 24))},
            "big": make((1100,)), "small": make((10,))}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}['{k}']") if isinstance(v, dict) else {f"{prefix}['{k}']": v})
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("fused,backend", [(False, "torch"), (True, "torch"), (True, "cuda")])
@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("name", CODECS)
def test_teacher_forced_reduce_matches_jax(name, layout, fused, backend, jax_dither):
    """5 steps, each from JAX's state: residues bitwise (stochastic rounding
    with JAX's bits), ĝ's nonzero pattern (the indices) equal and its values
    to rtol 1e-6 / atol 1e-7. The "cuda" backend runs its kernels' plain
    versions on these CPU tensors."""
    rng = np.random.default_rng(abs(hash((name, layout, fused))) % 2**32)
    params = _map(lambda g: jnp.zeros(g.shape[1:]), _grads(rng))
    js = jstate.init_state(params, N, name, MIN_SIZE, layout)
    comp = dict(beta=0.1, min_size=MIN_SIZE, layout=layout, residue_dtype=name, fused=fused)
    jcfg = jsc.ScaleComConfig(compressor=JComp("clt_k", chunk=CHUNK), backend="jnp", **comp)
    tcfg = tsc.ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK),
                              backend=backend, **comp)
    for step in range(5):
        grads = _grads(rng)
        jg, jnew, _ = jsc.scalecom_reduce(_map(jnp.asarray, grads), js, jcfg, buckets=False)
        tg, tnew, _ = tsc.scalecom_reduce(_map(torch.from_numpy, grads), state_from_jax(js, "cpu"),
                                          tcfg, buckets=False)
        jflat, tflat = _flat(jg), _flat(tg)
        for path in jflat:
            want, got = np.asarray(jflat[path]), tflat[path].numpy()
            assert np.array_equal(want != 0, got != 0), (step, path)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{step} {path}")
        got_bits = residue_bits(tnew)
        for path, enc in jnew.residues.items():
            for k, leaf in enc.items():
                assert np.array_equal(got_bits[path][k], _bits(leaf)), (step, path, k)
        assert tnew.t == int(jnew.t)
        js = jnew
