"""repro_torch chunked ops and kernel wrappers against the JAX package.

On CPU tensors the kernel wrappers run their plain PyTorch versions, so these
tests pin the arithmetic the CUDA kernels must reproduce and the layout layer
around them (padding, row views, index broadcast) against the Pallas kernels
in interpret mode (``repro.kernels.rowwise``) and ``repro.core.chunked``.
The kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.

Tolerances: indices and selected values bitwise (a select only copies);
m' rtol 1e-6 / atol 1e-7, because XLA may contract the Eq. 5 axpy into an
FMA where PyTorch rounds each operation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunked as jchunked
from repro.kernels import rowwise
from repro_torch import kernels
from repro_torch.backends import resolve_backend
from repro_torch.core import chunked as tchunked
from repro_torch.kernels import chunk_topk, ef_update as ef_kernel
from repro_torch.kernels import fused_reduce as fr_kernel

SHAPES = [(64, 8), (100, 16), (4096, 64), (17, 4), (5, 8)]  # tests/test_chunked.py
G = 3
BETA = 0.1


def _rng(*key):
    return np.random.default_rng(list(key))


def _x(rng, shape, ties=False):
    if ties:  # few distinct magnitudes of both signs: many ties per chunk
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _idx(rng, lead, n_chunks, chunk, topm):
    """Distinct per-chunk offsets, (lead..., n_chunks[, topm]) int32."""
    perm = np.argsort(rng.random(tuple(lead) + (n_chunks, chunk)), axis=-1)
    idx = perm[..., :topm].astype(np.int32)
    return idx[..., 0] if topm == 1 else idx


def _jpad(x, chunk):
    return jchunked.pad_to_chunks(jnp.asarray(x), chunk)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("size,chunk", SHAPES)
def test_select_matches_pallas_and_jnp(size, chunk, ties):
    x = _x(_rng(size, chunk, ties), (G, size), ties)
    idx, val = resolve_backend("cuda").select(_t(x), chunk)
    pi, pv = rowwise.select_trailing(_jpad(x, chunk), chunk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(val.numpy(), np.asarray(pv))
    ji = jchunked.chunk_argmax(jnp.asarray(x), chunk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tchunked.chunk_argmax(_t(x), chunk).numpy(), np.asarray(ji))


@pytest.mark.parametrize("size,chunk,m", [(256, 16, 4), (100, 8, 2), (17, 4, 2), (64, 8, 8)])
def test_topm_ties_go_to_lower_offset_like_lax_top_k(size, chunk, m):
    x = _x(_rng(size, chunk, m), (G, size), ties=True)
    got = tchunked.chunk_topm_indices(_t(x), chunk, m)
    want = jchunked.chunk_topm_indices(jnp.asarray(x), chunk, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the torch backend's top-m select is the Pallas _topm_kernel's function
    pi, pv = rowwise.select_trailing(_jpad(x, chunk), chunk, topm=m)
    tb = resolve_backend("torch")
    ti, tv = tb.select(_t(x), chunk, m)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(pv))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("topm", [1, 2])
@pytest.mark.parametrize("size,chunk", SHAPES)
def test_ef_update_matches_pallas(size, chunk, topm, shared):
    rng = _rng(size, chunk, topm, shared)
    m, g = _x(rng, (G, size)), _x(rng, (G, size))
    ncr = tchunked.num_chunks(size, chunk)
    idx = _idx(rng, () if shared else (G,), ncr, chunk, topm)
    for name in ("cuda", "torch"):
        m_new, vals = resolve_backend(name).ef_update(_t(m), _t(g), _t(idx), BETA, chunk, topm)
        pm, pv = rowwise.ef_update_trailing(
            _jpad(m, chunk), _jpad(g, chunk), jnp.asarray(idx), BETA, chunk, topm
        )
        np.testing.assert_array_equal(vals.numpy(), np.asarray(pv), err_msg=name)
        np.testing.assert_allclose(m_new.numpy(), np.asarray(pm)[..., :size],
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("per_worker", [False, True])
@pytest.mark.parametrize("topm", [1, 2])
@pytest.mark.parametrize("size,chunk", SHAPES)
def test_scatter_matches_pallas_and_jnp(size, chunk, topm, per_worker):
    rng = _rng(size, chunk, topm, per_worker)
    ncr = tchunked.num_chunks(size, chunk)
    lead = (G,) if per_worker else ()
    idx = _idx(rng, lead, ncr, chunk, topm)
    vals = _x(rng, idx.shape)
    cp = ncr * chunk
    want = np.asarray(rowwise.scatter_trailing(jnp.asarray(vals), jnp.asarray(idx), chunk,
                                               cp, topm=topm))[..., :size]
    jn = jchunked.chunk_scatter(jnp.asarray(vals), jnp.asarray(idx), chunk, size, topm)
    np.testing.assert_array_equal(want, np.asarray(jn))
    for name in ("cuda", "torch"):
        got = resolve_backend(name).scatter(_t(vals), _t(idx), chunk, size, topm)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("size,chunk", SHAPES)
def test_gather_matches_jnp(size, chunk):
    rng = _rng(size, chunk, 7)
    x = _x(rng, (G, size))
    idx = _idx(rng, (), tchunked.num_chunks(size, chunk), chunk, 1)
    got = tchunked.chunk_gather(_t(x), _t(idx), chunk)
    want = jchunked.chunk_gather(jnp.asarray(x), jnp.asarray(idx), chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda: chunk_topk.chunk_argmax(torch.zeros(4, 8, dtype=torch.float64)), "float32"),
        (lambda: chunk_topk.chunk_argmax(torch.zeros(8, 4).T), "contiguous"),
        (lambda: chunk_topk.chunk_argmax(torch.zeros(8)), r"\(rows, chunk\)"),
        (lambda: chunk_topk.chunk_scatter(torch.zeros(4), torch.zeros(4, dtype=torch.int64), 8),
         "int32"),
        (lambda: chunk_topk.chunk_scatter(torch.zeros(4, 9), torch.zeros(4, 9, dtype=torch.int32),
                                          8), "topm"),
        (lambda: ef_kernel.ef_update(torch.zeros(6, 8), torch.zeros(6, 8),
                                     torch.zeros(4, dtype=torch.int32), 0.1), "multiple"),
        (lambda: ef_kernel.ef_update(torch.zeros(6, 8), torch.zeros(6, 4),
                                     torch.zeros(6, dtype=torch.int32), 0.1), "shape"),
        (lambda: chunk_topk.chunk_topm(torch.zeros(4, 8), 9), "topm"),
        (lambda: chunk_topk.chunk_topm(torch.zeros(4, 8, dtype=torch.float16), 2), "float32"),
        (lambda: chunk_topk.chunk_gather(torch.zeros(6, 8), torch.zeros(4, dtype=torch.int32)),
         "multiple"),
        (lambda: chunk_topk.chunk_gather(torch.zeros(6, 8), torch.zeros(6, dtype=torch.int64)),
         "int32"),
        (lambda: fr_kernel.fused_reduce(torch.zeros(2, 3, 8), torch.zeros(2, 3, 8), 0.1, 1,
                                        "local_topk"), "mode"),
        (lambda: fr_kernel.fused_reduce(torch.zeros(2, 3, 8), torch.zeros(2, 3, 8), 0.1, 1,
                                        "clt_k", 2), "leader"),
        (lambda: fr_kernel.fused_reduce(torch.zeros(3, 8), torch.zeros(3, 8), 0.1), r"\(G, rows"),
    ],
)
def test_wrappers_refuse_bad_inputs(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_cpu_run_launches_no_kernel():
    kernels.reset_launches()
    be = resolve_backend("cuda")
    x = torch.randn(G, 300)
    idx = be.select_indices(x, 64)
    be.ef_update(x, x, idx[0], BETA, 64)
    be.scatter(torch.randn(5), idx[0], 64, 300)
    be.select(x, 64, topm=2)
    be.gather(x, idx[0], 64)
    be.fused_reduce(x, x, BETA, 64, 1, "clt_k", 1)
    assert kernels.launches() == {
        "chunk_argmax": 0, "chunk_topm": 0, "chunk_gather": 0, "chunk_scatter": 0,
        "ef_update": 0, "fused_reduce": 0, "fused_select_update": 0,
    }
