"""``kernels.fused_reduce.fused_select_update``, the fused reduce's one-row
variant (a process group leader's select and Eq. 5 update in one launch),
on the CPU, where its wrapper runs the plain twin.

- The wrapper against the JAX package's unfused path from the same inputs
  (the "jnp" backend's ``select_indices`` on m + g, or on the given key,
  then its ``ef_update``, run eagerly): offsets, values and m' bit for bit,
  at top-1, 2 and 8, on rows full of ties, -0 (in m) and +-inf.
- The "cuda" backend's op against the base class's composition
  (``select_indices`` then ``ef_update``): a trailing axis off the chunk
  (padded), a chunk the kernel does not take (17: composed), leading dims.
- The wrapper's refusals; no launch counted on CPU tensors.

The kernel itself runs on the card only: ``chip_smoke.py`` holds it bitwise
against the plain twin there (``[kernel] fused_select_update`` lines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import resolve_backend as jresolve
from repro_torch.backends import resolve_backend
from repro_torch.backends.base import KernelBackend
from repro_torch.kernels import fused_reduce as frk
from repro_torch.kernels import launches, reset_launches

BETA = 0.3


def _rows(rng, rows: int, chunk: int, neg_zero: bool = True) -> np.ndarray:
    """(rows, chunk) float32 full of ties, with +-inf and (``neg_zero``) -0."""
    x = rng.integers(-3, 4, (rows, chunk)).astype(np.float32)
    if neg_zero:
        x[::3, ::5] = -0.0
    x[::11, 2::6] = np.inf
    x[::13, ::4] = -np.inf
    return x


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({4: np.uint32, 2: np.uint16}[x.dtype.itemsize])


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("topm", [1, 2, 8])
@pytest.mark.parametrize("rows,chunk", [(1, 8), (33, 16), (257, 64)])
def test_matches_jax_unfused_path(rows, chunk, topm, keyed):
    rng = np.random.default_rng(rows * 100 + chunk + topm)
    # -0 in m alone: JAX's gather turns a selected ef of -0 into +0 and the
    # port's ef_update keeps its sign (in vals and, through it, m'), on every
    # path alike
    m, g = _rows(rng, rows, chunk), 0.5 * _rows(rng, rows, chunk, neg_zero=False)
    key = rng.standard_normal((rows, chunk)).astype(np.float32) if keyed else None
    reset_launches()
    idx, vals, m_new = frk.fused_select_update(
        torch.from_numpy(m), torch.from_numpy(g), BETA, chunk, topm,
        None if key is None else torch.from_numpy(key))
    assert launches()["fused_select_update"] == 0
    # the JAX path on the flat row: per-chunk offsets along its one axis
    jb = jresolve("jnp")
    jm, jg = jnp.asarray(m.reshape(-1)), jnp.asarray(g.reshape(-1))
    jkey = jm + jg if key is None else jnp.asarray(key.reshape(-1))
    jidx = jb.select_indices(jkey, chunk, topm)
    jm_new, jvals = jb.ef_update(jm, jg, jidx, BETA, chunk, topm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(jvals))
    np.testing.assert_array_equal(_bits(m_new.numpy()).reshape(-1), _bits(jm_new))
    tail = () if topm == 1 else (topm,)
    assert idx.shape == vals.shape == (rows,) + tail and idx.dtype == torch.int32


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("shape,chunk,topm", [((1000,), 64, 1), ((3, 130), 16, 2),
                                              ((2, 5, 40), 8, 1), ((300,), 17, 2)])
def test_cuda_backend_op_is_the_composition(shape, chunk, topm, keyed):
    """Padding to the chunk, leading dims, and a chunk the kernel does not
    take (17, composed of the select and ef_update): the base class's
    composition, bit for bit."""
    gen = torch.Generator().manual_seed(7)
    m, g = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    key = torch.randn(shape, generator=gen) if keyed else None
    got = resolve_backend("cuda").fused_select_update(m, g, BETA, chunk, topm, key)
    want = KernelBackend.fused_select_update(resolve_backend("torch"), m, g, BETA, chunk, topm,
                                             key)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert frk.select_update_fits(chunk, topm) == (chunk % 4 == 0)


def test_wrapper_refuses_what_it_does_not_take():
    m = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="share one shape"):
        frk.fused_select_update(m, torch.zeros(4, 32), BETA, 64)
    with pytest.raises(ValueError, match="float32"):
        frk.fused_select_update(m.double(), m.double(), BETA, 64)
    with pytest.raises(ValueError, match="contiguous"):
        frk.fused_select_update(m.t(), m.t(), BETA, 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        frk.fused_select_update(m, m, BETA, 48)
    with pytest.raises(ValueError, match="threads must be one of"):
        frk.fused_select_update(m, m, BETA, 64, threads=96)
    with pytest.raises(ValueError, match="1 <= topm <= chunk"):
        frk.fused_select_update(m, m, BETA, 8, topm=9)
