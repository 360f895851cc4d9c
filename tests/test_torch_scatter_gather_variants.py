"""repro_torch's chunk scatter and gather at the edges of their kernels, on the CPU.

``chunk_scatter`` has two hand-written kernels: "vec4" (whole rows as 16-byte
stores, several rows' offsets and values loaded before any store) and
"scalar" (one warp per row, 4-byte stores). ``scatter_variant`` picks one
from the chunk width and top-m alone. ``chunk_gather`` has one kernel, which
loads each offset once and reads it for every worker that shares the set.
These tests pin the scatter's choice, check that CPU tensors take
the plain versions and count no launch, and hold the plain versions, which
the kernels must reproduce bit for bit on the card (``chip_smoke.py``),
against the Pallas ``_scatter_kernel`` and ``_gather_kernel`` in interpret
mode at the kernels' edges: chunk 4, 8, 17, 64 and 128, top-m 1, 2, 8 and 9,
one row and a row count that fills no warp, duplicate offsets within a row,
per-worker index sets and shared ones over 3 and 8 copies (tiled to every
row for the JAX side), offsets outside the chunk (from -2^31 to 2^31 - 1:
the Pallas gather counts one in [-chunk, 0) from the row's end and gives
NaN for the rest), with -0, +-inf and NaNs of both signs and many payloads.

Tolerance: none. Outputs are compared bit for bit: a gather and a top-1
scatter copy, and a top-m scatter adds in the same order on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_topk as jtopk
from repro_torch import kernels
from repro_torch.kernels import chunk_topk as ct

LIMIT = ct.VEC4_MAX_TOPM


@pytest.mark.parametrize(
    "chunk,topm,want",
    [
        (64, 1, "vec4"),  # the main path
        (64, 2, "vec4"),  # a top-2 rate rule
        (64, LIMIT, "vec4"),  # the register lists' limit
        (64, LIMIT + 1, "scalar"),  # above it
        (4, 1, "vec4"),  # one 16-byte store per row
        (8, LIMIT, "vec4"),
        (128, 2, "vec4"),
        (100, 1, "vec4"),  # rows of 25 float4
        (17, 1, "scalar"),  # no whole float4 per row
        (6, 2, "scalar"),
        (1, 1, "scalar"),
    ],
)
def test_scatter_variant_choice(chunk, topm, want):
    assert ct.scatter_variant(chunk, topm) == want


@pytest.mark.parametrize("topm", [1, 2, LIMIT + 1])
def test_cpu_tensors_take_the_plain_versions(topm):
    """CPU tensors run the plain versions and count no launch, whichever
    variant the shape would pick on the card."""
    rng = _rng(5, topm)
    vals = torch.from_numpy(_shaped(_specials(rng, 9, topm), topm))
    idx = torch.from_numpy(_shaped(_offsets(rng, 9, 64, topm), topm))
    x = torch.from_numpy(_specials(rng, 27, 64))
    kernels.reset_launches()
    out = ct.chunk_scatter(vals, idx, 64)
    got = ct.chunk_gather(x, idx)
    assert kernels.launches()["chunk_scatter"] == kernels.launches()["chunk_gather"] == 0
    assert ct.chunk_scatter.variants == {"vec4": 0, "scalar": 0}
    _assert_bitwise(out, ct.chunk_scatter_plain(vals, idx, 64))
    _assert_bitwise(got, ct.chunk_gather_plain(x, idx))


def _rng(*key):
    return np.random.default_rng(list(key))


def _specials(rng, rows, cols):
    """Few distinct magnitudes of both signs, with -0, +-inf, and NaNs of both
    signs with random payloads."""
    x = rng.integers(-3, 4, size=(rows, cols)).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5] = -0.0
    flat[2::11] = np.inf
    flat[7::13] = -np.inf
    bits = flat.view(np.uint32)
    pay = rng.integers(1, 1 << 22, size=bits[1::4].shape, dtype=np.uint32)
    sign = np.where(pay % 2 == 0, 0, 0x80000000).astype(np.uint32)
    bits[1::4] = np.uint32(0x7F800000) | pay | sign
    return x


def _offsets(rng, rows, chunk, topm):
    """(rows, topm) int32 offsets, distinct within a row but for a duplicate
    in every third row at top-m > 1."""
    idx = np.stack([rng.permutation(chunk)[:topm] for _ in range(rows)]).astype(np.int32)
    if topm > 1:
        idx[::3, -1] = idx[::3, 0]
    return idx


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(_bits(g), _bits(w))


def _shaped(a, topm):
    """(rows, topm) -> (rows,) at top-1, the layout the kernels take."""
    return np.ascontiguousarray(a[:, 0]) if topm == 1 else a


EDGES = [
    (rows, chunk, topm)
    for chunk in (4, 8, 17, 64, 128)
    for topm in sorted({1, 2, min(LIMIT, chunk), min(LIMIT + 1, chunk)})
    for rows in (1, 33)
]


@pytest.mark.parametrize("rows,chunk,topm", EDGES)
def test_plain_scatter_matches_pallas_at_kernel_edges(rows, chunk, topm):
    rng = _rng(rows, chunk, topm)
    vals = _shaped(_specials(rng, rows, topm), topm)
    idx = _shaped(_offsets(rng, rows, chunk, topm), topm)
    want = jtopk.row_scatter(jnp.asarray(vals), jnp.asarray(idx), chunk, interpret=True,
                             block_chunks=8)
    got = ct.chunk_scatter_plain(torch.from_numpy(vals), torch.from_numpy(idx), chunk)
    _assert_bitwise(got, want)


def _pallas_gather(x, idx, copies):
    """The Pallas gather in interpret mode, the index set tiled to every row
    (row r reads index row r % idx_rows)."""
    tiled = np.tile(idx, (copies,) + (1,) * (idx.ndim - 1))
    return jtopk.row_gather(jnp.asarray(x), jnp.asarray(tiled), interpret=True, block_chunks=8)


@pytest.mark.parametrize("rows,chunk,topm", EDGES)
def test_plain_gather_matches_pallas_at_kernel_edges(rows, chunk, topm):
    """A per-worker set (one copy) and shared sets over 3 and 8 copies, with
    offsets inside the chunk and then with some at -1 and at chunk."""
    for copies in (1, 3, 8):
        rng = _rng(rows, chunk, topm, copies)
        x = _specials(rng, rows * copies, chunk)
        idx = _offsets(rng, rows, chunk, topm)
        bad = idx.copy()
        bad[::2, 0], bad[1::2, -1] = -1, chunk
        for ids in (_shaped(idx, topm), _shaped(bad, topm)):
            got = ct.chunk_gather_plain(torch.from_numpy(x), torch.from_numpy(ids))
            _assert_bitwise(got, _pallas_gather(x, ids, copies))


@pytest.mark.parametrize("topm,copies", [(1, 1), (1, 8), (2, 1), (2, 3), (LIMIT, 1), (LIMIT + 1, 8)])
def test_plain_gather_matches_pallas_outside_the_chunk(topm, copies):
    """Offsets across and past [-chunk, chunk): the Pallas gather counts one
    in [-chunk, 0) from the row's end and gives NaN for the rest."""
    rows, chunk = 12, 16
    rng = _rng(9, topm, copies)
    x = _specials(rng, rows * copies, chunk)
    edge = np.array([-2**31, -chunk - 1, -chunk, -chunk + 1, -1, 0, chunk - 1, chunk, chunk + 1,
                     2**31 - 1], dtype=np.int32)
    idx = rng.choice(edge, size=(rows, topm)).astype(np.int32)
    idx[: len(edge), 0] = edge[:rows]
    ids = _shaped(idx, topm)
    got = ct.chunk_gather_plain(torch.from_numpy(x), torch.from_numpy(ids))
    _assert_bitwise(got, _pallas_gather(x, ids, copies))
