"""The two variants of repro_torch's chunk selects, on the CPU.

``chunk_argmax`` and ``chunk_topm`` each have two hand-written kernels:
"vec4" (16-byte loads, several lanes per row, top-m kept in registers) and
"scalar" (one warp per row, 4-byte loads, one pass per pick).
``select_variant`` picks one from the chunk width, the base address and
top-m alone. These tests pin that choice, and hold the plain versions, which
both kernels must reproduce bit for bit on the card (``chip_smoke.py``),
against the Pallas ``_argmax_kernel`` and ``_topm_kernel`` in interpret mode
at the variants' edges: chunk 4, 8, 64 and 128, top-m at the register-list
limit and one above it, one row and a row count that fills no warp, with
ties, -0, +inf and NaNs of both signs and many payloads.

Tolerance: none. Indices and values are compared bit for bit (a select only
copies; NaN payloads and the sign of zero included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_topk as jtopk
from repro_torch.kernels import chunk_topk as ct

LIMIT = ct.VEC4_MAX_TOPM


@pytest.mark.parametrize(
    "chunk,offset,topm,want",
    [
        (64, 0, 1, "vec4"),  # the main path: chunk 64, a fresh tensor
        (64, 0, 2, "vec4"),  # a top-2 rate rule
        (64, 0, LIMIT, "vec4"),  # the register lists' limit
        (64, 0, LIMIT + 1, "scalar"),  # above it: the pass design
        (64, 4, 1, "scalar"),  # a base 4 bytes past 16-byte alignment
        (64, 8, 2, "scalar"),
        (64, 16, 1, "vec4"),  # a storage offset of 4 floats keeps the alignment
        (4, 0, 1, "vec4"),
        (8, 0, LIMIT, "vec4"),
        (128, 0, 2, "vec4"),
        (17, 0, 1, "scalar"),  # rows start at every 4-byte offset
        (100, 0, 1, "vec4"),
        (6, 0, 1, "scalar"),
        (1, 0, 1, "scalar"),
    ],
)
def test_variant_choice(chunk, offset, topm, want):
    base = 0x7F0000000000 + offset
    assert ct.select_variant(chunk, base, topm) == want


def test_variant_choice_follows_the_tensor_address():
    flat = torch.zeros(64 * 10 + 8)
    assert flat.data_ptr() % 16 == 0
    for start, want in ((0, "vec4"), (1, "scalar"), (2, "scalar"), (3, "scalar"), (4, "vec4")):
        x = flat[start:start + 640].view(10, 64)
        assert x.is_contiguous()
        assert ct.select_variant(64, x.data_ptr()) == want, start
        assert ct.select_variant(64, x.data_ptr(), LIMIT + 1) == "scalar"


def test_cpu_tensors_take_the_plain_version_whatever_the_variant():
    """A misaligned CPU view runs the plain version and counts no launch."""
    from repro_torch import kernels

    flat = torch.from_numpy(_tied_nan(_rng(3), 5, 64)).reshape(-1)
    x = torch.cat([torch.zeros(1), flat])[1:].view(5, 64)
    kernels.reset_launches()
    got_a = ct.chunk_argmax(x)
    got_m = ct.chunk_topm(x, 2)
    assert kernels.launches()["chunk_argmax"] == kernels.launches()["chunk_topm"] == 0
    assert ct.chunk_argmax.variants == ct.chunk_topm.variants == {"vec4": 0, "scalar": 0}
    _assert_bitwise(got_a, ct.chunk_argmax_plain(x))
    _assert_bitwise(got_m, ct.chunk_topm_plain(x, 2))


def _rng(*key):
    return np.random.default_rng(list(key))


def _tied_nan(rng, rows, chunk):
    """Few distinct magnitudes of both signs (many ties per row), with -0,
    +inf, and NaNs of both signs with random payloads."""
    x = rng.integers(-3, 4, size=(rows, chunk)).astype(np.float32)
    x[::3, ::5] = -0.0
    x[::11, 2::6] = np.inf
    x[::7, ::3] = np.nan
    bits = x.view(np.uint32)
    pay = rng.integers(1, 1 << 22, size=bits[1::4, ::2].shape, dtype=np.uint32)
    sign = np.where(pay % 2 == 0, 0, 0x80000000).astype(np.uint32)
    bits[1::4, ::2] = np.uint32(0x7F800000) | pay | sign
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        g, w = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (g, w))
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


EDGES = [
    (rows, chunk, topm)
    for chunk in (4, 8, 64, 128)
    for topm in sorted({1, 2, min(LIMIT, chunk), min(LIMIT + 1, chunk)})
    for rows in (1, 37)
]


@pytest.mark.parametrize("rows,chunk,topm", EDGES)
def test_plain_selects_match_pallas_at_variant_edges(rows, chunk, topm):
    x = _tied_nan(_rng(rows, chunk, topm), rows, chunk)
    pi, pv = jtopk.row_select(jnp.asarray(x), topm=topm, interpret=True, block_chunks=8)
    if topm == 1:
        got = ct.chunk_argmax_plain(torch.from_numpy(x))
        _assert_bitwise(got, (pi, pv))
        # chunk_topm at top-1 is the same function, shaped (rows, 1)
        ti, tv = ct.chunk_topm_plain(torch.from_numpy(x), 1)
        _assert_bitwise((ti[:, 0], tv[:, 0]), (pi, pv))
    else:
        _assert_bitwise(ct.chunk_topm_plain(torch.from_numpy(x), topm), (pi, pv))
