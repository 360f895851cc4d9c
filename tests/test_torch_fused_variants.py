"""repro_torch's fused reduce at the edges of its two kernels, on the CPU.

``fused_reduce`` has two hand-written kernels: "vec4" (a few lanes per row,
16-byte loads and stores, the picks merged in registers) and "scalar" (one
warp per row, 4-byte loads: the first design). ``fused_variant`` picks one
from the chunk width, the bases of m and g and top-m alone. These tests pin
that choice, check that CPU tensors take the plain version and count no
launch, and hold the plain version, which both kernels must reproduce bit
for bit on the card (``chip_smoke.py``), against the Pallas ``_fused_kernel``
(``fused_reduce_trailing``) in interpret mode at the kernels' edges: chunk
4, 8, 17, 64 and 128; top-m 1, 2, 8 and 9; 1, 3 and 8 workers; one row and
nine (at chunk 64 a warp of the vec4 kernel holds 8 rows); clt_k and
true_topk; ties, -0, +-inf and NaNs of both signs with many payloads. No
subnormals: XLA's CPU flushes them.

Tolerance: idx bitwise (integer-valued inputs keep every worker sum exact,
so the keys agree whatever the order). vals, m' and ĝ rtol 1e-6 / atol
1e-7, NaN equal to NaN: XLA may contract the Eq. 5 axpy into an FMA and sums
the worker mean in its own order.

Each Pallas call serves every row count of its configuration: rows are
independent, so the reduce of the first r rows is the first r rows of the
reduce. The workers cycle through 1, 3 and 8 over the configurations, so
every worker count meets both modes and every chunk width.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_reduce import fused_reduce_trailing
from repro_torch import kernels
from repro_torch.kernels import chunk_topk as ct
from repro_torch.kernels import fused_reduce as frk

LIMIT = ct.VEC4_MAX_TOPM
BETA = 0.1
ROWS = 9


@pytest.mark.parametrize(
    "chunk,topm,m_off,g_off,want",
    [
        (64, 1, 0, 0, "vec4"),  # the main path
        (64, 2, 0, 0, "vec4"),  # a top-2 rate rule
        (64, LIMIT, 0, 0, "vec4"),  # the register lists' limit
        (64, LIMIT + 1, 0, 0, "scalar"),  # above it
        (4, 1, 0, 0, "vec4"),  # one float4 per row
        (8, LIMIT, 0, 0, "vec4"),
        (128, 2, 0, 0, "vec4"),
        (17, 1, 0, 0, "scalar"),  # no whole float4 per row
        (6, 2, 0, 0, "scalar"),
        (64, 1, 4, 0, "scalar"),  # m 4 bytes past 16-byte alignment
        (64, 1, 0, 4, "scalar"),  # g alone misaligned
        (64, 2, 8, 12, "scalar"),
        (64, 1, 16, 48, "vec4"),  # both at other 16-byte boundaries
    ],
)
def test_fused_variant_choice(chunk, topm, m_off, g_off, want):
    assert frk.fused_variant(chunk, 4096 + m_off, 8192 + g_off, topm) == want


def _specials(rng, shape):
    """Small integers of both signs (ties), with -0, +-inf, and NaNs of both
    signs with random payloads; no subnormals."""
    x = rng.integers(-3, 4, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::5] = -0.0
    flat[2::11] = np.inf
    flat[7::13] = -np.inf
    bits = flat.view(np.uint32)
    pay = rng.integers(1, 1 << 22, size=bits[1::9].shape, dtype=np.uint32)
    sign = np.where(pay % 2 == 0, 0, 0x80000000).astype(np.uint32)
    bits[1::9] = np.uint32(0x7F800000) | pay | sign
    return x


def _inputs(G, rows, chunk, *key):
    rng = np.random.default_rng([G, rows, chunk, *key])
    return _specials(rng, (G, rows, chunk)), _specials(rng, (G, rows, chunk))


@pytest.mark.parametrize("base", ["aligned", "m misaligned", "g misaligned"])
@pytest.mark.parametrize("mode,topm", [("clt_k", 1), ("true_topk", 2), ("clt_k", LIMIT + 1)])
def test_cpu_tensors_take_the_plain_version(mode, topm, base):
    """CPU tensors run the plain version and count no launch, whichever
    variant their shape and bases would pick on the card."""
    m, g = (torch.from_numpy(a) for a in _inputs(3, ROWS, 64, 1))
    if base != "aligned":  # the same values from a base 4 bytes further on
        flat = torch.empty(m.numel() + 1)
        moved = flat[1:].view(m.shape)
        moved.copy_(m if base == "m misaligned" else g)
        m, g = (moved, g) if base == "m misaligned" else (m, moved)
        assert frk.fused_variant(64, m.data_ptr(), g.data_ptr(), topm) == "scalar"
    kernels.reset_launches()
    got = frk.fused_reduce(m, g, BETA, topm, mode, 2)
    assert kernels.launches()["fused_reduce"] == 0
    assert frk.fused_reduce.variants == {"vec4": 0, "scalar": 0}
    for a, b in zip(got, frk.fused_reduce_plain(m, g, BETA, topm, mode, 2)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


# every (chunk, top-m) edge, both modes; the workers cycle through 1, 3 and 8
CONFIGS = [
    (chunk, topm, mode)
    for chunk in (4, 8, 17, 64, 128)
    for topm in sorted({1, 2, min(LIMIT, chunk), min(LIMIT + 1, chunk)})
    for mode in ("clt_k", "true_topk")
]
CONFIGS = [(c, t, mode, (1, 3, 8)[i % 3]) for i, (c, t, mode) in enumerate(CONFIGS)]


@functools.lru_cache(maxsize=None)
def _pallas(chunk, topm, mode, G):
    """The inputs of a configuration and the Pallas kernel's result on all
    ROWS rows, in interpret mode."""
    m, g = _inputs(G, ROWS, chunk, topm, len(mode))
    leader = G - 1 if mode == "clt_k" else 0
    flat = lambda x: jnp.asarray(x.reshape(G, ROWS * chunk))  # noqa: E731
    out = fused_reduce_trailing(flat(m), flat(g), jnp.int32(leader), BETA, chunk, topm, mode,
                                interpret=True)
    return m, g, leader, tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("rows", [1, ROWS])
@pytest.mark.parametrize("chunk,topm,mode,G", CONFIGS)
def test_plain_fused_matches_pallas_at_kernel_edges(chunk, topm, mode, G, rows):
    m, g, leader, (idx, vals, m_new, ghat) = _pallas(chunk, topm, mode, G)
    got = frk.fused_reduce_plain(torch.from_numpy(m[:, :rows].copy()),
                                 torch.from_numpy(g[:, :rows].copy()), BETA, topm, mode, leader)
    got_idx, got_vals, got_m, got_ghat = (t.numpy() for t in got)
    np.testing.assert_array_equal(got_idx, idx[:rows])
    close = dict(rtol=1e-6, atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(got_vals, vals[:, :rows], **close, err_msg="vals")
    np.testing.assert_allclose(got_m.reshape(G, -1), m_new[:, :rows * chunk], **close,
                               err_msg="m'")
    np.testing.assert_allclose(got_ghat.reshape(-1), ghat[:rows * chunk], **close,
                               err_msg="ghat")
