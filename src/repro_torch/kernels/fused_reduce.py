"""The single-launch fused reduce: CUDA kernels, wrapper and plain version.

``fused_reduce`` replaces src/repro/kernels/fused_reduce.py:_fused_kernel.
Over the worker-stacked residue ``m`` and gradient ``g``, both viewed as
``(G, rows, chunk)`` with the trailing axis padded to a chunk multiple, one
launch does the whole per-tensor inner loop of the reduce:

    select   clt_k:     top-m of |m + g| on the leader's row
             true_topk: top-m of |mean over workers of (m + g)|
    update   vals[w] = (m + g)[w] at idx;  m'[w] = m[w] + beta * (g[w] - own)
    scatter  ghat = the worker mean of vals at idx, zeros elsewhere

Worker means are summed in worker order and then divided by G, here and in
the kernels, so they agree bit for bit on the card; ``torch.mean`` sums in
another order, so against the torch backend's composition ghat (and, through
a near tie that flips a true_topk index, m' and vals) agree to rtol 1e-6 /
atol 1e-7. The leader is an integer (``t mod G``), ``beta`` a runtime float.
Bound: device-memory bytes (see ``csrc/fused_reduce.cu``).

The kernel has two hand-written variants, and ``fused_variant`` picks one
from the chunk width, the bases of m and g and top-m alone: "vec4" (a few
lanes per row, 16-byte loads and stores, the picks merged in registers, the
next worker's loads issued before this one's stores) wherever chunk % 4 == 0,
both bases are 16-byte aligned and top-m <= 8, as on the main path; "scalar"
(one warp per row, 4-byte loads, one pass per pick: the first design) for
any other width, base or top-m. Both are checked on the card.

The vec4 variant's clt_k route at top-1, the main path's, launches in
blocks of ``threads`` threads, one of ``build.CANDIDATE_THREADS``; left
None, the default 256. The caller picks the size (the CUDA backend reads it
from the launch cache, ``repro_torch.backends.autotune``, keyed by G x
rows). Every size gives the same bits. The other routes, top-m and the scalar variant keep their
fixed geometry.

The wrapper launches on CUDA tensors (counting ``fused_reduce.launches``,
``fused_reduce.variants``, for vec4 ``fused_reduce.routes`` as the library
reports the route it took, and for the tuned route ``fused_reduce.threads``
by block size) and runs the plain version on CPU tensors.

``fused_select_update`` is the variant for one rank of a process group
(``repro_torch.distributed.ring``), where a collective must sit between
the select and the scatter: over ONE row of residue ``m`` and gradient
``g`` (no worker axis), one launch does

    select   top-m of |m + g| (clt_k), or of |key| when a key is given
             (true_topk: the oracle's worker mean, from an all-reduce)
    update   vals[j] = (m + g)[idx[j]];  m' = m + beta * (g - own)

and stores idx, vals and m', no ĝ: the all-reduce of vals and
``chunk_scatter`` make ĝ. It is ``csrc/fused_select_update.cu``'s kernel,
the vec4 design of the fused reduce at one worker (16-byte loads, the picks
merged in registers, the row's m and g kept in registers between select and
update when a lane's share of it fits one batch, as at chunk 64); it needs
chunk % 4 == 0, 16-byte-aligned bases and top-m <= 8
(``select_update_fits``). At top-1 it takes ``threads`` as the fused clt_k
route does. Its outputs are bitwise ``select_indices`` followed by
``ef_update`` (the plain twin, ``fused_select_update_plain``). The wrapper
counts ``fused_select_update.launches``, ``.routes`` ("sum" or "key") and
``.threads``. Bound: device-memory bytes, m and g (and the key) read once,
m' written once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_topk import VEC4_MAX_TOPM, chunk_scatter_plain, chunk_topm_plain
from repro_torch.kernels.ef_update import ef_update_plain

__all__ = [
    "MODES", "ROUTES", "fused_variant", "fused_reduce", "fused_reduce_plain",
    "fused_select_update", "fused_select_update_plain", "select_update_fits",
]

# Selection modes of the fused kernel, by the integer the kernel takes
MODES = ("clt_k", "true_topk")
# Routes of a vec4 launch, by the integer the library reports: clt_k runs one
# grid; true_topk stages its rows in shared memory where they fit (G <= 12 at
# chunk <= 512), else reads them again from L2
ROUTES = ("one_grid", "staged", "l2_reread")


def fused_variant(chunk: int, m_ptr: int, g_ptr: int, topm: int = 1) -> str:
    """The fused kernel for ``(G, rows, chunk)`` fp32 m and g at addresses
    ``m_ptr`` and ``g_ptr``: "vec4" when chunk % 4 == 0, both bases are
    16-byte aligned and ``topm <= VEC4_MAX_TOPM``, else "scalar"."""
    if chunk % 4 == 0 and m_ptr % 16 == 0 and g_ptr % 16 == 0 and 1 <= topm <= VEC4_MAX_TOPM:
        return "vec4"
    return "scalar"


def _worker_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading axis, summed in order and then divided by G."""
    s = x[0]
    for w in range(1, x.shape[0]):
        s = s + x[w]
    # a tensor divisor (a Python scalar makes PyTorch multiply by 1/G on the
    # card), filled on the card: a copy from pageable host memory waits for it
    return s / torch.full((), float(x.shape[0]), device=x.device)


def fused_reduce_plain(
    m: torch.Tensor, g: torch.Tensor, beta: float, topm: int, mode: str,
    leader: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G, rows, chunk) m/g -> (idx, vals (G, rows[, topm]), m' (G, rows, chunk), ghat (rows, chunk))."""
    G, rows, chunk = m.shape
    if mode == "clt_k":
        key = m[leader] + g[leader]
    else:
        key = _worker_mean(torch.stack([m[w] + g[w] for w in range(G)]))
    idx = chunk_topm_plain(key, topm)[0]
    if topm == 1:
        idx = idx[:, 0]
    m_new, vals = zip(*(ef_update_plain(m[w], g[w], idx, beta) for w in range(G)))
    vals = torch.stack(vals)
    ghat = chunk_scatter_plain(_worker_mean(vals), idx, chunk)
    return idx, vals, torch.stack(m_new), ghat


def fused_reduce(
    m: torch.Tensor, g: torch.Tensor, beta: float, topm: int = 1,
    mode: str = "clt_k", leader: Optional[int] = None, threads=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select, Eq. 5 update and ghat scatter over contiguous fp32 ``(G, rows, chunk)`` m and g.

    Returns ``(idx, vals, m', ghat)``: idx int32 ``(rows,)`` for topm == 1,
    else ``(rows, topm)``; vals ``(G,) + idx.shape``; m' like m; ghat
    ``(rows, chunk)``. ``leader`` (0 <= leader < G) is required for clt_k and
    ignored for true_topk. ``threads``: the block size of the vec4 clt_k
    top-1 launch (None: the default).
    """
    name = "fused_reduce"
    build.threads_arg(threads, name)
    build.require(m.dim() == 3 and g.shape == m.shape and m.shape[0] > 0 and m.shape[2] > 0,
                  name, f"m/g must share a (G, rows, chunk) shape, got "
                  f"{tuple(m.shape)} / {tuple(g.shape)}")
    build.require(m.dtype == torch.float32 and g.dtype == torch.float32, name,
                  f"m/g must be float32, got {m.dtype} / {g.dtype}")
    build.require(m.is_contiguous() and g.is_contiguous(), name, "m/g must be contiguous")
    build.require(mode in MODES, name, f"mode must be one of {MODES}, got {mode!r}")
    G, rows, chunk = m.shape
    build.require(1 <= topm <= chunk, name, f"need 1 <= topm <= chunk, got {topm}, {chunk}")
    if mode == "clt_k":
        build.require(leader is not None and 0 <= leader < G, name,
                      f"clt_k needs a leader in [0, {G}), got {leader}")
    else:
        leader = 0
    if not build.on_card(name, m, g):
        return fused_reduce_plain(m, g, beta, topm, mode, leader)
    tail = () if topm == 1 else (topm,)
    idx = torch.empty((rows,) + tail, dtype=torch.int32, device=m.device)
    vals = torch.empty((G, rows) + tail, dtype=torch.float32, device=m.device)
    m_new = torch.empty_like(m)
    ghat = torch.empty((rows, chunk), dtype=torch.float32, device=m.device)
    if rows:
        variant = fused_variant(chunk, m.data_ptr(), g.data_ptr(), topm)
        tuned = variant == "vec4" and mode == "clt_k" and topm == 1
        build.require(tuned or threads is None, name,
                      "threads sets the block size of the vec4 clt_k top-1 launch only")
        lib = build.library()
        args = (m.data_ptr(), g.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                m_new.data_ptr(), ghat.data_ptr(), rows, G, chunk, topm,
                MODES.index(mode), int(leader), float(beta))
        if variant == "vec4":
            t = 0
            if tuned:
                t = threads or build.DEFAULT_THREADS
            route = ctypes.c_int32(-1)
            rc = lib.scalecom_fused_reduce_vec4(*args, t, build.stream_of(m),
                                                ctypes.byref(route))
        else:
            rc = lib.scalecom_fused_reduce(*args, build.stream_of(m))
        build.check(rc, name)
        fused_reduce.launches += 1
        fused_reduce.variants[variant] += 1
        if variant == "vec4":
            fused_reduce.routes[ROUTES[route.value]] += 1
        if tuned:
            fused_reduce.threads[t] += 1
    return idx, vals, m_new, ghat


fused_reduce.launches = 0
fused_reduce.variants = {"vec4": 0, "scalar": 0}  # launches by variant
fused_reduce.routes = dict.fromkeys(ROUTES, 0)  # vec4 launches by the route the library took
fused_reduce.threads = dict.fromkeys(build.CANDIDATE_THREADS, 0)  # clt_k top-1 vec4 launches by block size


def select_update_fits(chunk: int, topm: int) -> bool:
    """Whether ``fused_select_update``'s kernel takes this chunk and top-m
    (its bases 16-byte aligned): chunk % 4 == 0 and top-m <= 8."""
    return chunk % 4 == 0 and 1 <= topm <= VEC4_MAX_TOPM


def fused_select_update_plain(
    m: torch.Tensor, g: torch.Tensor, beta: float, chunk: int, topm: int = 1,
    key: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., size) m/g [key], size % chunk == 0 -> (idx (rows[, topm]),
    vals (rows[, topm]), m' like m), rows = m.numel() / chunk: the select
    on |m + g| (or |key|), then the Eq. 5 update at its offsets."""
    m2, g2 = m.reshape(-1, chunk), g.reshape(-1, chunk)
    idx = chunk_topm_plain(m2 + g2 if key is None else key.reshape(-1, chunk), topm)[0]
    if topm == 1:
        idx = idx[:, 0]
    m_new, vals = ef_update_plain(m2, g2, idx, beta)
    return idx, vals, m_new.reshape(m.shape)


def fused_select_update(
    m: torch.Tensor, g: torch.Tensor, beta: float, chunk: int, topm: int = 1,
    key: Optional[torch.Tensor] = None, threads=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row's select and Eq. 5 update in one launch, over contiguous fp32
    m, g (and ``key``) of one shape whose last axis is a multiple of
    ``chunk``. Returns ``(idx, vals, m')``: idx int32 ``(rows,)`` for
    topm == 1, else ``(rows, topm)``; vals like idx, float32; m' like m.
    ``threads``: the block size of a top-1 launch (None: the default)."""
    name = "fused_select_update"
    build.threads_arg(threads, name)
    tensors = (m, g) if key is None else (m, g, key)
    build.require(m.dim() >= 1 and all(x.shape == m.shape for x in tensors), name,
                  f"m/g/key must share one shape, got {[tuple(x.shape) for x in tensors]}")
    build.require(all(x.dtype == torch.float32 for x in tensors), name,
                  f"m/g/key must be float32, got {[x.dtype for x in tensors]}")
    build.require(all(x.is_contiguous() for x in tensors), name, "m/g/key must be contiguous")
    build.require(chunk > 0 and m.shape[-1] % chunk == 0, name,
                  f"the last axis {m.shape[-1]} must be a multiple of chunk {chunk}")
    build.require(1 <= topm <= chunk, name, f"need 1 <= topm <= chunk, got {topm}, {chunk}")
    if not build.on_card(name, *tensors):
        return fused_select_update_plain(m, g, beta, chunk, topm, key)
    build.require(select_update_fits(chunk, topm), name,
                  f"the kernel takes chunk % 4 == 0 and top-m <= {VEC4_MAX_TOPM}, got chunk "
                  f"{chunk}, top-{topm}")
    build.require(all(x.data_ptr() % 16 == 0 for x in tensors), name,
                  "m/g/key must start 16-byte aligned")
    build.require(threads is None or topm == 1, name, "threads sets the block size of a top-1 "
                                                      "launch only")
    rows = m.numel() // chunk
    tail = () if topm == 1 else (topm,)
    idx = torch.empty((rows,) + tail, dtype=torch.int32, device=m.device)
    vals = torch.empty((rows,) + tail, dtype=torch.float32, device=m.device)
    m_new = torch.empty_like(m)
    if rows:
        t = (threads or build.DEFAULT_THREADS) if topm == 1 else 0
        rc = build.library().scalecom_fused_select_update(
            m.data_ptr(), g.data_ptr(), None if key is None else key.data_ptr(), idx.data_ptr(),
            vals.data_ptr(), m_new.data_ptr(), rows, chunk, topm, float(beta), t,
            build.stream_of(m))
        build.check(rc, name)
        fused_select_update.launches += 1
        fused_select_update.routes["sum" if key is None else "key"] += 1
        if t:
            fused_select_update.threads[t] += 1
    return idx, vals, m_new


fused_select_update.launches = 0
fused_select_update.routes = {"sum": 0, "key": 0}  # launches by select key: m + g, or given
fused_select_update.threads = dict.fromkeys(build.CANDIDATE_THREADS, 0)  # top-1 launches by size
