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

The wrapper launches on CUDA tensors (counting ``fused_reduce.launches`` and
``fused_reduce.variants``) and runs the plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chunk_topk import VEC4_MAX_TOPM, chunk_scatter_plain, chunk_topm_plain
from repro_torch.kernels.ef_update import ef_update_plain

__all__ = ["MODES", "fused_variant", "fused_reduce", "fused_reduce_plain"]

# Selection modes of the fused kernel, by the integer the kernel takes
MODES = ("clt_k", "true_topk")


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
    mode: str = "clt_k", leader: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select, Eq. 5 update and ghat scatter over contiguous fp32 ``(G, rows, chunk)`` m and g.

    Returns ``(idx, vals, m', ghat)``: idx int32 ``(rows,)`` for topm == 1,
    else ``(rows, topm)``; vals ``(G,) + idx.shape``; m' like m; ghat
    ``(rows, chunk)``. ``leader`` (0 <= leader < G) is required for clt_k and
    ignored for true_topk.
    """
    name = "fused_reduce"
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
        lib = build.library()
        fn = lib.scalecom_fused_reduce_vec4 if variant == "vec4" else lib.scalecom_fused_reduce
        rc = fn(m.data_ptr(), g.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                m_new.data_ptr(), ghat.data_ptr(), rows, G, chunk, topm,
                MODES.index(mode), int(leader), float(beta), build.stream_of(m))
        build.check(rc, name)
        fused_reduce.launches += 1
        fused_reduce.variants[variant] += 1
    return idx, vals, m_new, ghat


fused_reduce.launches = 0
fused_reduce.variants = {"vec4": 0, "scalar": 0}  # launches by variant
