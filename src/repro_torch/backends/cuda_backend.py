"""CUDA kernel backend: the reduce's chunked ops as hand-written kernels.

Per compressed tensor and step the unfused reduce makes three launches:

  select     chunk_argmax (topm == 1) or chunk_topm (topm > 1) over the
             worker-stacked EF
  ef_update  the fused Eq. 5 residue update, one read of (m, g, idx) and
             one write of (m', vals)
  scatter    chunk_scatter of the worker-mean values into ghat

and the fused reduce (``fused_reduce``, clt_k and true_topk) makes one. A
process group's leader selects and updates in one ``fused_select_update``
launch where its kernel takes the chunk and top-m (``select_update_fits``),
else in the select and ``ef_update``.
``gather`` (``compress`` and the default ``select``) is chunk_gather.

This module is the layout layer around them (the counterpart of
``repro.kernels.rowwise`` and ``repro.backends.pallas_backend``): it pads the
trailing axis to a chunk multiple, views every batched tensor as
``(rows, chunk)`` (``(G, rows, chunk)`` for the fused reduce), lays out index
sets and slices dense outputs back. A shared index set whose leading dims
are a trailing run of the data's (the leader's set against worker-stacked
data) is passed as it is, and the kernels read index row ``r % idx_rows``;
any other broadcast is materialized. It is plain Python the CPU tests reach;
on CPU tensors the kernel wrappers run their plain versions.

It also picks the block size of the three launches the autotuner tunes (the
vec4 select at top-1, ef_update, the vec4 fused reduce's clt_k route at
top-1): the launch cache's size for the launch's rows
(``autotune.best_threads``, the default 256 on a miss), as the reference's
``PallasBackend._block`` picks a tile height. The kernels know nothing of
the cache.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.backends import autotune
from repro_torch.backends.base import KernelBackend, register_backend
from repro_torch.core.chunked import num_chunks, pad_to_chunks
from repro_torch.kernels import chunk_topk
from repro_torch.kernels import ef_update as ef_kernel
from repro_torch.kernels import fused_reduce as fr_kernel

__all__ = ["CudaBackend"]


def _tail(topm: int):
    return () if topm == 1 else (topm,)


def _rows(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(..., Cp) with Cp % chunk == 0 -> contiguous (rows, chunk)."""
    return x.reshape(-1, chunk).contiguous()


def _index_rows(idx: torch.Tensor, lead: Tuple[int, ...], ncr: int, tail) -> torch.Tensor:
    """Per-chunk offsets over data with leading dims ``lead`` -> contiguous
    (idx_rows[, topm]) rows, row r of the data reading index row r % idx_rows."""
    nt = len(tail) + 1
    if tuple(idx.shape[-nt:]) != (ncr,) + tuple(tail):
        raise ValueError(
            f"cuda backend: idx {tuple(idx.shape)} does not end in the "
            f"per-chunk shape {(ncr,) + tuple(tail)}"
        )
    idx_lead = tuple(idx.shape[:-nt])
    if len(idx_lead) > len(lead) or idx_lead != lead[len(lead) - len(idx_lead):]:
        idx = idx.expand(lead + (ncr,) + tuple(tail))  # not a trailing run: broadcast
    return idx.reshape((-1,) + tuple(tail)).contiguous()


def _threads(op: str, x: torch.Tensor, rows: int, chunk: int, tuned: bool = True):
    """The launch cache's block size for a tuned launch of ``op`` over
    ``rows`` chunk rows on the card, else None (the wrapper's fixed geometry,
    or its plain version on the CPU)."""
    return autotune.best_threads(op, rows, chunk, x.device) if tuned and x.is_cuda else None


class CudaBackend(KernelBackend):
    name = "cuda"

    def select(self, x, chunk, topm=1):
        xp = pad_to_chunks(x, chunk)
        out_shape = x.shape[:-1] + (xp.shape[-1] // chunk,) + _tail(topm)
        if topm == 1:
            rows = _rows(xp, chunk)
            vec4 = chunk_topk.select_variant(chunk, rows.data_ptr()) == "vec4"
            idx, val = chunk_topk.chunk_argmax(
                rows, threads=_threads("select", rows, rows.shape[0], chunk, vec4))
        else:
            idx, val = chunk_topk.chunk_topm(_rows(xp, chunk), topm)
        return idx.reshape(out_shape), val.reshape(out_shape)

    def select_indices(self, x, chunk, topm=1):
        return self.select(x, chunk, topm)[0]

    def gather(self, x, idx, chunk, topm=1):
        xp = pad_to_chunks(x, chunk)
        ncr, tail = xp.shape[-1] // chunk, _tail(topm)
        lead = tuple(x.shape[:-1])
        vals = chunk_topk.chunk_gather(_rows(xp, chunk), _index_rows(idx, lead, ncr, tail))
        return vals.reshape(lead + (ncr,) + tail)

    def scatter(self, vals, idx, chunk, size, topm=1):
        ncr = num_chunks(size, chunk)
        tail = _tail(topm)
        nt = len(tail) + 1
        lead = torch.broadcast_shapes(idx.shape[:-nt], vals.shape[:-nt])
        full = lead + (ncr,) + tail
        i2 = idx.expand(full).reshape((-1,) + tail).contiguous()
        v2 = vals.expand(full).reshape((-1,) + tail).contiguous()
        out = chunk_topk.chunk_scatter(v2, i2, chunk)
        return out.reshape(lead + (ncr * chunk,))[..., :size]

    def ef_update(self, m, g, idx, beta, chunk, topm=1):
        n = m.shape[-1]
        mp, gp = pad_to_chunks(m, chunk), pad_to_chunks(g, chunk)
        ncr, tail = mp.shape[-1] // chunk, _tail(topm)
        lead = tuple(m.shape[:-1])
        m2 = _rows(mp, chunk)
        m_new, vals = ef_kernel.ef_update(
            m2, _rows(gp, chunk), _index_rows(idx, lead, ncr, tail), beta,
            threads=_threads("ef_update", m2, m2.shape[0], chunk),
        )
        return m_new.reshape(mp.shape)[..., :n], vals.reshape(lead + (ncr,) + tail)

    def fused_reduce(self, m, g, beta, chunk, topm=1, mode="clt_k", leader=None):
        # one launch for select, Eq. 5 update and ghat scatter, as
        # repro.backends.pallas_backend.fused_reduce
        n = m.shape[-1]
        mp, gp = pad_to_chunks(m, chunk), pad_to_chunks(g, chunk)
        G, lead = m.shape[0], tuple(m.shape[1:-1])
        ncr, tail = mp.shape[-1] // chunk, _tail(topm)
        m3, g3 = mp.reshape(G, -1, chunk).contiguous(), gp.reshape(G, -1, chunk).contiguous()
        tuned = (mode == "clt_k" and topm == 1
                 and fr_kernel.fused_variant(chunk, m3.data_ptr(), g3.data_ptr(), topm) == "vec4")
        idx, vals, m_new, ghat = fr_kernel.fused_reduce(
            m3, g3, beta, topm, mode, leader,
            threads=_threads("fused_reduce", m3, G * m3.shape[1], chunk, tuned),
        )
        return (
            idx.reshape(lead + (ncr,) + tail),
            vals.reshape((G,) + lead + (ncr,) + tail),
            m_new.reshape(mp.shape)[..., :n],
            ghat.reshape(lead + (ncr * chunk,))[..., :n],
        )

    def fused_select_update(self, m, g, beta, chunk, topm=1, key=None):
        if not fr_kernel.select_update_fits(chunk, topm):
            return super().fused_select_update(m, g, beta, chunk, topm, key)
        n = m.shape[-1]
        mp = pad_to_chunks(m, chunk)
        lead, ncr, tail = tuple(m.shape[:-1]), mp.shape[-1] // chunk, _tail(topm)
        m2, g2 = _aligned(_rows(mp, chunk)), _aligned(_rows(pad_to_chunks(g, chunk), chunk))
        k2 = None if key is None else _aligned(_rows(pad_to_chunks(key, chunk), chunk))
        idx, vals, m_new = fr_kernel.fused_select_update(
            m2, g2, beta, chunk, topm, k2,
            threads=_threads("fused_reduce", m2, m2.shape[0], chunk, topm == 1))
        return (idx.reshape(lead + (ncr,) + tail), vals.reshape(lead + (ncr,) + tail),
                m_new.reshape(mp.shape)[..., :n])


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its base is not 16-byte aligned (a view
    into another tensor), for a kernel of 16-byte loads."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=1)
def _instance() -> CudaBackend:
    return CudaBackend()


register_backend("cuda", _instance)
