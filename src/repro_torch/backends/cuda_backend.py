"""CUDA kernel backend: the reduce's chunked ops as hand-written kernels.

Per compressed tensor and step the unfused reduce makes three launches:

  select     chunk_argmax (topm == 1) or chunk_topm (topm > 1) over the
             worker-stacked EF
  ef_update  the fused Eq. 5 residue update, one read of (m, g, idx) and
             one write of (m', vals)
  scatter    chunk_scatter of the worker-mean values into ghat

and the fused reduce (``fused_reduce``, clt_k and true_topk) makes one.
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
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

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


class CudaBackend(KernelBackend):
    name = "cuda"

    def select(self, x, chunk, topm=1):
        xp = pad_to_chunks(x, chunk)
        out_shape = x.shape[:-1] + (xp.shape[-1] // chunk,) + _tail(topm)
        if topm == 1:
            idx, val = chunk_topk.chunk_argmax(_rows(xp, chunk))
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
        m_new, vals = ef_kernel.ef_update(
            _rows(mp, chunk), _rows(gp, chunk), _index_rows(idx, lead, ncr, tail), beta,
        )
        return m_new.reshape(mp.shape)[..., :n], vals.reshape(lead + (ncr,) + tail)

    def fused_reduce(self, m, g, beta, chunk, topm=1, mode="clt_k", leader=None):
        # one launch for select, Eq. 5 update and ghat scatter, as
        # repro.backends.pallas_backend.fused_reduce
        n = m.shape[-1]
        mp, gp = pad_to_chunks(m, chunk), pad_to_chunks(g, chunk)
        G, lead = m.shape[0], tuple(m.shape[1:-1])
        ncr, tail = mp.shape[-1] // chunk, _tail(topm)
        idx, vals, m_new, ghat = fr_kernel.fused_reduce(
            mp.reshape(G, -1, chunk).contiguous(), gp.reshape(G, -1, chunk).contiguous(),
            beta, topm, mode, leader,
        )
        return (
            idx.reshape(lead + (ncr,) + tail),
            vals.reshape((G,) + lead + (ncr,) + tail),
            m_new.reshape(mp.shape)[..., :n],
            ghat.reshape(lead + (ncr * chunk,))[..., :n],
        )


@functools.lru_cache(maxsize=1)
def _instance() -> CudaBackend:
    return CudaBackend()


register_backend("cuda", _instance)
