"""CUDA kernel backend: the reduce's inner loop as three hand-written kernels.

Per compressed tensor and step the unfused reduce makes three launches:

  select     chunk_argmax over the worker-stacked EF (topm == 1)
  ef_update  the fused Eq. 5 residue update, one read of (m, g, idx) and
             one write of (m', vals)
  scatter    chunk_scatter of the worker-mean values into ghat

This module is the layout layer around them (the counterpart of
``repro.kernels.rowwise`` and ``repro.backends.pallas_backend``): it pads the
trailing axis to a chunk multiple, views every batched tensor as
``(rows, chunk)``, broadcasts index sets over leading dims and slices dense
outputs back. It is plain Python the CPU tests reach; on CPU tensors the
kernel wrappers run their plain versions.

Not ported yet, and refused rather than run some other way: top-m select
(``_topm_kernel``) and gather (``_gather_kernel``), ROADMAP Queue 2 rows 5-6.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.backends.base import KernelBackend, register_backend
from repro_torch.core.chunked import num_chunks, pad_to_chunks
from repro_torch.kernels import chunk_topk
from repro_torch.kernels import ef_update as ef_kernel

__all__ = ["CudaBackend"]


def _tail(topm: int):
    return () if topm == 1 else (topm,)


def _rows(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(..., Cp) with Cp % chunk == 0 -> contiguous (rows, chunk)."""
    return x.reshape(-1, chunk).contiguous()


class CudaBackend(KernelBackend):
    name = "cuda"

    def select(self, x, chunk, topm=1):
        if topm != 1:
            raise NotImplementedError(
                "cuda backend: top-m select (topm > 1) needs the _topm_kernel "
                "port (ROADMAP Queue 2 row 5); use backend='torch' for topm > 1"
            )
        xp = pad_to_chunks(x, chunk)
        out_shape = x.shape[:-1] + (xp.shape[-1] // chunk,)
        idx, val = chunk_topk.chunk_argmax(_rows(xp, chunk))
        return idx.reshape(out_shape), val.reshape(out_shape)

    def select_indices(self, x, chunk, topm=1):
        return self.select(x, chunk, topm)[0]

    def gather(self, x, idx, chunk, topm=1):
        raise NotImplementedError(
            "cuda backend: gather needs the _gather_kernel port (ROADMAP Queue 2 row 6)"
        )

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
        ncr = mp.shape[-1] // chunk
        tail = _tail(topm)
        nt = len(tail) + 1
        m_lead, idx_lead = tuple(m.shape[:-1]), tuple(idx.shape[:-nt])
        # the kernel reads index row r % idx_rows: idx's leading dims must be
        # a trailing run of m's (a shared set broadcast over the worker axis)
        if (idx.shape[-nt:] != (ncr,) + tail
                or idx_lead != m_lead[len(m_lead) - len(idx_lead):]):
            raise ValueError(
                f"cuda ef_update: idx {tuple(idx.shape)} does not broadcast "
                f"over m {tuple(m.shape)} as trailing per-chunk offsets"
            )
        m_new, vals = ef_kernel.ef_update(
            _rows(mp, chunk), _rows(gp, chunk),
            idx.reshape((-1,) + tail).contiguous(), beta,
        )
        return m_new.reshape(mp.shape)[..., :n], vals.reshape(m_lead + (ncr,) + tail)


@functools.lru_cache(maxsize=1)
def _instance() -> CudaBackend:
    return CudaBackend()


register_backend("cuda", _instance)
