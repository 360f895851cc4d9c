"""The fused Eq. 5 residue update: CUDA kernel, wrapper and plain version.

``ef_update`` replaces src/repro/kernels/ef_update.py:_ef_update_kernel. Per
chunk row ``r`` of the worker-stacked residue ``m`` and gradient ``g``:

    ef      = m + g
    vals[j] = ef[idx[j]]                                  (top-m, j < topm)
    m'      = m + beta * (g - onehot(ef at idx))          (paper Eq. 5)

with one read of (m, g, idx) and one write of (m', vals). Row ``r`` reads
index row ``r % idx_rows``: a shared ``(R,)`` index set serves all G stacked
workers (``rows = G * R``) without being broadcast in memory, and per-worker
(local_topk) indices pass ``idx_rows == rows``. ``beta`` is a runtime float.
The kernel rounds each operation separately, so on the card m' is bitwise
equal to the plain version below. Bound: device-memory bytes (see
``csrc/scalecom_kernels.cu``).

The wrapper launches on CUDA tensors (counting ``ef_update.launches``) and
runs the plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

__all__ = ["ef_update", "ef_update_plain"]


def ef_update_plain(
    m: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, beta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, chunk) m/g, idx (idx_rows[, topm]) -> (m' (rows, chunk), vals (rows[, topm]))."""
    rows, chunk = m.shape
    i = idx[:, None] if idx.dim() == 1 else idx
    i = i.repeat(rows // i.shape[0], 1)  # row r reads index row r % idx_rows
    ef = m + g
    lanes = torch.arange(chunk, dtype=torch.int32, device=m.device)
    own = torch.where(lanes == i[:, :1], ef, 0.0)
    for j in range(1, i.shape[1]):
        own = own + torch.where(lanes == i[:, j : j + 1], ef, 0.0)
    vals = torch.gather(ef, 1, i.long())
    m_new = m + beta * (g - own)
    return m_new, (vals[:, 0] if idx.dim() == 1 else vals)


def ef_update(
    m: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, beta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Eq. 5 over contiguous fp32 ``(rows, chunk)`` m and g."""
    name = "ef_update"
    build.require(m.dim() == 2 and g.shape == m.shape, name,
                  f"m/g must share a (rows, chunk) shape, got {tuple(m.shape)} / {tuple(g.shape)}")
    build.require(m.dtype == torch.float32 and g.dtype == torch.float32, name,
                  f"m/g must be float32, got {m.dtype} / {g.dtype}")
    build.require(idx.dtype == torch.int32, name, f"idx must be int32, got {idx.dtype}")
    build.require(idx.dim() in (1, 2), name, f"idx must be (idx_rows,) or (idx_rows, topm), got {tuple(idx.shape)}")
    build.require(m.is_contiguous() and g.is_contiguous() and idx.is_contiguous(), name,
                  "m/g/idx must be contiguous")
    rows, chunk = m.shape
    idx_rows = idx.shape[0]
    topm = 1 if idx.dim() == 1 else idx.shape[1]
    build.require(idx_rows > 0 and rows % idx_rows == 0, name,
                  f"rows {rows} must be a multiple of idx_rows {idx_rows}")
    build.require(1 <= topm <= chunk, name, f"need 1 <= topm <= chunk, got {topm}, {chunk}")
    if not build.on_card(name, m, g, idx):
        return ef_update_plain(m, g, idx, beta)
    m_new = torch.empty_like(m)
    vals = torch.empty((rows,) if idx.dim() == 1 else (rows, topm),
                       dtype=torch.float32, device=m.device)
    if rows:
        rc = build.library().scalecom_ef_update(
            m.data_ptr(), g.data_ptr(), idx.data_ptr(), m_new.data_ptr(),
            vals.data_ptr(), rows, idx_rows, chunk, topm, float(beta),
            build.stream_of(m),
        )
        build.check(rc, name)
        ef_update.launches += 1
    return m_new, vals


ef_update.launches = 0
