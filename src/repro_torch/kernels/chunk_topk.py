"""Chunk-row select, gather and scatter: CUDA kernels, wrappers, plain versions.

Every kernel works on a ``(rows, chunk)`` view whose trailing axis is
already padded to a chunk multiple (``repro_torch.backends.cuda_backend``
pads, reshapes and lays out the index sets):

  chunk_argmax   replaces src/repro/kernels/chunk_topk.py:_argmax_kernel
                 (the topm == 1 body of ``row_select``): per row, the
                 arg-max of |x| as an int32 lane offset and the signed value
                 there; ties go to the lower lane.
  chunk_topm     replaces src/repro/kernels/chunk_topk.py:_topm_kernel (the
                 topm > 1 body of ``row_select``): per row, the top-m lanes
                 by |x| in descending order (ties to the lower lane, NaN
                 first, as ``jax.lax.top_k``) and the signed values there.
  chunk_gather   replaces src/repro/kernels/chunk_topk.py:_gather_kernel:
                 values at per-chunk offsets; row r reads index row
                 r % idx_rows, so a shared set serves all stacked workers;
                 as ``jnp.take_along_axis`` does there, an offset in
                 [-chunk, 0) counts from the row's end and one outside
                 [-chunk, chunk) gives NaN.
  chunk_scatter  replaces src/repro/kernels/chunk_topk.py:_scatter_kernel:
                 a dense ``(rows, chunk)`` tile holding ``vals`` at ``idx``
                 and zeros elsewhere; top-m entries are summed.

All are bound by device-memory bytes; the CUDA sources
(``csrc/scalecom_kernels.cu``, ``csrc/chunk_topm_gather.cu``,
``csrc/chunk_select.cuh``) state the bytes and the design.

The two selects each have two hand-written kernels, and ``select_variant``
picks one from the shape, the base address and top-m alone: "vec4" (16-byte
loads, several lanes per row, the picks kept in registers, one read of the
row) wherever every row starts 16-byte aligned and top-m <= 8, as on the
main path; "scalar" (one warp per row, 4-byte loads, one pass per pick) for
any other width, base or top-m. The scatter has two as well, and
``scatter_variant`` picks one from the chunk width and top-m alone (its
output is a fresh tensor, so always aligned): "vec4" (whole rows as 16-byte
stores, several rows' (idx, vals) loaded before any store) for chunk % 4 == 0
and top-m <= 8, as on the main path; "scalar" (one warp per row, 4-byte
stores) otherwise. All variants are checked on the card.

A wrapper given CUDA tensors launches the kernel, counts the launch in its
``launches`` attribute, and raises if the launch fails. Given CPU tensors it
runs the plain PyTorch version in this module; that is the CPU test path,
and ``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

__all__ = [
    "VEC4_MAX_TOPM",
    "select_variant",
    "scatter_variant",
    "chunk_argmax",
    "chunk_argmax_plain",
    "chunk_topm",
    "chunk_topm_plain",
    "chunk_gather",
    "chunk_gather_plain",
    "chunk_scatter",
    "chunk_scatter_plain",
]


def _check_rows(x: torch.Tensor, name: str) -> None:
    build.require(x.dim() == 2 and x.shape[1] > 0, name, f"x must be (rows, chunk), got {tuple(x.shape)}")
    build.require(x.dtype == torch.float32, name, f"x must be float32, got {x.dtype}")
    build.require(x.is_contiguous(), name, "x must be contiguous")


VEC4_MAX_TOPM = 8  # csrc/chunk_select.cuh:kVecMaxTopm, the register lists' length


def select_variant(chunk: int, data_ptr: int, topm: int = 1) -> str:
    """The select kernel for a contiguous fp32 ``(rows, chunk)`` tensor at
    address ``data_ptr``: "vec4" when chunk % 4 == 0, the base is 16-byte
    aligned and ``topm <= VEC4_MAX_TOPM``, else "scalar"."""
    if chunk % 4 == 0 and data_ptr % 16 == 0 and 1 <= topm <= VEC4_MAX_TOPM:
        return "vec4"
    return "scalar"


def scatter_variant(chunk: int, topm: int = 1) -> str:
    """The scatter kernel for ``(rows, topm)`` values into ``(rows, chunk)``
    rows: "vec4" when chunk % 4 == 0 and ``topm <= VEC4_MAX_TOPM``, else
    "scalar"."""
    return "vec4" if chunk % 4 == 0 and 1 <= topm <= VEC4_MAX_TOPM else "scalar"


def chunk_argmax_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, chunk) -> (idx (rows,) int32, val (rows,)); first maximum wins."""
    idx = torch.argmax(x.abs(), dim=-1)
    val = torch.gather(x, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), val


def chunk_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row magnitude arg-max of a contiguous fp32 ``(rows, chunk)`` tensor."""
    name = "chunk_argmax"
    _check_rows(x, name)
    if not build.on_card(name, x):
        return chunk_argmax_plain(x)
    rows, chunk = x.shape
    idx = torch.empty(rows, dtype=torch.int32, device=x.device)
    val = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        variant = select_variant(chunk, x.data_ptr())
        lib = build.library()
        fn = lib.scalecom_chunk_argmax_vec4 if variant == "vec4" else lib.scalecom_chunk_argmax
        rc = fn(x.data_ptr(), idx.data_ptr(), val.data_ptr(), rows, chunk, build.stream_of(x))
        build.check(rc, name)
        chunk_argmax.launches += 1
        chunk_argmax.variants[variant] += 1
    return idx, val


chunk_argmax.launches = 0
chunk_argmax.variants = {"vec4": 0, "scalar": 0}  # launches by variant


def chunk_topm_plain(x: torch.Tensor, topm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, chunk) -> (idx (rows, topm) int32, val (rows, topm)) by masked-argmax passes."""
    from repro_torch.core.chunked import chunk_topm_indices  # core imports the kernels

    idx = chunk_topm_indices(x, x.shape[1], topm)[:, 0]
    return idx, torch.gather(x, 1, idx.long())


def chunk_topm(x: torch.Tensor, topm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row magnitude top-m of a contiguous fp32 ``(rows, chunk)`` tensor."""
    name = "chunk_topm"
    _check_rows(x, name)
    rows, chunk = x.shape
    build.require(1 <= topm <= chunk, name, f"need 1 <= topm <= chunk, got {topm}, {chunk}")
    if not build.on_card(name, x):
        return chunk_topm_plain(x, topm)
    idx = torch.empty((rows, topm), dtype=torch.int32, device=x.device)
    val = torch.empty((rows, topm), dtype=torch.float32, device=x.device)
    if rows:
        variant = select_variant(chunk, x.data_ptr(), topm)
        lib = build.library()
        fn = lib.scalecom_chunk_topm_vec4 if variant == "vec4" else lib.scalecom_chunk_topm
        rc = fn(x.data_ptr(), idx.data_ptr(), val.data_ptr(), rows, chunk, topm,
                build.stream_of(x))
        build.check(rc, name)
        chunk_topm.launches += 1
        chunk_topm.variants[variant] += 1
    return idx, val


chunk_topm.launches = 0
chunk_topm.variants = {"vec4": 0, "scalar": 0}  # launches by variant


def _rows2d(t: torch.Tensor) -> torch.Tensor:
    """(rows,) -> (rows, 1); (rows, m) unchanged."""
    return t[:, None] if t.dim() == 1 else t


def chunk_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (rows, chunk), idx (idx_rows[, m]) -> x at index row r % idx_rows, shaped (rows[, m]);
    an offset in [-chunk, 0) counts from the row's end, one outside [-chunk, chunk) gives NaN."""
    chunk = x.shape[1]
    i = _rows2d(idx).long().repeat(x.shape[0] // idx.shape[0], 1)
    i = torch.where(i < 0, i + chunk, i)
    inside = (i >= 0) & (i < chunk)
    out = torch.where(inside, torch.gather(x, 1, torch.where(inside, i, 0)), float("nan"))
    return out[:, 0] if idx.dim() == 1 else out


def chunk_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Values of a contiguous fp32 ``(rows, chunk)`` tensor at per-row offsets.

    ``idx`` is int32 ``(idx_rows,)`` or ``(idx_rows, m)`` with ``rows`` a
    multiple of ``idx_rows``; row r reads index row ``r % idx_rows``.
    """
    name = "chunk_gather"
    _check_rows(x, name)
    build.require(idx.dtype == torch.int32, name, f"idx must be int32, got {idx.dtype}")
    build.require(idx.dim() in (1, 2), name, f"idx must be (idx_rows,) or (idx_rows, m), got {tuple(idx.shape)}")
    build.require(idx.is_contiguous(), name, "idx must be contiguous")
    rows, chunk = x.shape
    idx_rows = idx.shape[0]
    topm = 1 if idx.dim() == 1 else idx.shape[1]
    build.require(idx_rows > 0 and rows % idx_rows == 0, name,
                  f"rows {rows} must be a multiple of idx_rows {idx_rows}")
    build.require(1 <= topm <= chunk, name, f"need 1 <= m <= chunk, got {topm}, {chunk}")
    if not build.on_card(name, x, idx):
        return chunk_gather_plain(x, idx)
    out = torch.empty((rows,) if idx.dim() == 1 else (rows, topm),
                      dtype=torch.float32, device=x.device)
    if rows:
        rc = build.library().scalecom_chunk_gather(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, idx_rows, chunk,
            topm, build.stream_of(x),
        )
        build.check(rc, name)
        chunk_gather.launches += 1
    return out


chunk_gather.launches = 0


def chunk_scatter_plain(
    vals: torch.Tensor, idx: torch.Tensor, chunk: int
) -> torch.Tensor:
    """vals/idx (rows,) or (rows, m) -> dense (rows, chunk), top-m summed in order."""
    v, i = _rows2d(vals), _rows2d(idx)
    lanes = torch.arange(chunk, dtype=torch.int32, device=vals.device)
    out = torch.where(lanes == i[:, :1], v[:, :1], 0.0)
    for j in range(1, i.shape[1]):
        out = out + torch.where(lanes == i[:, j : j + 1], v[:, j : j + 1], 0.0)
    return out


def chunk_scatter(
    vals: torch.Tensor, idx: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Dense ``(rows, chunk)`` fp32 with ``vals`` at lane ``idx`` per row."""
    name = "chunk_scatter"
    build.require(vals.dim() in (1, 2) and idx.shape == vals.shape, name,
                  f"vals/idx must share a (rows,) or (rows, m) shape, got "
                  f"{tuple(vals.shape)} / {tuple(idx.shape)}")
    build.require(vals.dtype == torch.float32, name, f"vals must be float32, got {vals.dtype}")
    build.require(idx.dtype == torch.int32, name, f"idx must be int32, got {idx.dtype}")
    build.require(vals.is_contiguous() and idx.is_contiguous(), name, "vals/idx must be contiguous")
    topm = 1 if idx.dim() == 1 else idx.shape[1]
    build.require(1 <= topm <= chunk, name, f"need 1 <= topm <= chunk, got {topm}, {chunk}")
    if not build.on_card(name, vals, idx):
        return chunk_scatter_plain(vals, idx, chunk)
    rows = idx.shape[0]
    out = torch.empty((rows, chunk), dtype=torch.float32, device=vals.device)
    if rows:
        variant = scatter_variant(chunk, topm)
        lib = build.library()
        fn = lib.scalecom_chunk_scatter_vec4 if variant == "vec4" else lib.scalecom_chunk_scatter
        rc = fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, chunk, topm,
                build.stream_of(vals))
        build.check(rc, name)
        chunk_scatter.launches += 1
        chunk_scatter.variants[variant] += 1
    return out


chunk_scatter.launches = 0
chunk_scatter.variants = {"vec4": 0, "scalar": 0}  # launches by variant
