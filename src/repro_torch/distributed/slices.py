"""A model rank's slice of a logical tensor, and its residue in any codec.

The tensor-parallel step (``training.train_step``, ``build_train_step(
mesh=...)``) holds, on each rank of a model axis, a slice of every
parameter and of its worker's residue row. ``Slice`` names that slice: dim
``dim`` of the logical ``shape`` cut into ``parts`` equal runs, run
``index`` on this rank (``dim`` None: replicated, the whole tensor).

A residue slice is the stacked reduce's row (``core.state``) cut to the
slice, field by field, in the layout's storage:

  flat     q (and fp8_ec's c) hold the slice's elements in its own flat
           order, (1, prod(local shape)), unpadded. fp8's scales are one per
           512 elements of the LOGICAL padded flat view, whose blocks the
           slices share: ``scale`` is the whole (1, padded / 512) vector on
           every model rank (1/512 of the tensor).
  rowwise  q and c are the slice, (1, *local shape); ``scale`` is one per
           row, (1, *local shape[:-1]): where the last dim is split the rows
           cross the slices and every model rank holds the same scales.
           A 1-D tensor is stored flat in both layouts, as ``core.state``
           stores it.

``decode`` gives the slice's fp32 residue; ``encode`` codes an fp32 slice
so that each code is the one the stacked reduce gives at the same logical
position: the scale of a block or row that crosses slices is ``torch.amax``
over every model rank's partial amax (one all-gather of them, a round of
``encode_steps``), so that a NaN anywhere in the block gives the stacked
codec's scale of 1 (a MAX all-reduce over gloo drops a NaN from any rank
but the first), and the stochastic rounding takes the dither at the slice's
logical positions of the draw over the whole stack (``row_dither``).
``cut`` and ``join`` move a logical row's encoding to a slice and back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import state as state_codecs
from repro_torch.core.state import FP8_BLOCK, bf16_encode, fp8_blocks, fp8_quantize, fp8_scale
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.ring import Collective, drive

__all__ = ["Slice", "codec_name", "init", "signature", "decode", "encode", "encode_steps",
           "row_dither", "cut", "join", "infer_layout"]

Shape = Tuple[int, ...]
Enc = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Slice:
    """Run ``index`` of ``parts`` equal runs of dim ``dim`` of the logical
    ``shape`` (``dim`` None: the whole tensor)."""

    shape: Shape
    dim: Optional[int]
    parts: int
    index: int

    @property
    def width(self) -> int:
        return self.shape[self.dim] // self.parts

    @property
    def local_shape(self) -> Shape:
        if self.dim is None:
            return tuple(self.shape)
        return self.shape[:self.dim] + (self.width,) + self.shape[self.dim + 1:]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def cut(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """This slice of ``x``, whose dims after the first ``lead`` are the
        logical shape (a view)."""
        if self.dim is None:
            return x
        return x.narrow(lead + self.dim, self.index * self.width, self.width)

    def flat_ids(self, device) -> torch.Tensor:
        """The logical flat offset of each of the slice's elements, in the
        slice's own flat order (int64)."""
        if self.dim is None:
            return torch.arange(self.size, device=device)
        outer = math.prod(self.shape[:self.dim])
        inner = math.prod(self.shape[self.dim + 1:])
        span = self.shape[self.dim] * inner
        cols = torch.arange(self.width, device=device) + self.index * self.width
        ids = (torch.arange(outer, device=device)[:, None, None] * span
               + cols[None, :, None] * inner + torch.arange(inner, device=device)[None, None, :])
        return ids.reshape(-1)

    def crosses(self, layout: str) -> bool:
        """Whether fp8's scale blocks (flat) or rows (rowwise) cross the
        slices, so that a scale needs every model rank's elements."""
        if self.dim is None or self.parts == 1:
            return False
        return layout == "flat" or self.dim == len(self.shape) - 1


def infer_layout(enc: Enc, shape: Shape) -> str:
    """The layout of a (rows, *storage) encoding, stacked or a slice's, of a
    tensor of logical ``shape``: rowwise keeps the parameter's dims, flat
    one axis (a 1-D tensor's storage is the same in both: flat)."""
    return "rowwise" if len(shape) > 1 and enc["q"].dim() - 1 == len(shape) else "flat"


def _storage_layout(sl: Slice, layout: str) -> str:
    """The layout a tensor's storage takes: a 1-D tensor's is flat in both
    (one axis, and fp8's scales per 512 elements, as ``core.state``'s codecs
    store it)."""
    return layout if len(sl.shape) > 1 else "flat"


def codec_name(enc: Enc) -> str:
    """The codec an encoding's fields and dtypes name."""
    fields = frozenset(enc)
    if fields == {"q"}:
        return "fp32" if enc["q"].dtype == torch.float32 else "bf16"
    return "fp8_ec" if "c" in fields else "fp8"


def _storage(sl: Slice, layout: str) -> Shape:
    if layout == "flat":
        return (math.prod(sl.local_shape),)
    return sl.local_shape if sl.local_shape else (1,)


def init(name: str, sl: Slice, layout: str, device) -> Enc:
    """Zero residue slice, every field of ``name``'s codec."""
    layout = _storage_layout(sl, layout)
    store = _storage(sl, layout)
    def zeros(shape, dtype):
        return torch.zeros((1,) + tuple(shape), dtype=dtype, device=device)

    if name == "fp32":
        return {"q": zeros(store, torch.float32)}
    if name == "bf16":
        return {"q": zeros(store, torch.bfloat16)}
    scale = (fp8_blocks(sl.size),) if layout == "flat" else store[:-1]
    enc = {"q": zeros(store, torch.float8_e4m3fn), "scale": zeros(scale, torch.float32)}
    if name == "fp8_ec":
        enc["c"] = zeros(store, torch.bfloat16)
    return enc


def signature(name: str, sl: Slice, layout: str) -> Tuple:
    """(field, shape, dtype) of each field ``init`` gives, sorted."""
    return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in init(name, sl, layout,
                                                                        "meta").items()))


def _blocks(sl: Slice, device) -> torch.Tensor:
    return sl.flat_ids(device).div_(FP8_BLOCK, rounding_mode="floor")  # in place: one int64 copy


def _whole_blocks(sl: Slice, device) -> Optional[torch.Tensor]:
    """Where the slice's flat order is whole fp8 blocks in runs that start
    at a block boundary (each index of the dims before the split one gives
    one run), the logical block of each of the slice's blocks, in order
    (one int64 per 512 elements: the slice's elements then view as
    (1, blocks, 512)); else None, and each element needs its own block id
    (``_blocks``)."""
    if sl.dim is None:
        return torch.arange(sl.size // FP8_BLOCK, device=device) if sl.size % FP8_BLOCK == 0 \
            else None
    outer = math.prod(sl.shape[:sl.dim])
    inner = math.prod(sl.shape[sl.dim + 1:])
    run, span = sl.width * inner, sl.shape[sl.dim] * inner
    if run % FP8_BLOCK or span % FP8_BLOCK:
        return None
    per = run // FP8_BLOCK
    return (torch.arange(outer, device=device)[:, None] * (span // FP8_BLOCK) + sl.index * per
            + torch.arange(per, device=device)[None, :]).reshape(-1)


def decode(name: str, enc: Enc, sl: Slice, layout: str) -> torch.Tensor:
    """The slice's fp32 residue, (1, *storage), as the stacked codec's decode
    gives it at the same positions."""
    layout = _storage_layout(sl, layout)
    q = enc["q"]
    if name in ("fp32", "bf16"):
        return q.to(torch.float32)
    if layout == "flat":
        ids = _whole_blocks(sl, q.device)
        if ids is not None:
            x = (q.to(torch.float32).view(1, -1, FP8_BLOCK) * enc["scale"][:, ids, None]).view(
                q.shape)
        else:
            x = q.to(torch.float32) * enc["scale"][:, _blocks(sl, q.device)]
    else:
        x = q.to(torch.float32) * enc["scale"][..., None]
    if name == "fp8_ec":
        x = x + enc["c"].to(torch.float32)
    return x


def encode(name: str, m: torch.Tensor, sl: Slice, layout: str, dither=None,
           model=None) -> Enc:
    """Code the fp32 slice ``m`` (1, *storage): ``dither`` the slice's
    stochastic-rounding bits (``row_dither``; None rounds to nearest),
    ``model`` the model group, over which a scale that crosses the slices
    takes its maximum (``encode_steps`` with blocking calls)."""
    return drive(encode_steps(name, m, sl, layout, dither, model))


def encode_steps(name: str, m: torch.Tensor, sl: Slice, layout: str, dither=None, model=None):
    """``encode`` as a round generator (``ring.Flight``): where a block or
    row crosses the slices, one round that all-gathers every model rank's
    partial amax (counted as the model axis's, ``tensor_parallel.sent``),
    whose ``torch.amax`` keeps a NaN as the stacked codec's does (the flat
    layout's partial amax, a ``scatter_reduce`` "amax", keeps one on the CPU
    and on the card). Returns the encoding."""
    layout = _storage_layout(sl, layout)
    if name == "fp32":
        return {"q": m}
    if name == "bf16":
        return {"q": bf16_encode(m, dither)}
    flat = layout == "flat"
    ids = _whole_blocks(sl, m.device) if flat else None
    if ids is not None:  # whole blocks: each block's amax from a (1, blocks, 512) view
        x = m.reshape(1, -1, FP8_BLOCK)
        amax = torch.zeros((1, fp8_blocks(sl.size)), dtype=torch.float32,
                           device=m.device).index_copy_(1, ids, torch.amax(x.abs(), dim=-1))
    elif flat:
        x, blocks = m, _blocks(sl, m.device)
        amax = torch.zeros((1, fp8_blocks(sl.size)), dtype=torch.float32,
                           device=m.device).scatter_reduce(1, blocks[None], m.abs(), "amax")
    else:
        x, amax = m, torch.amax(m.abs(), dim=-1)
    if sl.crosses(layout):
        (rows,) = yield [Collective("all_gather", amax, model, "model")]
        amax = torch.amax(rows, dim=0)
    scale = fp8_scale(amax)
    if ids is not None:
        per = scale[:, ids, None]
    else:
        per = scale[:, blocks] if flat else scale[..., None]
        blocks = None  # one int64 an element: freed before the quantize's temporaries
    q = fp8_quantize(x, per)
    enc = {"q": q.view(m.shape), "scale": scale}
    if name == "fp8_ec":
        enc["c"] = bf16_encode((x - q.to(torch.float32) * per).view(m.shape), dither)
    return enc


def row_dither(name: str, key, rows: int, row: int, sl: Slice, layout: str,
               device) -> Optional[torch.Tensor]:
    """The dither the stacked reduce draws for ``key`` (``core.state.
    codec_key``) over all ``rows`` residue rows, at row ``row`` and the
    slice's logical positions, or None for a codec that rounds to nearest.
    Each rank draws the whole stack: the draw is not addressable by
    position."""
    layout = _storage_layout(sl, layout)
    whole = state_codecs.row_dither(name, key, rows, row,
                                    state_codecs.storage_shape(sl.shape, layout), device)
    if whole is None:
        return None
    if layout == "flat":
        return whole[:, sl.flat_ids(device)]
    return sl.cut(whole, lead=1).contiguous()


def cut(name: str, enc: Enc, sl: Slice, layout: str) -> Enc:
    """A logical row's encoding (1, *storage) -> the slice's (copies)."""
    layout = _storage_layout(sl, layout)
    out = {}
    for field, v in enc.items():
        if field == "scale":
            out[field] = (sl.cut(v, lead=1) if layout == "rowwise" and not sl.crosses(layout)
                          else v)
        elif layout == "flat":
            out[field] = v[:, sl.flat_ids(v.device)]
        else:
            out[field] = sl.cut(v, lead=1)
        out[field] = out[field].clone(memory_format=torch.contiguous_format)
    return out


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def join(name: str, enc: Enc, sl: Slice, layout: str, model=None) -> Enc:
    """The slices' encodings -> the logical row's (1, *storage), the
    stacked codec's fields and shapes (flat fp8 padded with zero codes);
    collective over the model group ``model`` where the tensor is split."""
    layout = _storage_layout(sl, layout)
    store = state_codecs.storage_shape(sl.shape, layout)
    want = state_codecs.require_codec(name).init(1, store, "meta")
    out = {}
    for field, v in enc.items():
        whole = field == "scale" and (layout == "flat" or sl.crosses(layout))
        if whole or (sl.dim is None and layout == "rowwise"):
            out[field] = v
            continue
        bits = v.view(_BITS[v.element_size()])
        wide = bits.to(torch.int32)  # gloo gathers no 8- or 16-bit integers
        if layout == "rowwise":
            got = tensor_parallel.all_gather(wide, sl.dim + 1, model)
        else:  # each rank's elements at their logical offsets
            got = torch.zeros(want[field].shape, dtype=torch.int32, device=v.device)
            rows = wide[None] if sl.dim is None else tensor_parallel.all_gather(wide, 0, model)[
                :, None]
            for j in range(rows.shape[0]):
                got[:, Slice(sl.shape, sl.dim, sl.parts, j).flat_ids(v.device)] = rows[j]
        out[field] = got.to(bits.dtype).view(v.dtype)
    return out
