"""A rank's slice of a logical tensor, and its residue in any codec.

The tensor-parallel step (``training.train_step``, ``build_train_step(
mesh=...)``) holds, on each rank of a grid, a slice of every parameter and
of its worker's residue row. ``Slice`` names that slice: for each cut dim
of the logical ``shape``, the dim in equal runs and the rank's run of them
(no cut: replicated, the whole tensor). Under the ``tp`` specs a slice has
at most one cut, over "model"; under ``fsdp`` a second one, "embed" over
"data". ``Pieces`` names the process groups the slices lie over.

A residue slice is the stacked reduce's row (``core.state``) cut to the
slice, field by field, in the layout's storage:

  flat     q (and fp8_ec's c) hold the slice's elements in its own flat
           order, (1, prod(local shape)), unpadded. fp8's scales are one per
           512 elements of the LOGICAL padded flat view, whose blocks the
           slices share: ``scale`` is the whole (1, padded / 512) vector on
           every rank (1/512 of the tensor).
  rowwise  q and c are the slice, (1, *local shape); ``scale`` is one per
           row, (1, *local shape[:-1]): where the last dim is cut the rows
           cross the slices and the ranks along that cut's axis hold the
           same scales.
           A 1-D tensor is stored flat in both layouts, as ``core.state``
           stores it.

``decode`` gives the slice's fp32 residue; ``encode`` codes an fp32 slice
so that each code is the one the stacked reduce gives at the same logical
position: the scale of a block or row that crosses slices is ``torch.amax``
over the partial amaxes of every rank that holds part of it (one all-gather
of them, a round of ``encode_steps``), so that a NaN anywhere in the block
gives the stacked codec's scale of 1 (a MAX all-reduce over gloo drops a
NaN from any rank but the first), and the stochastic rounding takes the
dither at the slice's logical positions of the draw over the whole stack
(``row_dither``). ``cut`` and ``join`` move a logical row's encoding to a
slice and back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import state as state_codecs
from repro_torch.core.plan import grid_coords
from repro_torch.core.state import FP8_BLOCK, bf16_encode, fp8_blocks, fp8_quantize, fp8_scale
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.ring import Collective, drive

__all__ = ["Slice", "Pieces", "grid_pieces", "block_of", "codec_name", "init", "signature",
           "decode", "encode", "encode_steps", "row_dither", "cut", "join", "infer_layout"]

Shape = Tuple[int, ...]
Enc = Dict[str, torch.Tensor]


Cut = Tuple[int, str, int, int]  # (dim, mesh axis, parts, index)


@dataclasses.dataclass(frozen=True, init=False)
class Slice:
    """A rank's block of the logical ``shape``: for each cut (dim, mesh axis,
    parts, index), dim ``dim`` in ``parts`` equal runs and run ``index`` of
    them (no cut: the whole tensor), at most one cut a dim (the ``tp``
    specs cut over "model" alone; the ``fsdp`` specs cut "embed" over "data"
    as well). A cut into one part is no cut."""

    shape: Shape
    cuts: Tuple[Cut, ...]

    def __init__(self, shape, cuts=()):
        cuts = tuple(sorted((int(d), a, int(p), int(i)) for d, a, p, i in cuts if p > 1))
        if len({c[0] for c in cuts}) != len(cuts):
            raise ValueError(f"two cuts of one dim in {cuts}")
        object.__setattr__(self, "shape", tuple(shape))
        object.__setattr__(self, "cuts", cuts)

    @property
    def dim(self) -> Optional[int]:
        """The first cut's dim (the one cut's, for a ``tp`` slice), or None."""
        return self.cuts[0][0] if self.cuts else None

    @property
    def local_shape(self) -> Shape:
        out = list(self.shape)
        for d, _, p, _ in self.cuts:
            out[d] //= p
        return tuple(out)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the cuts are over."""
        return tuple(c[1] for c in self.cuts)

    def at(self, coords: Dict[str, int]) -> "Slice":
        """The same cuts at the coordinates ``coords`` ({mesh axis: index})."""
        return Slice(self.shape, cuts=[(d, a, p, coords[a]) for d, a, p, _ in self.cuts])

    def rows(self) -> "Slice":
        """The slice of the rows (``shape[:-1]``): the cuts of the other dims."""
        last = len(self.shape) - 1
        return Slice(self.shape[:-1], cuts=[c for c in self.cuts if c[0] != last])

    def cut(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """This slice of ``x``, whose dims after the first ``lead`` are the
        logical shape (a view)."""
        for d, _, p, i in self.cuts:
            w = self.shape[d] // p
            x = x.narrow(lead + d, i * w, w)
        return x

    def flat_ids(self, device) -> torch.Tensor:
        """The logical flat offset of each of the slice's elements, in the
        slice's own flat order (int64)."""
        ids = torch.zeros((), dtype=torch.int64, device=device)
        cut = {c[0]: c for c in self.cuts}
        d = 0
        while d < len(self.shape):  # uncut dims in one run each
            if d in cut:
                _, _, p, i = cut[d]
                n, w = self.shape[d], self.shape[d] // p
                offs = torch.arange(w, device=device) + i * w
                d += 1
            else:
                e = d
                while e < len(self.shape) and e not in cut:
                    e += 1
                n = math.prod(self.shape[d:e])
                offs = torch.arange(n, device=device)
                d = e
            ids = (ids[..., None] * n + offs).reshape(-1)
        return ids.reshape(-1)

    def unit_ids(self, unit: int, device) -> Optional[torch.Tensor]:
        """Where the slice's flat order is runs of whole units of ``unit``
        logical elements, each run starting at a unit boundary, the logical
        unit of each of the slice's units, in order (one int64 a unit); else
        None."""
        if not self.cuts:
            return torch.arange(self.size // unit, device=device) if self.size % unit == 0 \
                else None
        d, a, p, i = self.cuts[-1]
        inner = math.prod(self.shape[d + 1:])
        run, span = self.shape[d] // p * inner, self.shape[d] * inner
        if run % unit or span % unit:
            return None
        # each run as one element of the shape whose innermost cut dim is p long
        starts = Slice(self.shape[:d] + (p,), cuts=self.cuts[:-1] + ((d, a, p, i),)).flat_ids(
            device)
        per = run // unit
        return (starts[:, None] * per + torch.arange(per, device=device)[None, :]).reshape(-1)

    def crosses(self, layout: str) -> bool:
        """Whether fp8's scale blocks (flat) or rows (rowwise) cross the
        slices, so that a scale needs other ranks' elements."""
        if not self.cuts:
            return False
        return layout == "flat" or self.cuts[-1][0] == len(self.shape) - 1


@dataclasses.dataclass(frozen=True)
class Pieces:
    """The process groups that a grid's slices of a tensor lie over:
    ``group`` holds a rank of every block (its ranks row-major over
    ``axes``, (mesh axis, size) pairs), ``lines`` the rank's group along
    each of those mesh axes. The ``tp`` step's is the model group alone;
    the ``fsdp`` step's the pod's (data, model) plane."""

    group: Any
    axes: Tuple[Tuple[str, int], ...]
    lines: Dict[str, Any]

    def coords(self, j: int) -> Dict[str, int]:
        """The coordinates of rank ``j`` of ``group``."""
        return grid_coords(self.axes, j)


def grid_pieces(mesh, axes) -> Pieces:
    """The ``Pieces`` of a grid (``launch.mesh.Mesh`` with groups) whose
    blocks are cut over the mesh ``axes`` (("model",) under ``tp``, ("data",
    "model") under ``fsdp``): the rank's group of those axes and its line
    along each."""
    names = tuple(axes)
    return Pieces(mesh.group(names if len(names) > 1 else names[0]),
                  tuple((a, mesh.shape[a]) for a in names), {a: mesh.group(a) for a in names})


def block_of(shape, spec, mesh, axes) -> Slice:
    """The block of a leaf of logical ``shape`` under ``spec`` on this rank
    of ``mesh``: a cut for each dim split over one of the mesh ``axes``."""
    return Slice(shape, [(d, ax, mesh.shape[ax], mesh.index(ax))
                         for d, ax in enumerate(spec) if ax in axes])


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
    at a block boundary, the logical block of each of the slice's blocks,
    in order (one int64 per 512 elements: the slice's elements then view as
    (1, blocks, 512)); else None, and each element needs its own block id
    (``_blocks``)."""
    return sl.unit_ids(FP8_BLOCK, device)


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
           pieces: Optional[Pieces] = None) -> Enc:
    """Code the fp32 slice ``m`` (1, *storage): ``dither`` the slice's
    stochastic-rounding bits (``row_dither``; None rounds to nearest),
    ``pieces`` the groups over which a scale that crosses the slices takes
    its maximum (``encode_steps`` with blocking calls)."""
    return drive(encode_steps(name, m, sl, layout, dither, pieces))


def encode_steps(name: str, m: torch.Tensor, sl: Slice, layout: str, dither=None,
                 pieces: Optional[Pieces] = None):
    """``encode`` as a round generator (``ring.Flight``): where a block or
    row crosses the slices, one round that all-gathers the partial amax of
    every rank that holds part of it, over ``pieces`` (None: a round with no
    group, for a caller that drives it; counted as the model axis's,
    ``tensor_parallel.sent``),
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
    if sl.crosses(layout):  # over every block's rank (flat), or the last dim's line
        group = None if pieces is None else (
            pieces.group if flat else pieces.lines[sl.cuts[-1][1]])  # None: the caller drives
        (rows,) = yield [Collective("all_gather", amax, group, "model")]
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
        if field == "scale":  # rowwise: the rows' (whole where the last dim is cut)
            out[field] = sl.rows().cut(v, lead=1) if layout == "rowwise" else v
        elif layout == "flat":
            out[field] = v[:, sl.flat_ids(v.device)]
        else:
            out[field] = sl.cut(v, lead=1)
        out[field] = out[field].clone(memory_format=torch.contiguous_format)
    return out


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def join(name: str, enc: Enc, sl: Slice, layout: str, pieces: Optional[Pieces] = None) -> Enc:
    """The slices' encodings -> the logical row's (1, *storage), the
    stacked codec's fields and shapes (flat fp8 padded with zero codes);
    collective where the tensor is cut: one all-gather a field over
    ``pieces.group``, each rank's block written at its logical positions."""
    layout = _storage_layout(sl, layout)
    store = state_codecs.storage_shape(sl.shape, layout)
    want = state_codecs.require_codec(name).init(1, store, "meta")
    out = {}
    for field, v in enc.items():
        if field == "scale" and layout == "flat":  # whole on every rank
            out[field] = v
            continue
        fsl = sl.rows() if field == "scale" else sl
        if not fsl.cuts and layout == "rowwise":
            out[field] = v
            continue
        bits = v.view(_BITS[v.element_size()])
        wide = bits.to(torch.int32).reshape(1, -1)  # gloo gathers no 8- or 16-bit integers
        got = torch.zeros(want[field].shape, dtype=torch.int32, device=v.device)
        if fsl.cuts:
            rows = tensor_parallel.all_gather(wide, 0, pieces.group)
            blocks = [fsl.at(pieces.coords(j)) for j in range(rows.shape[0])]
        else:
            rows, blocks = wide, [fsl]
        for r, b in zip(rows, blocks):
            if layout == "flat":
                got[:, b.flat_ids(v.device)] = r
            else:
                b.cut(got, lead=1).copy_(r.view((1,) + b.local_shape))
        out[field] = got.to(bits.dtype).view(v.dtype)
    return out
