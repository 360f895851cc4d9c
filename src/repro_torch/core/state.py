"""ScaleCom state: per-worker error-feedback residues and the step counter.

The port of the fp32 half of ``repro.core.state``. The residue ("local
memory") is the only persistent state the algorithm adds: G x P elements for
P compressed parameters and G workers. Residues are stored per tensor as
``{"q": (G, *storage)}`` under the JAX key-path string of the parameter, so
a JAX state carries across field by field (``repro_torch.models.convert``).

Storage layout (``ScaleComConfig.layout``, resolved by ``resolve_layout``):

  flat     (G, size): the paper's flat buffer of chunks.
  rowwise  (G, *param_shape): chunks along the tensor's own last dim.
  auto     $SCALECOM_TORCH_LAYOUT if set, else flat.

Only the fp32 codec is ported. The lossy bf16 / fp8 / fp8_ec codecs wait for
their stochastic rounding (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple, Union

import torch

from repro_torch import tree

__all__ = [
    "ResidueCodec",
    "CODECS",
    "ScaleComState",
    "codec_signature",
    "init_state",
    "residue_signature",
    "resolve_layout",
    "storage_shape",
    "require_codec",
]

Shape = Tuple[int, ...]

_LAYOUT_ENV = "SCALECOM_TORCH_LAYOUT"
_LAYOUTS = ("flat", "rowwise")
_LOSSY = ("bf16", "fp8", "fp8_ec")


def resolve_layout(spec: Union[str, None] = "auto") -> str:
    """Resolve "auto" | "flat" | "rowwise"; "auto" reads $SCALECOM_TORCH_LAYOUT
    at call time and defaults to flat. An explicit layout wins."""
    if spec in (None, "auto"):
        spec = os.environ.get(_LAYOUT_ENV, "").strip() or "flat"
    if spec not in _LAYOUTS:
        raise ValueError(
            f"unknown chunk layout {spec!r}; expected one of {_LAYOUTS} "
            f'(or "auto" to read ${_LAYOUT_ENV})'
        )
    return spec


def storage_shape(param_shape: Shape, layout: str) -> Shape:
    """Residue storage shape (without the worker axis) for one tensor."""
    layout = resolve_layout(layout)
    size = 1
    for d in param_shape:
        size *= d
    if layout == "flat":
        return (size,)
    return tuple(param_shape) if param_shape else (1,)


def require_codec(residue_dtype: str) -> "ResidueCodec":
    """The codec for ``residue_dtype``; the lossy ones are not ported yet."""
    if residue_dtype in _LOSSY:
        raise NotImplementedError(
            f"residue_dtype={residue_dtype!r} is not ported yet; only fp32 "
            f"residues run (ROADMAP Queue 1 item 12, lossy codecs and elasticity)"
        )
    if residue_dtype not in CODECS:
        raise ValueError(
            f"unknown residue_dtype {residue_dtype!r}; expected one of "
            f"{tuple(CODECS) + _LOSSY}"
        )
    return CODECS[residue_dtype]


class ResidueCodec:
    """fp32 residues: encode and decode are the identity."""

    name: str = "fp32"

    def init(self, n: int, shape: Shape, device) -> Dict[str, torch.Tensor]:
        return {"q": torch.zeros((n,) + tuple(shape), dtype=torch.float32, device=device)}

    def decode(self, enc: Dict[str, torch.Tensor], shape: Shape) -> torch.Tensor:
        del shape
        return enc["q"]

    def encode(self, m: torch.Tensor, shape: Shape) -> Dict[str, torch.Tensor]:
        del shape
        return {"q": m}

    def nbytes(self, n: int, shape: Shape) -> int:
        size = 1
        for d in shape:
            size *= d
        return n * size * 4


CODECS: Dict[str, ResidueCodec] = {"fp32": ResidueCodec()}


@dataclasses.dataclass
class ScaleComState:
    """Per-tensor encoded residues (keyed by JAX path string) + step counter.

    ``t`` is a host integer: it picks the cyclic leader ``t mod G`` without
    a device round trip.
    """

    residues: Dict[str, Dict[str, torch.Tensor]]
    t: int = 0


def init_state(
    params,
    n_workers: int,
    residue_dtype: str = "fp32",
    min_size: int = 2048,
    layout: str = "auto",
) -> ScaleComState:
    """Zero residues for every tensor of at least ``min_size`` elements, on
    each parameter's own device. Must match the ScaleComConfig used later."""
    codec = require_codec(residue_dtype)
    residues = {}
    for path, leaf in tree.flatten_with_path(params):
        if leaf.numel() < min_size:
            continue
        residues[path] = codec.init(
            n_workers, storage_shape(tuple(leaf.shape), layout), leaf.device
        )
    return ScaleComState(residues=residues, t=0)


def _dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32": the spelling JAX's signatures use."""
    return str(dtype).replace("torch.", "")


def _enc_signature(enc: Dict[str, torch.Tensor]) -> Tuple:
    return tuple(
        sorted((k, tuple(v.shape), _dtype_name(v.dtype)) for k, v in enc.items())
    )


def codec_signature(residue_dtype: str, n: int, storage: Shape) -> Tuple:
    """The signature ``init`` would give a residue, computed without allocating."""
    require_codec(residue_dtype)
    return (("q", (n,) + tuple(storage), "float32"),)


def residue_signature(residues: Dict[str, Dict[str, torch.Tensor]]) -> frozenset:
    """Hashable (path, encoding signature) pairs: keys and validates the plan."""
    return frozenset((path, _enc_signature(enc)) for path, enc in residues.items())
