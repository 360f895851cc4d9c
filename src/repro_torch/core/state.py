"""ScaleCom state: per-worker error-feedback residues, their codecs and the step counter.

The port of ``repro.core.state``. The residue ("local memory") is the only
persistent state the algorithm adds: G x P elements for P compressed
parameters and G workers. Residues are stored per tensor under the JAX
key-path string of the parameter, encoded by one of four codecs, so a JAX
state carries across field by field (``repro_torch.models.convert``):

  fp32    {"q": fp32}                           4 B per element
  bf16    {"q": bf16}                           2 B, stochastic rounding
  fp8     {"q": e4m3, "scale": fp32}            1 B + one scale per 512
                                                elements (flat) or per row
  fp8_ec  fp8 plus {"c": bf16}, the e4m3 error  3 B, c stochastically rounded

Storage layout (``ScaleComConfig.layout``, resolved by ``resolve_layout``):

  flat     (G, size): the paper's flat buffer of chunks; fp8 pads it to a
           multiple of 512 and keeps one scale per 512 elements.
  rowwise  (G, *param_shape): chunks along the tensor's own last dim; fp8
           keeps one scale per row.
  auto     $SCALECOM_TORCH_LAYOUT if set, else flat.

Stochastic rounding needs 16 random bits per element and step. JAX draws
them with ``jax.random.bits(codec_key(path, t))``, which the port cannot
reproduce; the port draws them in ONE function, ``codec_dither``, from its
own ``torch.Generator`` seeded by (salt 4, crc32(path), t), and
``stochastic_round`` takes them as a tensor. The tests hand both packages
JAX's bits through ``codec_dither``. ``encode(..., key=None)`` rounds to
nearest, as in JAX.

The casts follow ``ml_dtypes`` (the JAX package's dtypes) bit for bit,
whatever PyTorch's own cast does at the edges: e4m3 overflow (|x| > 464,
+-inf) gives NaN, never a saturated 448; a NaN keeps its sign and becomes
e4m3 0x7f / bf16 0x7fc0. A NaN made by arithmetic (inf / inf) takes the
platform's sign, and XLA's CPU arithmetic flushes fp32 subnormals to zero
where PyTorch keeps them, so residues holding inf, NaN or fp32 subnormals
reproduce bit for bit only on one platform.
"""

from __future__ import annotations

import dataclasses
import math
import os
import zlib
from typing import Dict, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.device import resolve_device

__all__ = [
    "ResidueCodec",
    "CODECS",
    "ScaleComState",
    "codec_dither",
    "codec_key",
    "codec_roundtrip_error",
    "codec_signature",
    "init_state",
    "remap_state",
    "require_codec",
    "residue_bytes",
    "residue_signature",
    "resolve_layout",
    "stochastic_round",
    "storage_shape",
]

Shape = Tuple[int, ...]
Enc = Dict[str, torch.Tensor]

_LAYOUT_ENV = "SCALECOM_TORCH_LAYOUT"
_LAYOUTS = ("flat", "rowwise")

_FP8_MAX = 448.0  # e4m3 finite max
_FP8_ROUND_MAX = 464.0  # larger magnitudes round past 448: NaN in e4m3fn
_FP8_CHUNK = 512  # flat-layout scale granularity
_SR_SALT = 4  # the JAX package's stochastic-rounding salt


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
    if layout == "flat":
        return (math.prod(param_shape),)
    return tuple(param_shape) if param_shape else (1,)


# -- stochastic rounding --------------------------------------------------------


def codec_key(path: str, t: int) -> Tuple[str, int]:
    """The (tensor, step) a stochastic-rounding encode draws its dither for."""
    return (path, int(t))


def _mix64(x: int) -> int:
    """splitmix64's finalizer: every bit of the seed reaches the low 32, the
    only ones the CPU generator (mt19937) reads."""
    mask = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return x ^ (x >> 31)


def codec_dither(key: Tuple[str, int], shape, device) -> torch.Tensor:
    """int32 dither in [0, 2^16) of ``shape`` for ``key = (path, t)``.

    The one draw of the codecs: a generator seeded by the salt, crc32(path)
    and t, on ``device`` (the card and the CPU draw different bits).
    """
    path, t = key
    h = zlib.crc32(path.encode()) & 0x7FFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix64(((h << 32) | (t & 0xFFFFFFFF)) ^ _SR_SALT))
    return torch.randint(0, 1 << 16, tuple(shape), generator=gen, device=device,
                         dtype=torch.int32)


def _sign_code(x: torch.Tensor, code: int, sign: int, dtype) -> torch.Tensor:
    """``code`` where x's sign bit is clear, ``code | sign`` where it is set."""
    on = torch.full((), code | sign, dtype=dtype, device=x.device)
    off = torch.full((), code, dtype=dtype, device=x.device)
    return torch.where(torch.signbit(x), on, off)


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 rounding to nearest even; NaN -> 0x7fc0 with x's sign."""
    q = x.to(torch.bfloat16).view(torch.int16)
    nan = _sign_code(x, 0x7FC0, -0x8000, torch.int16)
    return torch.where(torch.isnan(x), nan, q).view(torch.bfloat16)


def _to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> e4m3fn rounding to nearest even; NaN, +-inf and |x| > 464
    (which round past 448) -> 0x7f with x's sign, as ml_dtypes."""
    q = torch.clamp(x, -_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).view(torch.uint8)
    bad = torch.isnan(x) | (torch.abs(x) > _FP8_ROUND_MAX)
    return torch.where(bad, _sign_code(x, 0x7F, 0x80, torch.uint8), q).view(
        torch.float8_e4m3fn)


def stochastic_round(x: torch.Tensor, dither: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding of fp32 ``x`` onto the bf16 grid.

    ``dither``: int32 in [0, 2^16), x's shape. Adds it below the bf16
    mantissa boundary and truncates (bf16 is fp32's top 16 bits), as the
    JAX package's uint32 ``(bits + dither) & 0xFFFF0000``. Non-finite inputs
    and dither overflow fall back to nearest.
    """
    f = x.to(torch.float32)
    finite = torch.isfinite(f)
    # zero a non-finite input's bits first: the int32 add then never overflows
    bits = torch.where(finite, f.view(torch.int32), 0)
    out = ((bits + dither) & -65536).view(torch.float32)
    return _to_bf16(torch.where(finite & torch.isfinite(out), out, f))


def _bf16_encode(x: torch.Tensor, key) -> torch.Tensor:
    """bf16 of x: nearest for key None, else stochastic with the dither of
    ``key``, a ``codec_key`` or the int32 dither itself."""
    if key is None:
        return _to_bf16(x)
    dither = key if isinstance(key, torch.Tensor) else codec_dither(key, x.shape, x.device)
    if dither.shape != x.shape:
        raise ValueError(f"dither of shape {tuple(dither.shape)} for a tensor of "
                         f"shape {tuple(x.shape)}")
    return stochastic_round(x, dither)


# -- codecs ---------------------------------------------------------------------


class ResidueCodec:
    """Encode/decode an (n, *storage) fp32 residue; fp32 is the identity.

    ``encode``'s ``key`` is None (round to nearest), a ``codec_key(path,
    t)`` (stochastic rounding with ``codec_dither``'s draw) or the int32
    dither itself, of the rounded tensor's shape: m's, or for flat fp8_ec
    the padded (n, p) of its correction term.
    """

    name: str = "fp32"

    def init(self, n: int, shape: Shape, device) -> Enc:
        return {"q": torch.zeros((n,) + tuple(shape), dtype=torch.float32, device=device)}

    def decode(self, enc: Enc, shape: Shape) -> torch.Tensor:
        del shape
        return enc["q"]

    def encode(self, m: torch.Tensor, shape: Shape, *, key=None) -> Enc:
        del shape, key
        return {"q": m}

    def nbytes(self, n: int, shape: Shape) -> int:
        return n * math.prod(shape) * 4


class _Bf16Codec(ResidueCodec):
    name = "bf16"

    def init(self, n, shape, device):
        return {"q": torch.zeros((n,) + tuple(shape), dtype=torch.bfloat16, device=device)}

    def decode(self, enc, shape):
        del shape
        return enc["q"].to(torch.float32)

    def encode(self, m, shape, *, key=None):
        del shape
        return {"q": _bf16_encode(m, key)}

    def nbytes(self, n, shape):
        return n * math.prod(shape) * 2


def _padded(size: int) -> int:
    return -(-size // _FP8_CHUNK) * _FP8_CHUNK


class _Fp8Codec(ResidueCodec):
    """e4m3 residue. flat (n, size): one fp32 scale per 512 elements, size
    padded to a multiple of 512; rowwise (n, *shape): one scale per row."""

    name = "fp8"

    def init(self, n, shape, device):
        shape = tuple(shape)
        if len(shape) == 1:
            p = _padded(shape[0])
            q_shape, s_shape = (n, p), (n, p // _FP8_CHUNK)
        else:
            q_shape, s_shape = (n,) + shape, (n,) + shape[:-1]
        return {
            "q": torch.zeros(q_shape, dtype=torch.float8_e4m3fn, device=device),
            "scale": torch.zeros(s_shape, dtype=torch.float32, device=device),
        }

    def decode(self, enc, shape):
        q, scale = enc["q"], enc["scale"]
        if len(shape) == 1:
            n, p = q.shape
            x = q.to(torch.float32).reshape(n, -1, _FP8_CHUNK) * scale[..., None]
            return x.reshape(n, p)[:, : shape[0]]
        return q.to(torch.float32) * scale[..., None]

    def encode(self, m, shape, *, key=None):
        del key  # e4m3 stays nearest-rounded; fp8_ec carries the correction
        if len(shape) == 1:
            n, p = m.shape[0], _padded(shape[0])
            mp = torch.nn.functional.pad(m, (0, p - shape[0])).reshape(n, -1, _FP8_CHUNK)
        else:
            mp = m
        amax = torch.amax(torch.abs(mp), dim=-1)
        # a tensor divisor: PyTorch on the card multiplies by the reciprocal
        # of a Python scalar, which is not the division JAX does
        limit = torch.full((), _FP8_MAX, dtype=torch.float32, device=m.device)
        scale = torch.where(amax > 0, amax / limit, 1.0)
        q = _to_e4m3(mp / scale[..., None])
        return {"q": q.reshape(m.shape[0], -1) if len(shape) == 1 else q, "scale": scale}

    def nbytes(self, n, shape):
        size = math.prod(shape)
        if len(shape) == 1:
            p = _padded(size)
            return n * (p + 4 * p // _FP8_CHUNK)
        return n * (size + 4 * size // shape[-1])


class _Fp8EcCodec(_Fp8Codec):
    """Error-compensated e4m3: decode = q * scale + c, c = SR_bf16(m - q * scale)."""

    name = "fp8_ec"

    def init(self, n, shape, device):
        enc = super().init(n, shape, device)
        enc["c"] = torch.zeros(enc["q"].shape, dtype=torch.bfloat16, device=device)
        return enc

    def decode(self, enc, shape):
        base = super().decode(enc, shape)
        c = enc["c"].to(torch.float32)
        if len(shape) == 1:
            c = c[:, : shape[0]]
        return base + c

    def encode(self, m, shape, *, key=None):
        enc = super().encode(m, shape)
        resid = m - super().decode(enc, shape)
        if len(shape) == 1:
            resid = torch.nn.functional.pad(resid, (0, enc["q"].shape[1] - shape[0]))
        enc["c"] = _bf16_encode(resid, key)
        return enc

    def nbytes(self, n, shape):
        size = math.prod(shape)
        extra = 2 * (_padded(size) if len(shape) == 1 else size)
        return super().nbytes(n, shape) + n * extra


CODECS: Dict[str, ResidueCodec] = {
    "fp32": ResidueCodec(),
    "bf16": _Bf16Codec(),
    "fp8": _Fp8Codec(),
    "fp8_ec": _Fp8EcCodec(),
}


def require_codec(residue_dtype: str) -> ResidueCodec:
    """The codec for ``residue_dtype``; an unknown name raises naming the set."""
    if residue_dtype not in CODECS:
        raise ValueError(
            f"unknown residue_dtype {residue_dtype!r}; expected one of {tuple(CODECS)}"
        )
    return CODECS[residue_dtype]


# -- state ----------------------------------------------------------------------


@dataclasses.dataclass
class ScaleComState:
    """Per-tensor encoded residues (keyed by JAX path string) + step counter.

    ``t`` is a host integer: it picks the cyclic leader ``t mod G`` and keys
    the stochastic-rounding draws without a device round trip.
    """

    residues: Dict[str, Enc]
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


def _enc_signature(enc: Enc) -> Tuple:
    return tuple(
        sorted((k, tuple(v.shape), _dtype_name(v.dtype)) for k, v in enc.items())
    )


def codec_signature(residue_dtype: str, n: int, storage: Shape) -> Tuple:
    """The signature ``init`` would give a residue, computed on the meta
    device (no allocation)."""
    return _enc_signature(require_codec(residue_dtype).init(n, storage, "meta"))


def residue_signature(residues: Dict[str, Enc]) -> frozenset:
    """Hashable (path, encoding signature) pairs: keys and validates the plan."""
    return frozenset((path, _enc_signature(enc)) for path, enc in residues.items())


def remap_state(state: ScaleComState, old_n: int, new_n: int,
                residue_dtype: str = "fp32") -> ScaleComState:
    """Move the residues to a new worker count, keeping their worker mean.

    expand (new_n = r * old_n) repeats each worker's residue r times; fold
    (old_n = r * new_n) takes the mean of each r workers; any other change
    expands to lcm(old_n, new_n) and folds. Lossy codecs decode (against the
    encoded trailing shape, the padded buffer for flat fp8), remap in fp32
    and re-encode with nearest rounding. fp32 8 -> 4 -> 8 is bitwise. ``t``
    is kept.
    """
    if old_n <= 0 or new_n <= 0:
        raise ValueError(f"remap_state worker counts must be positive, got {old_n} -> {new_n}")
    codec = require_codec(residue_dtype)
    lcm = math.lcm(old_n, new_n)
    up, down = lcm // old_n, lcm // new_n
    new_residues = {}
    for path, enc in state.residues.items():
        q = enc["q"]
        if q.shape[0] != old_n:
            raise ValueError(
                f"remap_state: residue {path!r} has worker axis {q.shape[0]}, "
                f"expected old_n={old_n} (was the state already remapped, or "
                f"initialized for a different n_workers/groups?)"
            )
        shape = tuple(q.shape[1:])
        m = codec.decode(enc, shape)
        if up > 1:
            m = torch.repeat_interleave(m, up, dim=0)
        if down > 1:
            m = torch.mean(m.reshape((new_n, down) + tuple(m.shape[1:])), dim=1)
        new_residues[path] = codec.encode(m, shape, key=None)
    return ScaleComState(residues=new_residues, t=state.t)


def codec_roundtrip_error(name: str, *, n: int = 4, size: int = 2048, steps: int = 5,
                          step_scale: float = 0.2, seed: int = 0,
                          device="cuda") -> Dict[str, float]:
    """encode o decode error of one codec over an EF-like accumulation loop
    (the decoded value feeds the next step, as in the reduce), on ``device``
    (the card unless ``device="cpu"``; raises without CUDA otherwise).

    Returns the worst and last per-step relative roundtrip error and the
    drift of the quantized accumulator against an exact fp32 shadow. The
    steps are drawn from ``seed`` with a torch generator on ``device`` and
    encoded with ``codec_key("<roundtrip>", t)``, so the numbers are the
    port's own (the card and the CPU draw different bits).
    """
    codec = require_codec(name)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.zeros((n, size), device=dev)
    shadow = torch.zeros((n, size), device=dev)
    worst = last = 0.0
    for t in range(steps):
        g = step_scale * torch.randn((n, size), generator=gen, device=dev)
        target = m + g
        shadow = shadow + g
        m = codec.decode(codec.encode(target, (size,), key=codec_key("<roundtrip>", t)), (size,))
        last = float(torch.linalg.norm(m - target)) / (float(torch.linalg.norm(target)) or 1.0)
        worst = max(worst, last)
    drift = float(torch.linalg.norm(m - shadow)) / (float(torch.linalg.norm(shadow)) or 1.0)
    return {"worst_step": worst, "last_step": last, "drift": drift}


def residue_bytes(params, n_workers: int, residue_dtype: str = "fp32",
                  min_size: int = 2048, layout: str = "auto") -> int:
    """Bytes ``init_state`` allocates for these parameters."""
    codec = require_codec(residue_dtype)
    total = 0
    for leaf in tree.leaves(params):
        shape = tuple(leaf.shape)
        if math.prod(shape) >= min_size:
            total += codec.nbytes(n_workers, storage_shape(shape, layout))
    return total
