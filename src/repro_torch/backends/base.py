"""Kernel-backend protocol and registry: the dispatch layer of the reduce.

The port of ``repro.backends.base``. ``scalecom_reduce`` routes every chunked
op through a ``KernelBackend``. A backend implements three primitives, all
over the trailing axis of an arbitrarily batched tensor (flat is the
single-row case of the worker-stacked or rowwise form):

  select_indices(x, chunk, topm)        per-chunk magnitude top-m offsets
  gather(x, idx, chunk, topm)           values at per-chunk offsets
  scatter(vals, idx, chunk, size, topm) dense tensor from (offset, value)

and inherits default compositions of the derived ops:

  select(x, chunk, topm)                  (idx, vals)
  ef_update(m, g, idx, beta, chunk, topm) (m', vals), the fused Eq. 5 update
  fused_reduce(m, g, beta, chunk, topm,
               mode, leader)              (idx, vals, m', ghat): the whole
                                          per-tensor inner loop composed of
                                          the three primitives
  fused_select_update(m, g, beta, chunk,
                      topm, key)          (idx, vals, m'): one rank's select
                                          and Eq. 5 update, the fused path of
                                          a process group's leader

Registered backends:

  "torch"  the plain PyTorch ops of ``repro_torch.core.chunked`` on any
           device: the reference, and the path of a CPU run.
  "cuda"   the hand-written CUDA kernels (``repro_torch.kernels``), with
           ``fused_reduce`` as one launch. On CPU tensors (the tests) its
           wrappers run their plain versions.

``resolve_backend("auto", device)`` reads $SCALECOM_TORCH_BACKEND at call
time; unset, the device decides: "cuda" for a CUDA run, "torch" for a CPU
run. The caller chose the device, so "auto" never probes its way to the CPU.
An explicit name or instance wins; an unknown name raises naming the set.

``resolve_fused`` decides whether the reduce takes ``fused_reduce``: an
explicit boolean wins; "auto" reads $SCALECOM_TORCH_FUSED at call time.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple, Union

import torch

__all__ = [
    "KernelBackend",
    "FUSABLE_MODES",
    "register_backend",
    "resolve_backend",
    "resolve_fused",
]

# Selection modes fused_reduce implements: the shared-index compressors.
FUSABLE_MODES = ("clt_k", "true_topk")

Tensor = torch.Tensor


class KernelBackend:
    """Dispatch target for the chunked hot-path ops (see module docstring)."""

    name: str = "base"

    # -- primitives -------------------------------------------------------

    def select_indices(self, x: Tensor, chunk: int, topm: int = 1) -> Tensor:
        """int32 (..., n_chunks) for topm == 1, else (..., n_chunks, topm)
        in descending magnitude, ties to the lower offset."""
        raise NotImplementedError

    def gather(self, x: Tensor, idx: Tensor, chunk: int, topm: int = 1) -> Tensor:
        """Values of (..., n) ``x`` at per-chunk offsets ``idx`` (broadcast)."""
        raise NotImplementedError

    def scatter(self, vals: Tensor, idx: Tensor, chunk: int, size: int,
                topm: int = 1) -> Tensor:
        """Dense (..., size) with per-chunk ``vals`` at ``idx``, else zeros."""
        raise NotImplementedError

    # -- derived ----------------------------------------------------------

    def select(self, x: Tensor, chunk: int, topm: int = 1) -> Tuple[Tensor, Tensor]:
        idx = self.select_indices(x, chunk, topm)
        return idx, self.gather(x, idx, chunk, topm)

    def ef_update(self, m: Tensor, g: Tensor, idx: Tensor, beta: float,
                  chunk: int, topm: int = 1) -> Tuple[Tensor, Tensor]:
        """(m', vals): vals = (m+g) at idx, m' = m + beta * (g - scatter(vals))."""
        from repro_torch.core.filter import lowpass_update  # core imports backends

        ef = m + g
        vals = self.gather(ef, idx, chunk, topm)
        own = self.scatter(vals, idx, chunk, m.shape[-1], topm)
        return lowpass_update(m, g, own, beta), vals

    def fused_reduce(self, m: Tensor, g: Tensor, beta: float, chunk: int,
                     topm: int = 1, mode: str = "clt_k",
                     leader: Optional[int] = None):
        """select over worker-stacked EF -> Eq. 5 update -> ghat scatter.

        m, g: (G, ..., size); ``leader`` is the clt_k leader rank t mod G
        (ignored for true_topk). Returns (idx, vals, m_new, ghat). This
        default composes the three primitives, the op sequence of the
        unfused reduce; the "cuda" backend overrides it with one kernel.
        """
        if mode not in FUSABLE_MODES:
            raise ValueError(f"fused_reduce supports modes {FUSABLE_MODES}, got {mode!r}")
        ef = m + g
        if mode == "clt_k":
            idx = self.select_indices(ef, chunk, topm)[leader]
        else:
            idx = self.select_indices(torch.mean(ef, dim=0), chunk, topm)
        m_new, vals = self.ef_update(m, g, idx, beta, chunk, topm)
        ghat = self.scatter(torch.mean(vals, dim=0), idx, chunk, m.shape[-1], topm)
        return idx, vals, m_new, ghat

    def fused_select_update(self, m: Tensor, g: Tensor, beta: float, chunk: int,
                            topm: int = 1, key: Optional[Tensor] = None):
        """select over ONE worker's EF (or ``key``) -> Eq. 5 update.

        m, g (and key): (..., size). The offsets are the top-m of |m + g|
        per chunk, or of |key| when given (true_topk's worker-mean EF).
        Returns (idx, vals, m_new). This default is ``select_indices``
        followed by ``ef_update``; the "cuda" backend overrides it with one
        kernel.
        """
        idx = self.select_indices(m + g if key is None else key, chunk, topm)
        m_new, vals = self.ef_update(m, g, idx, beta, chunk, topm)
        return idx, vals, m_new

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<KernelBackend {self.name}>"


_REGISTRY: Dict[str, Callable[[], KernelBackend]] = {}

_ENV_VAR = "SCALECOM_TORCH_BACKEND"


def register_backend(name: str, factory: Callable[[], KernelBackend]) -> None:
    """Register a backend factory under ``name`` (resolved lazily)."""
    _REGISTRY[name] = factory


def resolve_backend(
    spec: Union[str, KernelBackend, None] = "auto",
    device: Union[str, torch.device, None] = None,
) -> KernelBackend:
    """Resolve "auto" | "torch" | "cuda" | an instance (see module docstring)."""
    if isinstance(spec, KernelBackend):
        return spec
    name = spec or "auto"
    if name == "auto":
        env = os.environ.get(_ENV_VAR, "").strip()
        if env:
            name = env
        else:
            on_card = device is not None and torch.device(device).type == "cuda"
            name = "cuda" if on_card else "torch"
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory()


_FUSED_ENV = "SCALECOM_TORCH_FUSED"
_FUSED_TRUE = ("1", "true", "on", "yes")
_FUSED_FALSE = ("0", "false", "off", "no")


def resolve_fused(spec: Union[bool, str, None] = "auto") -> bool:
    """Resolve the fused-reduce decision (True | False | "auto").

    An explicit boolean wins. "auto" (or None) reads $SCALECOM_TORCH_FUSED at
    call time: {1, true, on, yes} turn it on, {0, false, off, no} off (any
    case); unset or empty means off. Anything else raises naming the valid
    set. The JAX package's $SCALECOM_FUSED is not read.
    """
    if isinstance(spec, bool):
        return spec
    if spec in (None, "auto"):
        env = os.environ.get(_FUSED_ENV, "").strip().lower()
        if not env:
            return False
        if env in _FUSED_TRUE:
            return True
        if env in _FUSED_FALSE:
            return False
        raise ValueError(
            f"invalid {_FUSED_ENV}={env!r}; expected one of {_FUSED_TRUE + _FUSED_FALSE}"
        )
    raise ValueError(
        f"fused must be True, False, or 'auto' (then ${_FUSED_ENV} decides); got {spec!r}"
    )
