"""Device resolution for the port: the card by default, the CPU only on request.

Every entry point of ``repro_torch`` takes ``device`` (default ``"cuda"``) and
resolves it here. Without CUDA a CUDA request raises; nothing falls back to
the CPU behind the caller's back. ``require_sm90`` guards the kernel build:
the kernels are compiled for ``sm_90a`` and run on a Hopper card only.
``fp32_accumulation`` makes the card's matrix products accumulate as the
JAX package's do.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "require_sm90", "fp32_accumulation"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it asks for CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default, but CUDA is not "
            "available here; pass device='cpu' (--device cpu) to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def require_sm90() -> None:
    """Raise unless a compute-capability 9.0 (Hopper) card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the repro_torch CUDA kernels need a CUDA card; CUDA is not available"
        )
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"the repro_torch CUDA kernels are built for sm_90a (Hopper); "
            f"this card ({torch.cuda.get_device_name()}) is sm_{cap[0]}{cap[1]}"
        )


def fp32_accumulation() -> None:
    """Matrix products keep fp32 accumulation on the card, as XLA's do in the
    JAX package: no TF32 (about three decimal digits) in fp32 GEMMs, and no
    reduced-precision reductions in bf16 and fp16 GEMMs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the reference accumulates bf16 and fp16 products in fp32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
