"""Kernel backends for the reduce's chunked ops: "torch" (plain) and "cuda"
(hand-written kernels). Importing registers both; nothing is built."""

from repro_torch.backends.base import (
    FUSABLE_MODES,
    KernelBackend,
    register_backend,
    resolve_backend,
    resolve_fused,
)
from repro_torch.backends import cuda_backend, torch_backend  # noqa: F401  (register)

__all__ = [
    "FUSABLE_MODES",
    "KernelBackend",
    "register_backend",
    "resolve_backend",
    "resolve_fused",
]
