"""Kernel backends for the reduce's chunked ops: "torch" (plain) and "cuda"
(hand-written kernels). Importing registers both; nothing is built.

``autotune`` sweeps and caches the block sizes of the tuned kernels (the
``--autotune`` flag); the "cuda" backend reads that cache for each tuned
launch. ``introspect.count_launches`` counts one call's kernel launches."""

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
