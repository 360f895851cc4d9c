"""Launch counting for tests and ``chip_smoke.py``: the counterpart of
``repro.backends.introspect.count_pallas_launches``.

The reference traces a function to a jaxpr and counts its ``pallas_call``
equations. PyTorch runs eagerly, so the port counts what ran: every kernel
wrapper adds one to its ``launches`` where it launches its kernel
(``repro_torch.kernels.launches``), and ``count_launches`` is the difference
of those counts across one call. Plain versions launch nothing, so on CPU
tensors every count is 0.

The tripwire it serves: one compressed tensor's reduce is 1 launch fused
(``fused_reduce``) and 3 unfused (``chunk_argmax``, ``ef_update``,
``chunk_scatter``).
"""

from __future__ import annotations

from typing import Dict

from repro_torch import kernels

__all__ = ["count_launches"]


def count_launches(fn, *args, **kwargs) -> Dict[str, int]:
    """Kernel launches by wrapper name during ``fn(*args, **kwargs)``."""
    before = kernels.launches()
    fn(*args, **kwargs)
    after = kernels.launches()
    return {name: after[name] - before[name] for name in after}
