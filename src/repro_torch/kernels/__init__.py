"""Hand-written CUDA kernels of the ScaleCom reduce and their PyTorch wrappers.

``chunk_topk`` (select, scatter) and ``ef_update`` wrap the kernels in
``csrc/scalecom_kernels.cu``; ``build`` compiles that source with nvcc at
first use. Importing this package builds nothing.
"""

from repro_torch.kernels import chunk_topk, ef_update

KERNELS = (chunk_topk.chunk_argmax, ef_update.ef_update, chunk_topk.chunk_scatter)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    """Launch count per kernel wrapper, by name."""
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["chunk_topk", "ef_update", "KERNELS", "reset_launches", "launches"]
