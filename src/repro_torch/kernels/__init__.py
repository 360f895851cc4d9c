"""Hand-written CUDA kernels of the ScaleCom reduce and their PyTorch wrappers.

``chunk_topk`` (select, top-m select, gather, scatter), ``ef_update`` and
``fused_reduce`` (the fused reduce, and its one-row variant
``fused_select_update``) wrap the kernels in ``csrc/*.cu``; ``build``
compiles those sources with nvcc at first use. Importing this package
builds nothing.
"""

from repro_torch.kernels import chunk_topk, ef_update, fused_reduce

# every kernel wrapper, in the order of the TPU kernels they replace
KERNELS = (
    chunk_topk.chunk_argmax,
    chunk_topk.chunk_topm,
    chunk_topk.chunk_gather,
    chunk_topk.chunk_scatter,
    ef_update.ef_update,
    fused_reduce.fused_reduce,
    fused_reduce.fused_select_update,  # a variant of the last: one row, no ĝ
)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count (and per-variant, per-route and
    per-block-size counts) to 0."""
    for k in KERNELS:
        k.launches = 0
        for counts in ("variants", "routes", "threads"):
            if hasattr(k, counts):
                setattr(k, counts, dict.fromkeys(getattr(k, counts), 0))


def launches() -> dict:
    """Launch count per kernel wrapper, by name."""
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["chunk_topk", "ef_update", "fused_reduce", "KERNELS", "reset_launches", "launches"]
