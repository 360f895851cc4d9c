"""The bucketed launch of the reduce: buckets in schedule order, on a side stream.

The port of ``repro.core.overlap``. ``core.plan.plan_buckets`` packs the
tensors into buckets of about ``ScaleComConfig.bucket_bytes`` dense bytes in
reverse leaf order (the order backward makes gradients); ``run_buckets``
runs each bucket's reduce in that order. JAX threads an
``optimization_barrier`` token through the buckets so that they launch in
schedule order and each depends only on its own leaves; in eager PyTorch on
one card the counterpart is explicit stream order:

  overlap=True, CUDA   the buckets run in order on the card's side stream
                       (one per card, kept), which first waits for the
                       caller's stream; an event after
                       each bucket, and the caller's stream waits for each
                       before ``scalecom_reduce`` returns. Tensors made on
                       the side stream are handed to the caller's stream
                       with ``hand_over`` (``record_stream``), so the
                       caching allocator does not reuse their memory while
                       the caller's stream still reads them.
  overlap=False, CPU   the same buckets in the same order on the caller's
                       stream: the synchronous fallback.

Bucketing changes launch order only: the result is bitwise the unbucketed
reduce's. ``resolve_bucket_bytes`` reads $SCALECOM_TORCH_BUCKET_MB at call
time; an explicit spec wins.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.plan import Bucket, plan_buckets

__all__ = ["BUCKET_ENV", "resolve_bucket_bytes", "resolve_buckets", "run_buckets", "hand_over"]

BUCKET_ENV = "SCALECOM_TORCH_BUCKET_MB"


def resolve_bucket_bytes(spec: Any = None, default_bytes: int = 25 << 20) -> Optional[int]:
    """A bucketing spec -> the bucket byte target (None: unbucketed).

    None | "auto"   $SCALECOM_TORCH_BUCKET_MB at call time: unset or <= 0
                    means unbucketed, else the bucket size in MB; a value
                    that is no number raises.
    False           unbucketed.
    True            ``default_bytes`` (ScaleComConfig.bucket_bytes).
    int/float > 0   the bucket size in bytes.
    """
    if spec is False:
        return None
    if spec is True:
        return int(default_bytes)
    if spec is None or spec == "auto":
        env = os.environ.get(BUCKET_ENV, "").strip()
        if not env:
            return None
        try:
            mb = float(env)
        except ValueError:
            raise ValueError(
                f"invalid ${BUCKET_ENV}={env!r}: expected a bucket size in MB "
                f"(a number; values <= 0 disable bucketing)"
            ) from None
        return int(mb * (1 << 20)) if mb > 0 else None
    if isinstance(spec, (int, float)):
        if spec <= 0:
            raise ValueError(
                f"explicit bucket size must be positive bytes, got {spec!r} "
                f"(use buckets=False to disable bucketing)"
            )
        return int(spec)
    raise TypeError(
        f"buckets spec must be None/'auto', bool, a byte count, or a tuple "
        f"of core.plan.Bucket; got {type(spec).__name__}"
    )


def resolve_buckets(spec: Any, cfg, plans) -> Optional[Tuple[Bucket, ...]]:
    """``scalecom_reduce(..., buckets=spec)`` -> a bucket schedule, or None.

    A prebuilt tuple or list of Buckets passes through; anything else goes
    through ``resolve_bucket_bytes`` and ``plan_buckets``.
    """
    if isinstance(spec, (tuple, list)) and spec and all(isinstance(b, Bucket) for b in spec):
        return tuple(spec)
    bucket_bytes = resolve_bucket_bytes(spec, cfg.bucket_bytes)
    if bucket_bytes is None:
        return None
    return plan_buckets(plans, bucket_bytes)


def run_buckets(schedule: Tuple[Bucket, ...], run_bucket: Callable[[Bucket], Any],
                device: Optional[torch.device], overlap: bool = True):
    """Call ``run_bucket(b)`` for each bucket in schedule order.

    With ``overlap`` on a CUDA device the calls run on a side stream (see
    the module docstring) and the caller's stream is returned: the caller
    passes every tensor the buckets made to ``hand_over`` with it. Else the
    calls run on the caller's stream and None is returned.
    """
    if not (overlap and device is not None and device.type == "cuda"):
        for b in schedule:
            run_bucket(b)
        return None
    caller = torch.cuda.current_stream(device)
    side = _side_stream(device.index if device.index is not None else torch.cuda.current_device())
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        for b in schedule:
            run_bucket(b)
            done = torch.cuda.Event()
            done.record(side)
            caller.wait_event(done)
    return caller


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> "torch.cuda.Stream":
    """The one side stream of card ``index``, kept across calls: the caching
    allocator keeps freed memory per stream, so a new stream per call would
    allocate the reduce's working set with cudaMalloc every time."""
    return torch.cuda.Stream(torch.device("cuda", index))


def hand_over(outputs, stream) -> None:
    """``record_stream(stream)`` on every tensor in ``outputs`` (nested
    lists, tuples and dicts), so the allocator keeps their memory until
    ``stream`` is done with them."""
    if isinstance(outputs, torch.Tensor):
        outputs.record_stream(stream)
    elif isinstance(outputs, dict):
        for v in outputs.values():
            hand_over(v, stream)
    elif isinstance(outputs, (list, tuple)):
        for v in outputs:
            hand_over(v, stream)
