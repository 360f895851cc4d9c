"""Learning-rate schedules of the paper's recipes (Appendix E): the port of
``repro.optim.schedule``.

  * linear warmup -> constant / step decay   (vision: x0.1 at epoch marks)
  * inverse-sqrt with warmup                 (Transformer / WMT14)
  * exponential per-epoch decay              (MobileNetV2: 0.98/epoch)
  * cosine                                   (modern default)

A schedule is a ``step (int) -> lr (float)`` callable on the host: the step
counter lives on the host, so reading the rate costs no device round trip.
The reference computes in float32 on the device; these compute in Python
floats, so the two agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = [
    "constant",
    "linear_warmup",
    "step_decay",
    "inverse_sqrt",
    "exponential_decay",
    "cosine",
    "chain_warmup",
]

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def linear_warmup(base: Schedule, warmup_steps: int, start_lr: float = 0.0) -> Schedule:
    """Linear ramp from ``start_lr`` at step 0 to ``base(warmup_steps)``, then ``base``."""

    def f(step: int) -> float:
        if step >= warmup_steps:
            return base(step)
        frac = min(step / max(warmup_steps, 1), 1.0)
        return start_lr + frac * (base(warmup_steps) - start_lr)

    return f


def step_decay(lr: float, boundaries: Sequence[int], factor: float = 0.1) -> Schedule:
    """``lr * factor**n``, n the boundaries at or below the step."""
    bs = tuple(boundaries)
    return lambda step: lr * factor ** sum(step >= b for b in bs)


def inverse_sqrt(peak_lr: float, warmup_steps: int) -> Schedule:
    """Vaswani-style: peak * min(step^-0.5, step * warmup^-1.5) * warmup^0.5 (step >= 1)."""

    def f(step: int) -> float:
        s = max(float(step), 1.0)
        return peak_lr * min(s ** -0.5, s * warmup_steps ** -1.5) * warmup_steps ** 0.5

    return f


def exponential_decay(lr: float, steps_per_epoch: int, rate: float = 0.98) -> Schedule:
    """``lr * rate**(step / steps_per_epoch)``: a fraction of an epoch decays too."""
    return lambda step: lr * rate ** (step / steps_per_epoch)


def cosine(lr: float, total_steps: int, final_frac: float = 0.0) -> Schedule:
    """Half a cosine from ``lr`` at step 0 to ``final_frac * lr`` at ``total_steps``, then flat."""

    def f(step: int) -> float:
        frac = min(max(step / total_steps, 0.0), 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1.0 + math.cos(math.pi * frac)))

    return f


def chain_warmup(lr: float, warmup_steps: int, total_steps: int, kind: str = "cosine") -> Schedule:
    """A linear warm-up into ``cosine`` or ``constant``; any other ``kind`` raises."""
    if kind == "cosine":
        base = cosine(lr, total_steps)
    elif kind == "constant":
        base = constant(lr)
    else:
        raise ValueError(f"chain_warmup kind must be 'cosine' or 'constant', got {kind!r}")
    return linear_warmup(base, warmup_steps)
