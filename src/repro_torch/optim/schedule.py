"""Learning-rate schedules: the port of ``repro.optim.schedule``'s ``constant``
and ``linear_warmup``, the two the training CLI uses.

A schedule is a ``step (int) -> lr (float)`` callable on the host: the step
counter lives on the host, so reading the rate costs no device round trip.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["constant", "linear_warmup"]

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
