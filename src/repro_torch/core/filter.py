"""Low-pass filtered local-memory (error-feedback residue) update, paper Eq. (5).

    m^{t+1} = (1-beta) m^t + beta (m^t + g^t - ghat^t) = m^t + beta (g^t - ghat^t)

beta = 1 is classic error feedback; beta ~ 0.1 is the paper's large-batch
setting. ``ghat`` is the worker's own compressed tensor (the entries it
contributed), so selected positions decay to (1-beta) m and the rest
integrate beta * g.
"""

from __future__ import annotations

import math

import torch

__all__ = ["lowpass_update", "beta_band"]


def lowpass_update(
    m: torch.Tensor, g: torch.Tensor, ghat_own: torch.Tensor, beta: float
) -> torch.Tensor:
    """One low-pass-filtered residue update (Eq. 5), each op rounded separately."""
    return m + beta * (g - ghat_own)


def beta_band(gamma: float) -> tuple[float, float]:
    """Admissible (lo, hi) band for the discounting factor beta given the
    contraction coefficient gamma (Theorem 1, Eq. 9)."""
    s = math.sqrt(max(0.0, 1.0 - gamma * gamma))
    lo = (1.0 + gamma - s) / (2.0 * (1.0 + gamma))
    hi = (1.0 + gamma + s) / (2.0 * (1.0 + gamma))
    return lo, hi
