"""Similarity and contraction diagnostics of the paper's analysis.

The port of ``repro.core.metrics``, on worker-stacked flat tensors (n, size):

  * pairwise cosine distance between workers' residues        (Fig. 2a/2c)
  * normalized Hamming distance between top-k index sets      (Fig. 3, Lemma 1)
  * contraction coefficient gamma                             (Eq. 7/8)
  * energy of the true top-k caught by a local top-k          (Fig. 2b/2d)
  * Spearman rank correlation                                 (Appendix A)

With ``ScaleComConfig(telemetry=True, metrics_every=N)`` the reduce samples
``residue_similarity_report`` per tensor every N steps as taps. Top-k breaks
ties toward the lower index (``compressors._top_k``, as ``jax.lax.top_k``)
and ranks use a stable sort (as ``jnp.argsort``). Every result is a 0-d
float32 tensor on the input's device.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.compressors import _top_k

__all__ = [
    "cosine_distance",
    "pairwise_cosine_distance",
    "hamming_distance_topk",
    "contraction_gamma",
    "topk_overlap",
    "spearman_rho",
    "residue_similarity_report",
]


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 1e-30)


def cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cos(x, y) for flat vectors (paper footnote 1)."""
    return 1.0 - torch.dot(x, y) / _clamp(torch.linalg.norm(x) * torch.linalg.norm(y))


def pairwise_cosine_distance(stacked: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine distance over the worker axis of (n, size)."""
    n = stacked.shape[0]
    u = stacked / _clamp(torch.linalg.norm(stacked, dim=1, keepdim=True))
    cos = u @ u.T
    return 1.0 - (torch.sum(cos) - torch.trace(cos)) / (n * (n - 1))


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    idx = _top_k(torch.abs(x), k).long()
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device).scatter_(0, idx, True)


def hamming_distance_topk(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """d/k in [0, 1]: the share of |x|'s top-k offsets not in |y|'s (H = 2d, Eq. 6)."""
    overlap = torch.sum(_topk_mask(x, k) & _topk_mask(y, k)).to(torch.float32)
    return (k - overlap) / k


def contraction_gamma(y: torch.Tensor, y_compressed: torch.Tensor) -> torch.Tensor:
    """gamma = ||y - comp(y)||^2 / ||y||^2 (Lemma 1)."""
    return torch.sum((y - y_compressed) ** 2) / _clamp(torch.sum(y * y))


def topk_overlap(local: torch.Tensor, global_: torch.Tensor, k: int) -> torch.Tensor:
    """Share of the true top-k's energy that the local top-k offsets catch."""
    energy = torch.abs(global_) ** 2
    g_mask = _topk_mask(global_, k)
    captured = torch.sum(energy * (_topk_mask(local, k) & g_mask))
    return captured / _clamp(torch.sum(energy * g_mask))


def _rank(x: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(x, stable=True)
    ranks = torch.arange(x.shape[0], device=x.device)
    return torch.empty_like(order).scatter_(0, order, ranks).to(torch.float32)


def spearman_rho(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation of |x| and |y| (Appendix A reports 0.657)."""
    rx, ry = _rank(torch.abs(x)), _rank(torch.abs(y))
    rx = rx - torch.mean(rx)
    ry = ry - torch.mean(ry)
    return torch.dot(rx, ry) / _clamp(torch.linalg.norm(rx) * torch.linalg.norm(ry))


def residue_similarity_report(stacked_ef: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """The paper's similarity diagnostics for one tensor's (n, size) EF gradients."""
    y = torch.mean(stacked_ef, dim=0)
    return {
        "pairwise_cosine_distance": pairwise_cosine_distance(stacked_ef),
        "hamming_d_over_k": hamming_distance_topk(stacked_ef[0], y, k),
        "topk_energy_overlap": topk_overlap(stacked_ef[0], y, k),
        "spearman_rho": spearman_rho(stacked_ef[0], y),
    }
