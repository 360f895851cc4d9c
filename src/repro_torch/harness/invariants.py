"""Per-step invariants of the scale & failure scenario harness.

The port of ``repro.harness.invariants``: the same tolerances, bounds and
messages. Three properties, checked on every step of every scenario:

  build-up      nnz(ĝ) / k must stay flat (≤ 1) for shared-index compressors
                (clt_k / true_topk / random_k) at every worker count, and for
                local_topk must stay bounded by the union-average model
                ``analysis.perfmodel.buildup_ratio_model``.
  trajectory    a faulted run's virtual-weight trajectory must stay within
                codec tolerance of the fault-free run: faults perturb the EF
                residues, and error feedback must re-feed (not lose or
                double-count) the perturbed mass.
  comm bytes    the reduce's reported ``comm_bytes_per_worker`` (a Python
                float in the port) must equal the plan's summed
                ``bytes_payload``: the wire-byte rule lives in ``core.plan``.

Checks return ``None`` when satisfied, or a human-readable violation string;
the scenario runner collects them into ``ScenarioResult.violations`` and the
CLI turns any violation into a non-zero exit. Pure Python.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.analysis.perfmodel import buildup_ratio_model

__all__ = [
    "CODEC_TOL",
    "codec_tolerance",
    "check_buildup",
    "check_comm_accounting",
    "check_trajectory",
]

# Relative trajectory-distance tolerance per residue codec: the fault-free
# baseline itself wanders by the codec's quantization noise, and a fault adds
# a bounded, EF-absorbed perturbation on top. The reference's values,
# calibrated on its synthetic stream (unit-scale gradients, worker noise
# sigma ~0.25, one faulted worker).
CODEC_TOL: Dict[str, float] = {
    "fp32": 0.05,
    "bf16": 0.08,
    "fp8": 0.25,
    "fp8_ec": 0.10,
}

# Shared-index compressors ship ONE index set: nnz(ĝ) can never exceed k.
_FLAT_COMPRESSORS = ("clt_k", "true_topk", "random_k")

# Headroom on the local_topk union-average model: the independent-uniform
# approximation is exact for noise-dominated streams up to sampling jitter.
_BUILDUP_MODEL_SLACK = 1.10


def codec_tolerance(residue_dtype: str, scale: float = 1.0) -> float:
    """Trajectory tolerance for one residue codec, scaled per scenario.

    ``scale`` > 1 is for scenarios whose fault legitimately moves the
    trajectory more (e.g. a membership change alters which workers' noise
    enters the mean); the codec floor stays the reference point.
    """
    return CODEC_TOL[residue_dtype] * scale


def check_buildup(
    ratio: float,
    compressor: str,
    workers: int,
    chunk: int,
    topm: int = 1,
) -> Optional[str]:
    """Bound the measured build-up ratio nnz(ĝ)/k for one step.

    Shared-index compressors must hold the flat curve (ratio ≤ 1, up to
    floating-point zeros making it *smaller*); local_topk must stay under
    the modeled union-average ceiling — bounded, even though it grows O(n).
    """
    if compressor in _FLAT_COMPRESSORS:
        bound = 1.0 + 1e-6
        if ratio > bound:
            return (
                f"build-up violation: {compressor} is shared-index (flat "
                f"curve) but measured nnz/k = {ratio:.4f} > 1 at n={workers}"
            )
        return None
    if compressor == "local_topk":
        bound = buildup_ratio_model(workers, chunk, topm) * _BUILDUP_MODEL_SLACK
        if ratio > bound:
            return (
                f"build-up violation: local_topk measured nnz/k = "
                f"{ratio:.4f} exceeds the union-average model bound "
                f"{bound:.4f} at n={workers} (chunk={chunk}, topm={topm})"
            )
        return None
    return None  # "none" / dense: no sparsity to bound


def check_comm_accounting(
    measured_bytes: float, planned_bytes: float, rel_tol: float = 1e-6
) -> Optional[str]:
    """The reduce's reported per-worker bytes must equal the plan's sum.

    ``planned_bytes`` is the summed ``TensorPlan.bytes_payload`` for the
    step's plans (dense fallbacks included at 4·size)."""
    planned = planned_bytes
    if planned == 0 and measured_bytes == 0:
        return None
    if abs(measured_bytes - planned) > rel_tol * max(abs(planned), 1.0):
        return (
            f"comm accounting violation: reduce reported "
            f"{measured_bytes:.1f} B/worker but core.plan bills "
            f"{planned:.1f} B/worker"
        )
    return None


def check_trajectory(
    distance: float, residue_dtype: str, scale: float = 1.0, label: str = ""
) -> Optional[str]:
    """Relative trajectory distance vs the fault-free run, within tolerance."""
    tol = codec_tolerance(residue_dtype, scale)
    if distance > tol:
        where = f" ({label})" if label else ""
        return (
            f"trajectory violation{where}: relative distance to the "
            f"fault-free run {distance:.4f} > codec tolerance {tol:.4f} "
            f"(residue_dtype={residue_dtype}, scale={scale:g})"
        )
    return None
