"""Provenance stamps for every exported record: what code ran, where.

The port of ``repro.obs.provenance``:

  ``provenance()``            git sha + torch, CUDA and Python versions +
                              the device: the full run header;
  ``device_tags(backend)``    the per-record subset: the device kind, the
                              card's name and power limit as ``nvidia-smi``
                              prints them (a card below its 700 W limit
                              runs slower under load), and, with a kernel
                              backend name, the resolved backend and fused
                              decision.

``backend`` and ``fused`` take the place of the reference's ``jax_backend``
and ``interpret`` tags: the port has no interpret mode, and which path ran
is the backend ("cuda": the hand-written kernels, "torch": their plain
versions) and whether the fused reduce was on. Nothing here raises for a
missing card or tool: off the card those fields are None. torch is imported
inside the functions, so ``repro_torch.obs`` (and its report CLI) imports
without it.
"""

from __future__ import annotations

import platform
import subprocess
from typing import Any, Dict, Optional, Tuple

__all__ = ["git_sha", "device_tags", "provenance"]


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Short commit sha of the working tree, or None outside a git checkout
    (installed wheels, tarball exports). Never raises."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=cwd,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _card() -> Tuple[Optional[str], Optional[str]]:
    """(name, power limit) of the first card as ``nvidia-smi`` prints them,
    or (None, None) without one. Never raises."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None, None
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return None, None
    name, _, limit = lines[0].partition(",")
    return name.strip(), limit.strip() or None


def device_tags(backend_name: Optional[str] = None) -> Dict[str, Any]:
    """Per-record device tags: the device kind (the card's name, or "cpu"),
    the card's name and power limit from ``nvidia-smi`` and, when a kernel
    backend name is given, the backend it resolves to ("auto" resolves for
    the card if there is one) and the resolved fused-reduce decision
    ($SCALECOM_TORCH_FUSED under "auto")."""
    import torch

    on_card = torch.cuda.is_available()
    card_name, power_limit = _card() if on_card else (None, None)
    tags: Dict[str, Any] = {
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "card_name": card_name,
        "power_limit": power_limit,
    }
    if backend_name is not None:
        from repro_torch.backends import resolve_backend, resolve_fused

        tags["backend"] = resolve_backend(backend_name, "cuda" if on_card else "cpu").name
        tags["fused"] = resolve_fused("auto")
    return tags


def provenance(backend_name: Optional[str] = None) -> Dict[str, Any]:
    """The full run header stamped on every event log."""
    import torch

    return {
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": platform.python_version(),
        **device_tags(backend_name),
    }
