"""Architecture registry: resolves ``--arch <id>`` to (ARCH, SMOKE) configs.

Only ``paper-transformer-base`` is ported; the other architectures of the
JAX registry wait for their model families (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCHS", "arch", "smoke"]

_MODULES: Dict[str, str] = {
    "paper-transformer-base": "repro_torch.configs.paper_transformer",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; the port has {list(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def arch(name: str) -> ArchConfig:
    """The full-width configuration."""
    return _module(name).ARCH


def smoke(name: str) -> ArchConfig:
    """The reduced configuration the CPU tests and the default CLI use."""
    return _module(name).SMOKE
