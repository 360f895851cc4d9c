"""Architecture registry: resolves ``--arch <id>`` to (ARCH, SMOKE) configs.

The port holds the paper transformer and the six decoder-only archs of the
JAX registry (the RMSNorm / SwiGLU dense decoders and the top-k MoE
decoders). The reference's other ids (RWKV6, RecurrentGemma, Whisper,
InternVL2) wait for their model families (ROADMAP Queue 1 item 17): asking
for one raises a ``ValueError`` that says so.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCHS", "arch", "smoke"]

_MODULES: Dict[str, str] = {
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "paper-transformer-base": "repro_torch.configs.paper_transformer",
}

# ids of the reference's registry whose model families are not ported yet
_NOT_PORTED = ("rwkv6-3b", "internvl2-26b", "recurrentgemma-2b", "whisper-medium")

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name in _NOT_PORTED:
        raise ValueError(
            f"arch {name!r} is not ported yet (ROADMAP Queue 1 item 17); the port has "
            f"{list(_MODULES)}")
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; the port has {list(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def arch(name: str) -> ArchConfig:
    """The full-width configuration."""
    return _module(name).ARCH


def smoke(name: str) -> ArchConfig:
    """The reduced configuration the CPU tests and the default CLI use."""
    return _module(name).SMOKE
