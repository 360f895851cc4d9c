"""Architecture registry: resolves ``--arch <id>`` to (ARCH, SMOKE) configs.

The port holds the eleven ids of the JAX registry: the paper transformer,
the RMSNorm / SwiGLU dense decoders, the top-k MoE decoders, the RWKV-6 SSM,
the RecurrentGemma hybrid, the Whisper encoder-decoder and the InternVL2
vision-prefixed decoder. An unknown id raises a ``ValueError`` that names them.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCHS", "arch", "smoke"]

_MODULES: Dict[str, str] = {
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
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
