"""Carry parameters and ScaleCom residues across from the JAX package.

The tests make both packages compute the same thing by initializing on the
JAX side and converting: the trees hold the same key strings and stacked
shapes on both sides, so conversion is leafwise. Inputs are trees of arrays
that ``numpy.asarray`` accepts (numpy or JAX arrays); nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.state import ScaleComState
from repro_torch.device import resolve_device

__all__ = ["params_from_jax", "state_from_jax"]


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)


def params_from_jax(params, device: Union[str, torch.device] = "cuda"):
    """A nested dict of arrays -> the same nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return tree.tree_map(lambda x: _tensor(x, dev), params)


def state_from_jax(state, device: Union[str, torch.device] = "cuda") -> ScaleComState:
    """A ``repro.core.state.ScaleComState`` (fp32 residues) -> the port's."""
    dev = resolve_device(device)
    residues = {
        path: {name: _tensor(leaf, dev) for name, leaf in enc.items()}
        for path, enc in state.residues.items()
    }
    return ScaleComState(residues=residues, t=int(np.asarray(state.t)))
