"""Carry parameters, decode states and ScaleCom residues across from the JAX
package, and back.

The tests make both packages compute the same thing by initializing on the
JAX side and converting: the trees hold the same key strings and stacked
shapes on both sides, so conversion is leafwise. Inputs are trees of arrays
that ``numpy.asarray`` accepts (numpy or JAX arrays); nothing here imports
JAX. The lossy residue codecs' bf16 and float8_e4m3fn leaves reach numpy as
``ml_dtypes`` dtypes, which torch does not take: they move across as their
raw bits (``residue_bits`` gives those bits back, for bitwise comparisons);
bf16 parameter leaves carry across the same way.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.state import ScaleComState
from repro_torch.device import resolve_device

__all__ = ["params_from_jax", "decode_state_from_jax", "decode_state_to_numpy",
           "state_from_jax", "residue_bits"]

# numpy dtype name -> (its bits as a numpy dtype, the torch dtype they view as)
_BY_BITS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}
_UINT = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_NP_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name in _BY_BITS:
        bits, dtype = _BY_BITS[a.dtype.name]
        return torch.tensor(a.view(bits), device=device).view(dtype)
    return torch.tensor(a, device=device)


def params_from_jax(params, device: Union[str, torch.device] = "cuda"):
    """A nested dict of arrays -> the same nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return tree.tree_map(lambda x: _tensor(x, dev), params)


def decode_state_from_jax(state, device: Union[str, torch.device] = "cuda"):
    """A ``Model.prefill`` / ``decode_step`` state of the JAX package (nested
    dicts, the hybrid's ``tail`` a list) -> the port's, each leaf a tensor of
    its own on ``device`` (``slot_pos`` stays int32)."""
    return params_from_jax(state, device)


def decode_state_to_numpy(state):
    """The port's decode state -> the same tree of numpy arrays, for comparison
    with the JAX package's (``jax.tree_util.keystr`` paths equal ``tree``'s).
    numpy has no bfloat16: a bf16 leaf (a cache under bf16 compute) comes
    back widened to float32, which is exact."""
    def to_numpy(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    return tree.tree_map(to_numpy, state)


def state_from_jax(state, device: Union[str, torch.device] = "cuda") -> ScaleComState:
    """A ``repro.core.state.ScaleComState`` (any codec) -> the port's."""
    dev = resolve_device(device)
    residues = {
        path: {name: _tensor(leaf, dev) for name, leaf in enc.items()}
        for path, enc in state.residues.items()
    }
    return ScaleComState(residues=residues, t=int(np.asarray(state.t)))


def residue_bits(state: ScaleComState) -> Dict[str, Dict[str, np.ndarray]]:
    """Every residue leaf as a numpy array of unsigned ints holding its bits."""
    def bits(t: torch.Tensor) -> np.ndarray:
        n = t.element_size()
        return t.detach().cpu().view(_UINT[n]).numpy().view(_NP_UINT[n])

    return {path: {name: bits(v) for name, v in enc.items()}
            for path, enc in state.residues.items()}
