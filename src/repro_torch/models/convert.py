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

For the tensor-parallel step (``build_train_step(mesh=...)``):
``shards_from_jax`` gives a rank its slice of each parameter (under the
specs of ``distributed.sharding.specs_for_axes``), ``train_state_shard_from_jax``
its share of a worker-stacked ``TrainState`` (any residue codec, ``groups``),
``train_state_from_shard`` the share back as the logical tree and the rank's
residue row (or every worker's: the whole stacked state), and
``gather_shards`` puts the ranks' slices back together into the logical
tree; under either sharded policy, ``tp`` or ``fsdp``.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.state import ScaleComState
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding

__all__ = ["params_from_jax", "decode_state_from_jax", "decode_state_to_numpy",
           "state_from_jax", "residue_bits", "shards_from_jax", "train_state_shard_from_jax",
           "train_state_from_shard", "gather_shards"]

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


def _slice(a: np.ndarray, spec, mesh) -> np.ndarray:
    for d, ax in sharding.split_dims(spec):
        step = a.shape[d] // mesh.shape[ax]
        a = np.take(a, range(mesh.index(ax) * step, (mesh.index(ax) + 1) * step), axis=d)
    return a


def shards_from_jax(params, specs, mesh, device: Union[str, torch.device] = "cuda"):
    """A nested dict of arrays -> this rank's slice of each (``specs``: the
    same tree of sharding specs) as tensors on ``device``: only the slice
    moves to the device."""
    dev = resolve_device(device)
    by_path = dict(tree.flatten_with_path(specs))
    flat = tree.flatten_with_path(params)
    return tree.unflatten(params, [_tensor(_slice(np.asarray(x), by_path[p], mesh), dev)
                                   for p, x in flat])


def train_state_shard_from_jax(state, axes, mesh, device: Union[str, torch.device] = "cuda",
                               groups=None, policy: str = "tp"):
    """A worker-stacked ``repro.training.TrainState`` (params, an optimizer
    state of params-like trees, residues in any codec, G rows of them with
    ``groups=G``) -> this rank's share for the sharded step under
    ``policy`` ("tp", or "fsdp" on a (pod, data, model) grid), as
    ``training.shard_train_state(mesh=..., axes=..., groups=..., policy=...)``
    gives it from the port's own."""
    from repro_torch.training.train_step import TrainState, shard_train_state

    dev = resolve_device(device)
    whole = TrainState(params_from_jax(state.params, "cpu"),
                       {k: params_from_jax(v, "cpu") if isinstance(v, dict) else int(np.asarray(v))
                        for k, v in state.opt_state.items()},
                       state_from_jax(state.sc_state, "cpu"), int(np.asarray(state.step)))
    mine = shard_train_state(whole, mesh=mesh, axes=axes, groups=groups, policy=policy)
    move = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x  # noqa: E731
    return TrainState(tree.tree_map(move, mine.params), tree.tree_map(move, mine.opt_state),
                      ScaleComState({p: {k: v.to(dev) for k, v in e.items()}
                                     for p, e in mine.sc_state.residues.items()},
                                    mine.sc_state.t), mine.step)


_WORKERS = {"tp": ("data", ("model",)), "fsdp": ("pod", ("data", "model"))}


def _worker_rows(enc: Dict[str, torch.Tensor], group, rows: int) -> Dict[str, torch.Tensor]:
    """Every worker rank's (1, ...) encoding -> the ``rows`` rows of the
    stacked one (with fewer rows than ranks, the ranks of a group hold
    replicas of its row: each group's first rank's), one all-gather a field
    (code bits widened to int32: gloo gathers no 8- or 16-bit integers)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = {}
    for field, v in enc.items():
        bits = v.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[v.element_size()])
        parts = [torch.empty_like(bits, dtype=torch.int32) for _ in range(n)]
        dist.all_gather(parts, bits.to(torch.int32).contiguous(), group=group)
        out[field] = torch.cat(parts[::n // rows]).to(bits.dtype).view(v.dtype)
    return out


def train_state_from_shard(local, specs, mesh, policy: str = "tp", *, every_row: bool = False,
                           groups=None):
    """The inverse of ``train_state_shard_from_jax`` on this rank: its share
    -> the logical parameters and optimizer state (``gather_shards``) and
    its residue row (its worker's, or its group's) in the stacked codec's
    fields and (1, *storage) shapes (``distributed.slices.join``; flat fp8
    padded with zero codes; each residue's layout read off its storage,
    ``slices.infer_layout``), for ``residue_bits`` to compare with the
    reference's row. With ``every_row`` the residues hold every worker's
    row, (n, *storage) (with ``groups=G``, the G groups' rows), gathered
    over the workers' group: the whole stacked state, on every rank.
    Collective over the mesh groups that split a tensor; ``specs``: the
    parameters' specs under ``policy`` (``sharding.specs_for_axes``)."""
    from repro_torch.distributed import slices
    from repro_torch.training.train_step import TrainState

    worker, split = _WORKERS[policy]
    params = gather_shards(local.params, specs, mesh)
    opt_state = {k: gather_shards(v, specs, mesh) if isinstance(v, dict) else v
                 for k, v in local.opt_state.items()}
    by_path = dict(tree.flatten_with_path(specs))
    shapes = {p: tuple(x.shape) for p, x in tree.flatten_with_path(params)}
    pieces = slices.grid_pieces(mesh, split)
    rows = mesh.shape[worker] if groups is None else groups
    residues = {}
    for path, enc in local.sc_state.residues.items():
        sl = slices.block_of(shapes[path], by_path[path], mesh, split)
        residues[path] = slices.join(slices.codec_name(enc), enc, sl,
                                     slices.infer_layout(enc, shapes[path]), pieces)
        if every_row:
            residues[path] = _worker_rows(residues[path], mesh.group(worker), rows)
    return TrainState(params, opt_state, ScaleComState(residues, local.sc_state.t), local.step)


def gather_shards(local, specs, mesh):
    """This rank's slices -> the logical tree, on every rank of the mesh
    groups that split it (``distributed.sharding.unshard``, collective)."""
    by_path = dict(tree.flatten_with_path(specs))
    return tree.unflatten(local, [sharding.unshard(x, by_path[p], mesh)
                                  for p, x in tree.flatten_with_path(local)])
