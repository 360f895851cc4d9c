"""Serving: the prefill and decode functions of a model, and the decode
state's sharding specs.

The port of ``repro.training.serve``. ``decode_state_specs`` and
``batch_axes`` are its spec logic, pure Python over shapes and a mesh
layout (``launch.mesh.Mesh``, groups not needed): a spec per leaf, as
``distributed.sharding`` gives parameters theirs, with the reference's
placement:

  * the batch dim over the batch axes (``batch_axes``: "pod" and "data"
    where the mesh has both, else "data"), or "data" alone where those do
    not divide it;
  * the k/v caches' slot dim (C) and ``slot_pos`` over "model" (the
    reference's flash-decode-style split by slot, not by heads);
  * RWKV-6's state ``s`` by heads over "model";
  * a dim that the axes do not divide, or an axis the mesh lacks, stays
    whole (argument shardings never pad), and every other leaf is
    replicated.

A spec entry is a mesh axis name, a tuple of them, or None. The port
serves on one card: nothing here splits a decode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from repro_torch import tree
from repro_torch.device import fp32_accumulation

__all__ = ["batch_axes", "build_serve_fns", "decode_state_specs"]


def _fits(dim: int, mesh, axis) -> bool:
    if mesh is None:
        return False
    axes = axis if isinstance(axis, tuple) else (axis,)
    if any(a not in mesh.axis_names for a in axes):
        return False
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return dim >= size and dim % size == 0  # argument shardings never pad


def batch_axes(mesh):
    """The mesh axes a serving batch dim splits over: ("pod", "data") where
    the mesh has both (an idle pod axis would leave the batch whole across
    pods), else "data" (also without a mesh)."""
    if mesh is None:
        return "data"
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else "data")


def _spec_for_leaf(path: str, shape, mesh) -> Tuple[Any, ...]:
    """One decode-state leaf's spec, by its last dict key and rank."""
    name = path.rsplit("'", 2)[-2] if "'" in path else path
    nd = len(shape)
    ba = batch_axes(mesh)

    def d(i):  # the batch axes, else "data" alone
        if _fits(shape[i], mesh, ba):
            return ba
        return "data" if _fits(shape[i], mesh, "data") else None

    def m(i):
        return "model" if _fits(shape[i], mesh, "model") else None

    if name in ("k", "v"):
        if nd == 5:  # (L, B, C, KV, hd)
            return (None, d(1), m(2), None, None)
        if nd == 4:  # (B, C, KV, hd)
            return (d(0), m(1), None, None)
    if name == "slot_pos":
        return (None, m(1)) if nd == 2 else (m(0),)  # (L, C) or (C,)
    if name == "s":  # RWKV-6's state (L, B, H, hd, hd) or (B, H, hd, hd)
        if nd == 5:
            return (None, d(1), m(2), None, None)
        if nd == 4:
            return (d(0), m(1), None, None)
    if name in ("x_prev", "cm_x_prev"):
        return ((None, d(1)) if nd == 3 else (d(0),)) + (None,) * (nd - 2)
    if name == "h":  # (B, D) or unit-stacked (U, B, D)
        return (None, d(1), None) if nd == 3 else (d(0),) + (None,) * (nd - 1)
    if name == "conv":  # (B, W-1, D) or unit-stacked (U, B, W-1, D)
        return (None, d(1), None, None) if nd == 4 else (d(0),) + (None,) * (nd - 1)
    return (None,) * nd


def decode_state_specs(state_shapes, mesh: Optional[Any]):
    """A spec per leaf of a decode state (tensors, or anything with a
    ``.shape``; ``Model.init_decode_state``'s tree) on ``mesh`` (a layout
    is enough; without one, no leaf splits): the reference's
    ``decode_state_specs``. A host int leaf (``pos``) has the spec ()."""
    flat = tree.flatten_with_path(state_shapes)
    return tree.unflatten(state_shapes, [
        _spec_for_leaf(path, tuple(getattr(leaf, "shape", ())), mesh) for path, leaf in flat])


def build_serve_fns(model, *, seq_len: int) -> Tuple[Callable, Callable]:
    """Returns (prefill_fn, decode_fn):

    prefill_fn(params, batch)             -> (last logits (B, V), decode state)
    decode_fn(params, state, token, pos)  -> (logits (B, V), state)

    The state holds a ``seq_len`` context; ``decode_fn`` writes it in place
    and takes ``pos`` as a Python int. Matrix products accumulate in fp32,
    as training's (``device.fp32_accumulation``).
    """
    fp32_accumulation()

    def prefill_fn(params, batch):
        return model.prefill(params, batch, seq_len)

    def decode_fn(params, state, token, pos: int):
        return model.decode_step(params, state, token, pos)

    return prefill_fn, decode_fn
