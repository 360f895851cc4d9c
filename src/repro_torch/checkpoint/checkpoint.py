"""Checkpoints of a tree of tensors: flat-key npz payload + json manifest.

The port of ``repro.checkpoint``, in its format, so a checkpoint written by
either package restores in the other:

  * ``ckpt_<step:08d>.npz``, written with ``np.savez_compressed``: one entry
    per leaf under the ``jax.tree_util.keystr`` path the reference gives
    it. Dicts flatten in sorted key order (``['blocks']['attn_wq']``), and
    a dataclass (``TrainState``, ``ScaleComState``) by field position
    (``[<flat index 2>]``), as the reference flattens those classes, which
    it registers as pytree nodes without keys.
  * ``manifest.json``: ``step``, ``dtypes`` (each leaf's numpy dtype name)
    and ``file``.

bfloat16 and float8_e4m3fn leaves, which npz cannot hold, are stored as
their raw uint16 / uint8 bits beside their dtype tag. A host integer leaf
(the step, the residues' ``t``, adam's ``count``) is stored as an int32 0-d
array, as the reference holds it, and restores as an int.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step"]

_MANIFEST = "manifest.json"
# dtype tag -> (numpy dtype of the stored bits, torch dtype they view as)
_RAW = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}
_TORCH_BITS = {np.uint16: torch.int16, np.uint8: torch.uint8}
_SIGNED = {np.uint16: np.int16, np.uint8: np.uint8}


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """[(key string, child)] of an inner node in the reference's leaf order,
    or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node):
        return [(f"[<flat index {i}>]", getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids for item in _flatten(child, prefix + key)]


def _unflatten(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    kids = _children(like)
    if kids is None:
        return leaves[prefix]
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, f"{prefix}[{k!r}]") for k in like}
    return dataclasses.replace(like, **{f.name: _unflatten(child, leaves, prefix + key)
                                        for f, (key, child) in
                                        zip(dataclasses.fields(like), kids)})


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, dtype tag) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for tag, (bits, dtype) in _RAW.items():
            if t.dtype == dtype:
                return t.view(_TORCH_BITS[bits]).numpy().view(bits), tag
        a = t.numpy()
        return a, str(a.dtype)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(v: np.ndarray, tag: str, like: Any, key: str) -> Any:
    """The stored array ``v`` (dtype tag ``tag``) as a leaf of ``like``'s kind."""
    want_shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if tuple(v.shape) != want_shape:
        raise ValueError(f"checkpoint leaf {key}: shape {tuple(v.shape)}, want {want_shape}")
    if isinstance(like, torch.Tensor):
        if tag in _RAW:
            bits, dtype = _RAW[tag]
            t = torch.from_numpy(np.ascontiguousarray(v).view(bits).view(_SIGNED[bits]))
            t = t.view(dtype)
        else:
            t = torch.from_numpy(np.ascontiguousarray(v))
        return t.to(like.device)
    if isinstance(like, int):
        return int(v)
    return v


def save(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``directory/ckpt_<step>.npz`` and point the manifest at it."""
    os.makedirs(directory, exist_ok=True)
    payload, dtypes = {}, {}
    for key, leaf in _flatten(tree):
        payload[key.replace("/", "\\")], dtypes[key] = _to_numpy(leaf)
    step = int(step)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez_compressed(path, **payload)
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump({"step": step, "dtypes": dtypes, "file": path}, f)
    return path


def restore(directory: str, like: Any, step: Optional[int] = None) -> Any:
    """A tree of ``like``'s structure holding the checkpoint's leaves: tensor
    leaves on ``like``'s devices in the saved dtype, integer leaves as ints.
    ``step`` defaults to the manifest's (the latest save)."""
    if step is None:
        step = latest_step(directory)
    with open(os.path.join(directory, _MANIFEST)) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as z:
        data = {k.replace("\\", "/"): z[k] for k in z.files}
    leaves = {}
    for key, leaf in _flatten(like):
        if key not in data:
            raise KeyError(f"checkpoint has no leaf {key}")
        leaves[key] = _from_numpy(data[key], dtypes[key], leaf, key)
    return _unflatten(like, leaves)


def latest_step(directory: str) -> int:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)["step"]
