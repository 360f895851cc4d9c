"""Logical axes -> mesh axes: the port of ``repro.distributed.sharding``.

Models record every parameter's logical axes (``Model.logical_axes()``);
``specs_for_axes`` turns them into a spec per leaf for a policy:

  tp    tensor parallel: vocab, heads, kv, mlp and experts over "model",
        everything else replicated; data parallelism is the train step's
        worker axis ("data"), not a split of the parameters.
  fsdp  tp plus the "embed" (d_model) dim over "data".
  dp    every parameter replicated.

A spec is a tuple with one entry per dim: the mesh axis the dim is split
over, or None. The reference's divisibility rule holds: a dim that the
axis's size does not divide stays replicated, an axis absent from the mesh
splits nothing, and a leaf uses each mesh axis at most once (its first dim
that names it). ``split_axes`` names the logical axes a mesh axis splits,
``shard_of`` gives a rank's slice of a whole tensor, ``unshard`` gathers
the slices back over the mesh's process groups.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import tensor_parallel

__all__ = ["TP_RULES", "FSDP_RULES", "DP_RULES", "rules_for_policy", "specs_for_axes",
           "split_axes", "split_dims", "shard_of", "unshard"]

Spec = Tuple[Optional[str], ...]

TP_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "experts": "model",
    "embed": None,
    "layers": None,
    "conv": None,
    "state": None,
    None: None,
}

FSDP_RULES = dict(TP_RULES, embed="data")

DP_RULES = {k: None for k in TP_RULES}


def rules_for_policy(policy: str) -> dict:
    if policy == "tp":
        return TP_RULES
    if policy == "fsdp":
        return FSDP_RULES
    if policy == "dp":
        return DP_RULES
    raise ValueError(f"unknown sharding policy {policy!r}")


def _axis_size(mesh, name: Optional[str]) -> int:
    if mesh is None or name is None or name not in mesh.axis_names:
        return 0  # axis absent from this mesh: nothing splits over it
    return mesh.shape[name]


def _spec_for(axes, rules: dict, mesh, shape) -> Spec:
    """One leaf's spec: the reference's ``_spec_for``."""
    entries, used = [], set()
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax, None)
        if mesh_ax is None or mesh_ax in used:
            entries.append(None)
            continue
        size = _axis_size(mesh, mesh_ax)
        if size == 0 or (size > 1 and dim % size != 0):
            entries.append(None)
        else:
            entries.append(mesh_ax)
            used.add(mesh_ax)
    return tuple(entries)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def specs_for_axes(params, axes, policy: str, mesh) -> Any:
    """A spec per leaf of ``params`` (tensors, or anything with a
    ``.shape``) from its logical ``axes``, for ``policy`` on ``mesh`` (a
    ``launch.mesh.Mesh``; a layout is enough)."""
    rules = rules_for_policy(policy)
    flat_axes = dict(tree.flatten_with_path(axes))
    flat = tree.flatten_with_path(params)
    if [p for p, _ in flat] != list(flat_axes) or not all(map(_is_axes, flat_axes.values())):
        raise ValueError("the axes tree must hold a tuple of axis names for each leaf of params")
    return tree.unflatten(params, [_spec_for(flat_axes[path], rules, mesh, tuple(p.shape))
                                   for path, p in flat])


def split_axes(specs, axes, mesh_axis: str = "model") -> frozenset:
    """The logical axes whose dims ``specs`` split over ``mesh_axis``. Raises
    where a logical axis is split in one leaf and whole in another: a pass
    reads the name, not the leaf, to know whether its work is split."""
    flat_axes = dict(tree.flatten_with_path(axes))
    split, whole = {}, {}
    for path, spec in tree.flatten_with_path(specs):
        for ax, entry in zip(flat_axes[path], spec):
            if ax is not None:
                (split if entry == mesh_axis else whole).setdefault(ax, path)
    mixed = sorted(set(split) & set(whole))
    if mixed:
        raise ValueError(f"logical axis {mixed[0]!r} is split over {mesh_axis!r} in "
                         f"{split[mixed[0]]} and whole in {whole[mixed[0]]}")
    return frozenset(split)


def split_dims(spec: Spec):
    """[(dim, mesh axis)] of the dims a spec splits."""
    return [(d, ax) for d, ax in enumerate(spec) if ax is not None]


def shard_of(x: torch.Tensor, spec: Spec, mesh, coords=None) -> torch.Tensor:
    """The slice of the whole tensor ``x`` that the rank at ``coords`` ({axis:
    index}; default the mesh's own) holds under ``spec``: a contiguous copy,
    so that writes into it leave ``x`` as it was."""
    coords = mesh.coords if coords is None else coords
    out = x
    for d, ax in split_dims(spec):
        n = mesh.shape[ax]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split into {n} over {ax!r}")
        step = x.shape[d] // n
        out = out.narrow(d, coords[ax] * step, step)
    return out.clone(memory_format=torch.contiguous_format)


def unshard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's slice ``x``: an all_gather over the
    mesh group of each split dim (the inverse of ``shard_of``; counted in
    ``tensor_parallel.sent``). Every rank of those groups must call it."""
    for d, ax in split_dims(spec):
        x = tensor_parallel.all_gather(x, d, mesh.group(ax))
    return x
