"""Process grids: the port of ``repro.launch.mesh``.

The reference lays its devices out as a named ``jax.sharding.Mesh``. Here a
``Mesh`` names the same axes over the ranks of an initialised default
``torch.distributed`` group: the world's ranks fill the grid in row-major
order, as a JAX mesh's devices do, and each rank holds its coordinate on
every axis and one process group per axis, the ranks that differ from it on
that axis alone (its "line"): ``mesh.group("data")`` is the data group of the
rank's model index, ``mesh.group("model")`` the model group of its data
index. A grid of three axes also holds one group per pair of axes, the
ranks that share the rank's index on the third (its "plane"):
``mesh.group(("pod", "data"))`` on a (pod, data, model) grid is the ranks
of its model index, ``mesh.group(("data", "model"))`` its pod's ranks,
each plane's ranks in row-major order.

A ``Mesh`` without groups is a layout only (axis names and sizes): what
``distributed.sharding.specs_for_axes`` reads, as the reference's
``_spec_for`` reads only ``axis_names`` and ``shape``. ``make_production_mesh``
gives the reference's production layouts that way. The reference's ``HW``
constants describe a TPU and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, and on a rank of the grid its coordinates and
    the process group of each axis line it lies on."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Optional[Dict[str, int]] = None
    groups: Optional[Dict[str, object]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} for shape {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axis):
        """This rank's process group along ``axis``, or with a pair of axis
        names (in axis order) its plane's."""
        if self.groups is None:
            raise ValueError(f"mesh {self.shape} is a layout only: it has no process groups")
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if axis not in self.groups:
            raise ValueError(f"mesh {self.shape} has no group of {axis!r}")
        return self.groups[axis]

    def lines(self, axis: str) -> Tuple[Tuple[int, ...], ...]:
        """Every line along ``axis`` as the global ranks on it (the grid over
        the world's first ranks, row-major), in the order ``make_test_mesh``
        makes their groups: the same on every rank."""
        return _lines(self.sizes, self.axis_names.index(axis))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        if self.coords is None:
            raise ValueError(f"mesh {self.shape} is a layout only: it has no coordinates")
        return self.coords[axis]


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _rank(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _planes(shape: Sequence[int], a: int, b: int) -> Tuple[Tuple[int, ...], ...]:
    """The ranks of each plane of axes ``a`` < ``b`` of the grid ``shape``
    (row-major within a plane)."""
    others = [s for i, s in enumerate(shape) if i not in (a, b)]
    out = []
    for rest in range(math.prod(others)):
        fixed = list(_coords(rest, others))
        ranks = []
        for i in range(shape[a]):
            for j in range(shape[b]):
                c = fixed[:a] + [i] + fixed[a:]
                c = c[:b] + [j] + c[b:]
                ranks.append(_rank(c, shape))
        out.append(tuple(ranks))
    return tuple(out)


def _lines(shape: Sequence[int], a: int) -> Tuple[Tuple[int, ...], ...]:
    """The ranks of each line along axis ``a`` of the grid ``shape``."""
    others = [s for i, s in enumerate(shape) if i != a]
    out = []
    for rest in range(math.prod(others)):
        fixed = list(_coords(rest, others))
        out.append(tuple(_rank(fixed[:a] + [i] + fixed[a:], shape) for i in range(shape[a])))
    return tuple(out)


def make_test_mesh(shape=(4, 2), axes=("data", "model"), *,
                   subset: bool = False) -> Optional[Mesh]:
    """The grid ``shape`` named ``axes`` over the default group's ranks
    (row-major, as the reference's devices), with this rank's coordinates
    and one ``dist.new_group`` per axis line (and, on a grid of three axes,
    per plane of each pair of axes, after the lines). Every rank must call
    it, in the same order as its other ``new_group`` calls: each line's and
    plane's group is made on every rank. With ``subset``, the grid takes the world's first
    ranks and the others get None."""
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    world = math.prod(shape)
    if world > dist.get_world_size() or (world < dist.get_world_size() and not subset):
        raise ValueError(f"a {shape} grid needs {world} ranks, the world has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    me = _coords(rank, shape) if rank < world else None
    groups = {}
    for a, name in enumerate(axes):
        for line in _lines(shape, a):
            group = dist.new_group(list(line))
            if rank in line:
                groups[name] = group
    if len(axes) >= 3:
        for a in range(len(axes)):
            for b in range(a + 1, len(axes)):
                for plane in _planes(shape, a, b):
                    group = dist.new_group(list(plane))
                    if rank in plane:
                        groups[(axes[a], axes[b])] = group
    return None if me is None else Mesh(axes, shape, dict(zip(axes, me)), groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout: (16 data, 16 model), or with
    ``multi_pod`` (2 pod, 16 data, 16 model). A layout only: no process
    group is made."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))
