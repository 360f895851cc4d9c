"""The data axis of the ``fsdp`` step: a parameter's "embed" dim split over
the pod's data ranks, gathered for the pass.

The reference's ``fsdp`` policy (``FSDP_RULES``: ``tp`` plus "embed" over
"data") leaves the gather to GSPMD. Here it is written out, as
``tensor_parallel`` writes out the model axis:

  gather_from_data   the data ranks' blocks concatenated along a dim
                     forward (an all-gather); the cotangent reduce-scattered
                     backward, summed over the ranks, each keeping its own
                     block's rows: the gradient of the sum of the ranks'
                     losses with respect to the rank's block.
  copy_to_data       identity forward; the cotangent all-reduced (summed)
                     backward: a leaf with no dim cut over "data" (held
                     alike by the data ranks) gets the same sum.

Both directions are ``torch.autograd.Function``s with a ``setup_context``
and a ``vmap`` rule whose backward calls the other, so they run under plain
autograd and under ``torch.func.grad`` and ``vmap`` (the batched per-worker
pass). ``gather_params`` gathers every leaf that a spec cuts over "data",
whole leaves at once, before the pass, and copies the others: the pass
then sees the ``tp`` slices, and each leaf's gradient is the sum over the
data ranks. Their bytes and calls count in ``tensor_parallel.sent`` and
``calls`` under ``"data_all_gather"``, ``"data_reduce_scatter"`` and
``"data_all_reduce"``, apart from the model axis's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.distributed import tensor_parallel

__all__ = ["copy_to_data", "gather_from_data", "gather_params", "reduce_scatter"]


def _count(op: str, x: torch.Tensor) -> None:
    tensor_parallel.sent[op] += x.numel() * x.element_size()
    tensor_parallel.calls[op] += 1


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    _count("data_all_gather", x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's run of ``x`` along ``dim`` (``dim`` in equal runs, one a
    rank in rank order), summed over the group's ranks (no autograd)."""
    n = dist.get_world_size(group)
    width = x.shape[dim] // n
    ins = [x.narrow(dim, j * width, width).contiguous() for j in range(n)]
    out = torch.empty_like(ins[0])
    _count("data_reduce_scatter", x)  # the whole input, in one call
    dist.reduce_scatter(out, ins, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count("data_all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _batched(x: torch.Tensor, bdim: Optional[int]) -> torch.Tensor:
    return x if bdim is None or bdim == 0 else x.movedim(bdim, 0)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return _all_gather(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.group = inputs

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.dim, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        bdim = in_dims[0]
        if bdim is None:
            return _Gather.apply(x, dim, group), None
        return _Gather.apply(_batched(x, bdim), dim % (x.dim() - 1) + 1, group), 0


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return reduce_scatter(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.group = inputs

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        bdim = in_dims[0]
        if bdim is None:
            return _Scatter.apply(x, dim, group), None
        return _Scatter.apply(_batched(x, bdim), dim % (x.dim() - 1) + 1, group), 0


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):  # the adjoint of a sum over the group is its sum
        return _Sum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Sum.apply(x, group), in_dims[0]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Copy.apply(x, group), in_dims[0]


def gather_from_data(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


def copy_to_data(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def gather_params(params, specs, group):
    """Each leaf of ``params`` (this rank's blocks; ``specs`` their specs in
    leaf order) with a dim cut over "data" gathered along it over ``group``
    (the pod's data ranks), every other leaf copied to them: the pass's
    parameters, whose gradients come back summed over the group."""
    out = []
    for p, spec in zip(tree.leaves(params), specs):
        dim = next((d for d, ax in enumerate(spec) if ax == "data"), None)
        out.append(copy_to_data(p, group) if dim is None else gather_from_data(p, dim, group))
    return tree.unflatten(params, out)
