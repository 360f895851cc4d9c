"""The model axis of the tensor-parallel step: the collectives that GSPMD
inserts for the reference's ``tp`` policy, written out.

Each operator is a ``torch.autograd.Function`` with a ``setup_context`` and
a ``vmap`` rule, so it runs under plain autograd, under ``torch.func.grad``
and ``vmap`` (the batched per-worker pass) and inside ``models.common.remat``
(whose backward replays the forward: every rank of the model group issues
the same collectives in the same order, forward and backward alike). A
backward that needs a collective calls another of these operators, so it
too runs under the transforms.

  copy_to_model      identity forward; the cotangent all-reduced (summed)
                     backward. In front of a column-parallel product: each
                     rank's input cotangent holds its own columns' part.
  reduce_from_model  all-reduce (sum) forward; identity backward. After a
                     row-parallel product: each rank holds a partial sum.
  gather_from_model  the ranks' slices concatenated along a dim forward; the
                     cotangent all-reduced and sliced backward. For an
                     activation every rank reads whole (attention's K and V
                     where a rank holds part of a head).
  max_over_model     all-reduce (max), no gradient (the cross-entropy's
                     shift).

``vocab_embed`` and ``vocab_xent`` are the vocabulary-parallel embedding
lookup and cross-entropy built from them. A ``ModelAxis`` carries the model
group and the logical axes that the layout splits over it; ``Model.loss``
takes it as ``tp=`` and hands it to each layer, which splits its work where
``tp.over(<logical axis>)`` says so. ``sent`` counts the bytes this process
has put into model-axis collectives and ``calls`` the collectives, by
operation: these operators', and the tensor-parallel reduce's (a
``ring.Collective`` of kind "model", one call per packed call; under
``fsdp`` its gathers run over the pod's (data, model) plane and count here
too). The ``fsdp`` step's data axis (``distributed.fsdp``: the parameters'
gather and the gradients' reduce-scatter, and the all-reduce of a leaf's
gradient that no dim cuts over "data") counts under keys of its own,
``"data_all_gather"``, ``"data_reduce_scatter"`` and ``"data_all_reduce"``;
``MODEL_OPS`` names the model axis's.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional

import torch
import torch.distributed as dist

__all__ = ["ModelAxis", "sent", "calls", "reset_sent", "all_reduce", "all_gather",
           "copy_to_model", "reduce_from_model", "gather_from_model", "gather_replicated",
           "max_over_model",
           "vocab_embed", "vocab_xent"]

sent = {"all_reduce": 0, "all_gather": 0, "data_all_gather": 0, "data_reduce_scatter": 0,
        "data_all_reduce": 0}
calls = dict(sent)
MODEL_OPS = ("all_reduce", "all_gather")  # the model axis's keys; the others the fsdp data axis's


def reset_sent() -> None:
    """Set every count of ``sent`` and ``calls`` to 0."""
    for d in (sent, calls):
        for k in d:
            d[k] = 0


def _count(op: str, x: torch.Tensor) -> None:
    sent[op] += x.numel() * x.element_size()
    calls[op] += 1


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    _count("all_gather", x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in a new tensor (no autograd),
    counted in ``sent``."""
    return _all_reduce(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    autograd), counted in ``sent``."""
    return _all_gather(x, dim, group)


def _batched(x: torch.Tensor, bdim: Optional[int]) -> torch.Tensor:
    return x if bdim is None or bdim == 0 else x.movedim(bdim, 0)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Reduce.apply(x, group), in_dims[0]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Copy.apply(x, group), in_dims[0]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return _all_gather(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.group = inputs
        ctx.width = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        total = _Reduce.apply(g, ctx.group)
        return total.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.width, ctx.width), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        bdim = in_dims[0]
        if bdim is None:
            return _Gather.apply(x, dim, group), None
        d = dim % (x.dim() - 1) + 1
        return _Gather.apply(_batched(x, bdim), d, group), 0


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return _all_gather(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.group = inputs
        ctx.width = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.width, ctx.width), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        bdim = in_dims[0]
        if bdim is None:
            return _GatherReplicated.apply(x, dim, group), None
        d = dim % (x.dim() - 1) + 1
        return _GatherReplicated.apply(_batched(x, bdim), d, group), 0


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Max.apply(x, group), in_dims[0]


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherReplicated.apply(x, dim, group)


def max_over_model(x: torch.Tensor, group) -> torch.Tensor:
    return _Max.apply(x.detach(), group)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model group of a pass: its process group, this rank's index and
    the group's size in it, and ``split``, the logical axes ("vocab",
    "heads", "kv", "mlp", "experts") whose leaves the layout splits over
    the group."""

    group: object
    index: int
    size: int
    split: FrozenSet[str]

    def over(self, axis: str) -> Optional["ModelAxis"]:
        """This axis where the leaves of the logical ``axis`` are split over
        it, else None (the work runs whole on every rank)."""
        return self if axis in self.split else None

    def copy(self, x):
        return copy_to_model(x, self.group)

    def reduce(self, x):
        return reduce_from_model(x, self.group)

    def gather(self, x, dim: int):
        return gather_from_model(x, dim, self.group)

    def gather_replicated(self, x, dim: int):
        return gather_replicated(x, dim, self.group)

    def narrow(self, x, dim: int):
        """This rank's slice of ``x`` along ``dim`` (a view), ``x.shape[dim]``
        split evenly over the group."""
        width = x.shape[dim] // self.size
        return x.narrow(dim, self.index * width, width)

    def max(self, x):
        return max_over_model(x, self.group)


def vocab_embed(tp: ModelAxis, table: torch.Tensor, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Rows of the vocabulary-split ``table`` (this rank's slice of the
    rows) for ``tokens``: a token outside the rank's rows gives zeros, and
    the all-reduce sums the one rank's row with the others' zeros, so the
    result is the whole table's row, bit for bit."""
    rows = table.shape[0]
    ids = tokens.long() - tp.index * rows
    inside = (ids >= 0) & (ids < rows)
    out = table.to(dtype)[torch.where(inside, ids, 0)]
    return tp.reduce(torch.where(inside[..., None], out, torch.zeros((), dtype=dtype,
                                                                     device=out.device)))


def vocab_xent(tp: ModelAxis, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy, logsumexp - gold, from this rank's fp32
    ``logits`` over its slice of the vocabulary columns: the max over the
    model group shifts the exponentials, their sums are all-reduced, and the
    gold logit comes from the rank whose columns hold the label."""
    cols = logits.shape[-1]
    shift = tp.max(torch.amax(logits, dim=-1))
    logz = torch.log(tp.reduce(torch.sum(torch.exp(logits - shift[..., None]), dim=-1))) + shift
    ids = labels.long() - tp.index * cols
    inside = (ids >= 0) & (ids < cols)
    gold = torch.gather(logits, -1, torch.where(inside, ids, 0)[..., None])[..., 0]
    return logz - tp.reduce(torch.where(inside, gold, torch.zeros((), dtype=gold.dtype,
                                                                  device=gold.device)))
