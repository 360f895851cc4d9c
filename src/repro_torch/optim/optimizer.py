"""Optimizers: SGD-momentum, Adam, RMSProp (the port of ``repro.optim.optimizer``).

The three the paper trains with. ScaleCom sits upstream: the optimizer
consumes the already-reduced sparsified gradient ĝ, as Algorithm 1 line 12
applies the standard update to the compressed average.

``update(grads, state, params, lr) -> (params, state)`` works IN PLACE: it
overwrites the parameter and state tensors it is given (under ``no_grad``)
and returns the same trees, so a step allocates no second copy of the model.
A caller that needs the old values keeps its own copy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import tree

__all__ = ["Optimizer", "sgdm", "adam", "rmsprop", "make_optimizer"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    # update(grads, opt_state, params, lr) -> (params, opt_state), in place


def _pairs(*trees):
    return zip(*(tree.leaves(t) for t in trees))


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree.zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        for g, m, p in _pairs(grads, state["m"], params):
            g = g + weight_decay * p if weight_decay else g
            m.copy_(momentum * m + g)
            step = g + momentum * m if nesterov else m
            p.copy_(p - lr * step)
        return params, state

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree.zeros_like(params), "v": tree.zeros_like(params), "count": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        bc1 = 1.0 - b1**c
        bc2 = 1.0 - b2**c
        for g, m, v, p in _pairs(grads, state["m"], state["v"], params):
            g = g + weight_decay * p if weight_decay else g
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.copy_(p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
        state["count"] = c
        return params, state

    return Optimizer(init, update)


def rmsprop(decay: float = 0.9, momentum: float = 0.9, eps: float = 1.0,
            weight_decay: float = 0.0) -> Optimizer:
    """RMSProp with momentum; the paper's MobileNetV2 recipe uses eps=1.0."""

    def init(params):
        return {"v": tree.zeros_like(params), "m": tree.zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        for g, v, m, p in _pairs(grads, state["v"], state["m"], params):
            g = g + weight_decay * p if weight_decay else g
            v.copy_(decay * v + (1 - decay) * g * g)
            m.copy_(momentum * m + g / torch.sqrt(v + eps))
            p.copy_(p - lr * m)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, *, momentum=0.9, weight_decay=0.0, **kw) -> Optimizer:
    if name == "sgdm":
        return sgdm(momentum=momentum, weight_decay=weight_decay)
    if name == "adam":
        return adam(weight_decay=weight_decay, **kw)
    if name == "rmsprop":
        return rmsprop(momentum=momentum, weight_decay=weight_decay, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
