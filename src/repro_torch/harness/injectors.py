"""Fault injectors — the failure layer the scenario harness wraps around
``scalecom_reduce``.

The port of ``repro.harness.injectors``, with the same classes, fields and
defaults. The system under test is untouched: an injector only transforms
what the real system would see — the per-worker gradient stream, the
persistent EF state and the membership set — **before** the genuine
``scalecom_reduce`` call, and observes state **after** it.

The hooks, called by ``scenarios._simulate`` each step:

  membership(t, world)   which worker ids contribute this step (dropped /
                         rejoining workers); a change triggers the elastic
                         re-plan path (plan-time divisibility / state-drift
                         validation, ``core.state.remap_state``).
  inject(ctx, stream)    mutate the StepContext: replace gradient rows
                         (straggler delay), revert or corrupt residue rows.
  observe(t, state)      post-step snapshot window (stale-residue injection
                         needs the true historical state to rewind to).

Copy, never alias: JAX arrays are immutable, torch tensors are not, and the
fp32 codec's encoding *is* the reduce's output tensor. So the history
snapshot is a clone, and a row is written only into a clone of the tensor
that holds it; nothing here writes into a tensor the stream, the reduce or
another run also holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.core.state import ScaleComState, _mix64

Pytree = Any
# stream(t, worker_ids) -> nested dict of (len(worker_ids), *shape) gradients
Stream = Callable[[int, Tuple[int, ...]], Pytree]

__all__ = [
    "StepContext",
    "Injector",
    "StragglerInjector",
    "DropRejoinInjector",
    "StaleResidueInjector",
    "CorruptResidueInjector",
    "keyed_normal",
    "corrupt_draw",
]


def keyed_normal(shape: Tuple[int, ...], *key: int) -> torch.Tensor:
    """fp32 standard normals of ``shape`` from a CPU generator keyed by the
    integers ``key``, the port's ``normal(fold_in(...))``: the key parts go
    through splitmix64's finalizer in turn, so every bit of every part
    reaches the low 32 bits, the only ones the CPU generator reads. Drawn on
    the CPU, so a card run and a CPU run see the same bytes."""
    seed = 0
    for part in key:
        seed = _mix64(seed ^ (int(part) & ((1 << 64) - 1)))
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def corrupt_draw(seed: int, leaf: int, shape: Tuple[int, ...]) -> torch.Tensor:
    """The corrupt-residue garbage before scaling, for the ``leaf``-th
    residue (sorted by path): the one draw of the injectors (parity tests
    patch it with the reference's)."""
    return keyed_normal(shape, seed, leaf)


@dataclasses.dataclass
class StepContext:
    """Everything one reduce step consumes, exposed to the injector."""

    t: int
    active: Tuple[int, ...]  # worker ids stacked on the gradient axis
    grads_pw: Pytree  # (len(active), *shape) per tensor
    state: ScaleComState
    notes: Dict[str, Any]  # injector annotations, copied into the record


class Injector:
    """No-fault base: identity membership, identity inject, no observation."""

    def membership(self, t: int, world: Tuple[int, ...]) -> Tuple[int, ...]:
        return world

    def inject(self, ctx: StepContext, stream: Stream) -> StepContext:
        return ctx

    def observe(self, t: int, state: ScaleComState) -> None:
        pass


def _with_row(x: torch.Tensor, row: int, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` whose worker-axis row ``row`` is ``value``."""
    out = x.clone()
    out[row] = value
    return out


@dataclasses.dataclass
class StragglerInjector(Injector):
    """Worker ``worker`` is ``delay`` steps behind: from ``start`` on, its
    contribution at step t is its own gradient from step t - delay — the
    stale-gradient regime DGC shows EF memory is sensitive to."""

    worker: int = 1
    delay: int = 2
    start: int = 3

    def inject(self, ctx: StepContext, stream: Stream) -> StepContext:
        if ctx.t < self.start or self.worker not in ctx.active:
            return ctx
        row = ctx.active.index(self.worker)
        stale_t = max(ctx.t - self.delay, 0)
        stale = stream(stale_t, (self.worker,))
        ctx.grads_pw = tree.tree_map(lambda g, r: _with_row(g, row, r[0]), ctx.grads_pw, stale)
        ctx.notes["straggler"] = {"worker": self.worker, "uses_step": stale_t}
        return ctx


@dataclasses.dataclass
class DropRejoinInjector(Injector):
    """Worker ``worker`` leaves at ``drop_at`` and rejoins at ``rejoin_at``.

    Membership-only: the runner reacts to the changed worker set with the
    elastic re-plan path (stale-plan ValueError at plan time, group re-plan,
    ``remap_state`` worker-axis fold/expand). A 64-worker world dropping to
    63 is exactly the divisibility transition the plan-time guard exists for.
    """

    worker: int = 0
    drop_at: int = 4
    rejoin_at: int = 8

    def membership(self, t: int, world: Tuple[int, ...]) -> Tuple[int, ...]:
        if self.drop_at <= t < self.rejoin_at:
            return tuple(w for w in world if w != self.worker)
        return world


@dataclasses.dataclass
class StaleResidueInjector(Injector):
    """At step ``at``, worker-row ``worker`` of every EF residue is reverted
    to its value ``staleness`` steps earlier — a learner restored from an old
    checkpoint while the rest of the fleet moved on. The un-reverted steps'
    gradient mass is re-fed by error feedback, so the trajectory must pull
    back within codec tolerance instead of drifting.

    ``worker`` indexes the residue's worker axis (the *group* axis in
    hierarchical mode).
    """

    worker: int = 1
    at: int = 6
    staleness: int = 3

    def __post_init__(self):
        self._history: Dict[int, Dict[str, Pytree]] = {}

    def observe(self, t: int, state: ScaleComState) -> None:
        if self.at - self.staleness <= t < self.at:
            self._history[t] = {
                path: {k: v.clone() for k, v in enc.items()}
                for path, enc in state.residues.items()
            }
        self._history = {
            k: v for k, v in self._history.items() if k >= self.at - self.staleness
        }

    def inject(self, ctx: StepContext, stream: Stream) -> StepContext:
        old_t = self.at - self.staleness
        if ctx.t != self.at or old_t not in self._history:
            return ctx
        old = self._history[old_t]
        residues = {}
        for path, enc in ctx.state.residues.items():
            row = self.worker % enc["q"].shape[0]
            residues[path] = {
                k: _with_row(cur, row, old[path][k][row]) for k, cur in enc.items()
            }
        ctx.state = ScaleComState(residues=residues, t=ctx.state.t)
        ctx.notes["stale_residue"] = {"worker": self.worker, "reverted_to": old_t}
        return ctx


@dataclasses.dataclass
class CorruptResidueInjector(Injector):
    """At step ``at``, worker-row ``worker`` of every residue's quantized
    payload is overwritten with finite garbage (``scale``-sized noise) — a
    corrupted encoding (bit rot, a bad transfer) that still parses. Error
    feedback flushes the garbage into one bounded ĝ perturbation and the
    trajectory must re-enter codec tolerance by the end of the run.
    """

    worker: int = 0
    at: int = 5
    scale: float = 2.0
    seed: int = 0x0BAD

    def inject(self, ctx: StepContext, stream: Stream) -> StepContext:
        if ctx.t != self.at:
            return ctx
        residues = {}
        for i, (path, enc) in enumerate(sorted(ctx.state.residues.items())):
            q = enc["q"]
            row = self.worker % q.shape[0]
            garbage = self.scale * corrupt_draw(self.seed, i, tuple(q.shape[1:]))
            # finite and far inside bf16's and e4m3's range: torch's casts
            # round to nearest even there, as the reference's astype does
            residues[path] = {**enc, "q": _with_row(q, row, garbage.to(q.device, q.dtype))}
        ctx.state = ScaleComState(residues=residues, t=ctx.state.t)
        ctx.notes["corrupt_residue"] = {"worker": self.worker, "scale": self.scale}
        return ctx
