"""Training loop: dense warm-up, then the compressed ScaleCom steps.

The port of ``repro.training.loop``. The warm-up runs the dense step (the
paper trains uncompressed before enabling compression); residues stay zero
during warm-up, so switching is state-compatible by construction.

Logging goes to the ``repro_torch.training`` logger by default, which is
silent unless a handler is attached (the launch CLI attaches one). Pass
``log=print`` for console lines or ``log=None`` for none. With
``ScaleComConfig(telemetry=True)`` the taps are in each history entry as
``obs/...`` floats. Checkpointing and the telemetry recorder wait (ROADMAP
Queue 1 items 14 and 16).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.training.train_step import TrainState, build_train_step

__all__ = ["TrainLoop", "run_training"]

_LOGGER = object()  # "log not passed": route to the package logger


@dataclasses.dataclass
class TrainLoop:
    model: Any
    optimizer: Any
    schedule: Callable
    sc_cfg: ScaleComConfig
    n_workers: int
    grad_clip: Optional[float] = None
    log_every: int = 10
    compute_stats: bool = False
    # launch spec of the bucketed reduce (scalecom_reduce buckets=...);
    # None/"auto" reads $SCALECOM_TORCH_BUCKET_MB
    buckets: Any = None

    def __post_init__(self):
        common = dict(n_workers=self.n_workers, grad_clip=self.grad_clip,
                      compute_stats=self.compute_stats, buckets=self.buckets)
        self._dense = build_train_step(self.model, self.optimizer, self.schedule,
                                       self.sc_cfg, mode="dense", **common)
        self._compressed = build_train_step(self.model, self.optimizer, self.schedule,
                                            self.sc_cfg, mode="scalecom", **common)

    def compressed_at(self, step_idx: int) -> bool:
        return self.sc_cfg.compressor.name != "none" and step_idx >= self.sc_cfg.warmup_steps

    def step(self, state: TrainState, batch, step_idx: int):
        fn = self._compressed if self.compressed_at(step_idx) else self._dense
        return fn(state, batch)


def run_training(
    loop: TrainLoop,
    state: TrainState,
    batches: Iterator[Dict[str, np.ndarray]],
    num_steps: int,
    *,
    log: Any = _LOGGER,
) -> tuple[TrainState, List[Dict[str, float]]]:
    """Drive ``num_steps`` steps; returns (state, history).

    History holds one entry every ``log_every`` steps and at the last step:
    the metrics as floats plus ``step`` and ``wall_s`` (seconds since the
    start). Reading the metrics waits for the device, so ``wall_s`` at a
    logged step counts the work of every step up to it.
    """
    if log is _LOGGER:
        log = logging.getLogger("repro_torch.training").info
    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= num_steps:
            break
        state, metrics = loop.step(state, batch, i)
        if (i % loop.log_every == 0) or i == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if log is not None:
                log(f"step {i:5d}  loss {m['loss']:.4f}  gnorm {m['grad_norm']:.3f}"
                    f"  lr {m['lr']:.2e}")
    return state, history
