"""Telemetry of the port: the port of ``repro.obs``.

  taps        metric taps inside the reduce: values leave it as 0-d tensors
              in its stats dict, never through a host sync; no-ops when
              telemetry is off (``ScaleComConfig.telemetry``).
  tracing     wall-clock spans around host-side phases (the train step),
              exported as Chrome-trace-event JSON and JSONL events.
  registry /  host-side metric aggregation, the JSONL event log (the
  events /    reference's schema), the provenance header (torch, CUDA, the
  provenance  card and its power limit) and ``python -m
  / report    repro_torch.obs.report``, the summarizer.

``TelemetryRun`` bundles the sinks for one run (the CLI's ``--trace-dir``);
``get_logger`` / ``enable_console_logging`` are the port's logging handles
on the ``repro_torch`` logger root, which the training loop routes through
(quiet by default, no handlers; the launch CLI turns the console on).

``tracing.measured_bucket_timeline`` times the bucketed reduce bucket by
bucket beside the performance model's timeline. Nothing here imports torch
when the package is imported, so the report runs where torch is not
installed.
"""

from __future__ import annotations

import logging
import sys

from repro_torch.obs import events, provenance, registry, taps, tracing
from repro_torch.obs.events import EventLog, read_events
from repro_torch.obs.provenance import device_tags, git_sha
from repro_torch.obs.provenance import provenance as provenance_stamp
from repro_torch.obs.registry import MetricRegistry
from repro_torch.obs.run import TelemetryRun
from repro_torch.obs.tracing import Tracer

__all__ = [
    "EventLog",
    "MetricRegistry",
    "TelemetryRun",
    "Tracer",
    "device_tags",
    "enable_console_logging",
    "events",
    "get_logger",
    "git_sha",
    "provenance",
    "provenance_stamp",
    "read_events",
    "registry",
    "taps",
    "tracing",
]

_LOGGER_ROOT = "repro_torch"


def get_logger(name: str = "") -> logging.Logger:
    """The port's logger tree (root ``repro_torch``). With no handler
    configured (the default) INFO records are dropped silently, so code that
    imports the training loop stays quiet unless it opts in through
    ``enable_console_logging``."""
    return logging.getLogger(f"{_LOGGER_ROOT}.{name}" if name else _LOGGER_ROOT)


def enable_console_logging(level: int = logging.INFO) -> logging.Logger:
    """Attach one stderr handler to the ``repro_torch`` logger (idempotent):
    the launch CLI's opt-in to visible step logs."""
    logger = get_logger()
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
        logger.addHandler(handler)
    return logger
