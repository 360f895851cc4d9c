"""TelemetryRun: the per-run bundle the training loop and launch CLI hold.

One object wiring the three telemetry pieces together for one run directory:

  tracer      wall-clock spans (obs.tracing) -> ``trace.json`` (Chrome trace)
  events      JSONL event log (obs.events)   -> ``events.jsonl``
  registry    host-side metrics (obs.registry), summarized into the log

Lifecycle: construct with a directory (created on demand), feed it steps via
``step_span`` + ``record_step``, then ``close()`` — which flushes the spans
into both exports and appends a final ``summary`` event. ``close`` is
idempotent and also runs from ``with TelemetryRun(...) as run:``.

The provenance header (git sha, torch and CUDA versions, the card and its
power limit: obs.provenance) is the log's first event, so every artifact is
self-describing. The port of ``repro.obs.run``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

from repro_torch.obs.events import EventLog
from repro_torch.obs.provenance import provenance
from repro_torch.obs.registry import MetricRegistry
from repro_torch.obs.tracing import Tracer

__all__ = ["TelemetryRun"]


class TelemetryRun:
    """Telemetry sinks for one run, rooted at ``trace_dir``."""

    def __init__(
        self,
        trace_dir: str,
        *,
        backend_name: Optional[str] = None,
        extra_provenance: Optional[Dict[str, Any]] = None,
    ):
        self.trace_dir = trace_dir
        self.trace_path = os.path.join(trace_dir, "trace.json")
        self.events_path = os.path.join(trace_dir, "events.jsonl")
        self.tracer = Tracer()
        self.events = EventLog(self.events_path)
        self.registry = MetricRegistry()
        self._closed = False
        self._provenance = {**provenance(backend_name), **(extra_provenance or {})}
        self.events.emit("provenance", **self._provenance)

    def step_span(self, step: int, **args: Any):
        """Span covering one train-loop step (host-side: dispatch, and the
        wait for the card that converting the metrics forces)."""
        return self.tracer.span("step", step=step, **args)

    def record_step(self, step: int, metrics: Mapping[str, Any]) -> None:
        """Ingest one step's metrics: registry series + a ``step`` event."""
        flat = self.registry.record_stats(metrics)
        self.events.emit("step", step=step, metrics=flat)

    def violation(self, message: str, **context: Any) -> None:
        """Structured invariant-violation event (scenario harness)."""
        self.tracer.instant("violation", message=message)
        self.events.emit("violation", message=message, **context)

    def close(self) -> Dict[str, str]:
        """Flush everything; returns the artifact paths. Idempotent."""
        if not self._closed:
            self._closed = True
            self.tracer.write_chrome_trace(
                self.trace_path, metadata=self._provenance
            )
            self.events.emit_many(self.tracer.to_events())
            self.events.emit("summary", metrics=self.registry.summary())
            self.events.close()
        return {"trace": self.trace_path, "events": self.events_path}

    def __enter__(self) -> "TelemetryRun":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
