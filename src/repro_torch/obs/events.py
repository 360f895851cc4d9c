"""JSON-lines event log: the unified export stream of the telemetry layer.

One append-only ``events.jsonl`` per run. Every record is a single JSON
object with a ``type`` tag and a wall-clock ``wall_s`` stamp; everything else
is type-specific. The types the repo emits:

  provenance  run header: git sha, torch/CUDA versions, card (obs.provenance)
  step        one train-loop step: metrics dict incl. the ``obs/`` tap leaves
  span        one completed wall-clock span (obs.tracing.Tracer.to_events)
  violation   one harness invariant violation (structured, machine-readable)
  scenario    one harness scenario result summary
  note        free-form annotation

JSONL rather than one JSON document so a crashed run still ships every event
up to the crash, logs concatenate across restarts, and consumers can stream.
``python -m repro_torch.obs.report`` is the bundled consumer; ``read_events``
is the library entry point. The port of ``repro.obs.events``, with the same
schema, so either package's report reads either package's log. Pure stdlib.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["EventLog", "read_events"]


def _jsonable(value: Any) -> Any:
    """Best-effort coercion for event fields: numpy scalars and 0-d tensors -> floats,
    unknown objects -> repr. Events must always serialize — a telemetry write
    must never be the thing that kills a run."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:
        return float(value)  # 0-d arrays, numpy scalars
    except (TypeError, ValueError):
        return repr(value)


class EventLog:
    """Append-only JSONL writer. Opens lazily, flushes per event (tail -f
    friendly; a crash loses at most the in-flight line)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def emit(self, type: str, **fields: Any) -> Dict[str, Any]:
        event = {"type": type, "wall_s": time.time()}
        event.update({k: _jsonable(v) for k, v in fields.items()})
        if self._f is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()
        return event

    def emit_many(self, events: Iterable[Dict[str, Any]]) -> None:
        for e in events:
            e = dict(e)
            self.emit(e.pop("type", "note"), **e)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(
    path: str, types: Optional[Iterable[str]] = None
) -> List[Dict[str, Any]]:
    """Load an event log; malformed lines are skipped, not fatal (a run that
    died mid-write still yields every complete event)."""
    wanted = set(types) if types is not None else None
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                continue
            if wanted is None or event.get("type") in wanted:
                out.append(event)
    return out
