"""Wall-clock span tracing with Chrome-trace-event export.

The port of ``repro.obs.tracing``'s ``Tracer``. Spans time the HOST-side
phases of a run (train step, checkpoint) from outside the reduce: a timer
inside ``scalecom_reduce`` would wait for the card (the reduce's taps never
do), so a span stamps the clock around a call whose result the caller has
already waited for.

Export formats:

  * ``chrome_trace()``   the Trace Event Format dict (``traceEvents`` of
    complete ``"ph": "X"`` events, microsecond timestamps) that
    chrome://tracing and Perfetto load directly;
  * ``to_events()``      plain dicts for the JSON-lines event log
    (repro_torch.obs.events), one ``{"type": "span", ...}`` record per span.

The reference's ``measured_bucket_timeline`` needs ``analysis/perfmodel.py``
and is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass
class Span:
    """One completed span: [ts_us, ts_us + dur_us) on track ``tid``."""

    name: str
    ts_us: float
    dur_us: float
    tid: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Collects spans/instants against one run-relative clock.

    The clock zero is the Tracer's construction time, so every export's
    timestamps are small and directly comparable across spans of the same
    run. Not thread-safe by design — one Tracer per run loop.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.spans: List[Span] = []

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, **args: Any) -> Iterator[Span]:
        """Time the with-block as one complete span.

        The yielded Span is live: the body may add ``args`` entries (e.g.
        measured byte counts discovered mid-block). Recorded even if the body
        raises — a span that dies mid-flight is exactly what you want to see
        in the trace.
        """
        s = Span(name=name, ts_us=self.now_us(), dur_us=0.0, tid=tid, args=args)
        try:
            yield s
        finally:
            s.dur_us = self.now_us() - s.ts_us
            self.spans.append(s)

    def instant(self, name: str, tid: int = 0, **args: Any) -> None:
        """A zero-duration marker (violations, re-plans, phase switches)."""
        self.spans.append(
            Span(name=name, ts_us=self.now_us(), dur_us=0.0, tid=tid, args=args)
        )

    def chrome_trace(self, metadata: Optional[Dict[str, Any]] = None) -> dict:
        """The Trace Event Format document (chrome://tracing / Perfetto)."""
        events = [
            {
                "name": s.name,
                "ph": "X",
                "ts": s.ts_us,
                "dur": s.dur_us,
                "pid": 1,
                "tid": s.tid,
                "cat": "repro",
                "args": s.args,
            }
            for s in self.spans
        ]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": metadata or {},
        }

    def write_chrome_trace(
        self, path: str, metadata: Optional[Dict[str, Any]] = None
    ) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(metadata), f, indent=1)
            f.write("\n")
        return path

    def to_events(self) -> List[Dict[str, Any]]:
        """Span records for the JSON-lines event log (repro_torch.obs.events)."""
        return [
            {
                "type": "span",
                "name": s.name,
                "ts_us": s.ts_us,
                "dur_us": s.dur_us,
                "tid": s.tid,
                "args": s.args,
            }
            for s in self.spans
        ]
