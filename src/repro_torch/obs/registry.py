"""Host-side metric registry: counters / gauges / histograms over tap keys.

The port of ``repro.obs.registry``. The reduce only *emits* values
(repro_torch.obs.taps -> ``"obs/..."`` 0-d tensors in its stats dict); this
module is where those values become metrics once they are host floats. One
registry per run (``TelemetryRun`` owns one), with the same label
convention as the taps: every series is addressed by ``name`` + a label
dict (tensor path, bucket id, compressor, layout, backend), stored under
the canonical ``taps.tap_key`` string.

Kinds:

  counter    monotonically accumulating sum (comm bytes, steps sampled)
  gauge      last-value-wins (compression ratio, contraction gamma)
  histogram  full distribution summary: count/sum/min/max + fixed power-of-2
             buckets (per-step wall times, per-tensor build-up ratios)

``record_stats`` is the bridge from a train step's metrics dict: every
``obs/<key>`` entry lands as a histogram point AND a last-value gauge under
its tap key, so the report CLI can show both curves and latest state without
knowing tap sites by name. Pure stdlib — safe to import anywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.obs.taps import parse_key, tap_key

__all__ = ["Metric", "MetricRegistry"]

# histogram bucket upper bounds: powers of two spanning sub-unit ratios to
# multi-GB byte counts; one +inf overflow bucket at the end
_HIST_BOUNDS: Tuple[float, ...] = tuple(2.0**e for e in range(-10, 41, 2)) + (
    math.inf,
)


@dataclasses.dataclass
class Metric:
    """One labeled series. ``kind`` fixes which fields are meaningful."""

    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    labels: Dict[str, str]
    count: int = 0
    total: float = 0.0
    last: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    buckets: Optional[List[int]] = None  # histogram only, len(_HIST_BOUNDS)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.last = value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if self.kind == "histogram":
            if self.buckets is None:
                self.buckets = [0] * len(_HIST_BOUNDS)
            for i, bound in enumerate(_HIST_BOUNDS):
                if value <= bound:
                    self.buckets[i] += 1
                    break

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind,
            "labels": self.labels,
            "count": self.count,
            "last": self.last,
        }
        if self.kind == "counter":
            out["total"] = self.total
        else:
            out["sum"] = self.total
            out["min"] = None if self.count == 0 else self.min
            out["max"] = None if self.count == 0 else self.max
            out["mean"] = self.total / self.count if self.count else None
        if self.kind == "histogram" and self.buckets is not None:
            out["buckets"] = {
                ("inf" if math.isinf(b) else f"{b:g}"): n
                for b, n in zip(_HIST_BOUNDS, self.buckets)
                if n
            }
        return out


class MetricRegistry:
    """Registry of labeled metrics, keyed by ``taps.tap_key(name, **labels)``.

    The same (name, labels, kind) triple always resolves to the same Metric;
    re-registering a key with a different kind raises — a kind flip means two
    call sites disagree about what the series is.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, kind: str, labels: Dict[str, Any]) -> Metric:
        key = tap_key(name, **labels)
        m = self._metrics.get(key)
        if m is None:
            m = Metric(
                name=name,
                kind=kind,
                labels={k: str(v) for k, v in sorted(labels.items())},
            )
            self._metrics[key] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {key!r} already registered as {m.kind!r}, "
                f"requested {kind!r}"
            )
        return m

    def counter(self, name: str, value: float = 1.0, **labels: Any) -> None:
        self._get(name, "counter", labels).observe(value)

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        self._get(name, "gauge", labels).observe(value)

    def histogram(self, name: str, value: float, **labels: Any) -> None:
        self._get(name, "histogram", labels).observe(value)

    def record_stats(self, metrics: Mapping[str, Any]) -> Dict[str, float]:
        """Ingest one step's metrics dict (host floats / 0-d tensors).

        ``obs/<tap key>`` entries are recorded as histogram + ``<name>:last``
        gauge series under their parsed labels; everything else (loss, lr,
        comm_bytes_*) is recorded as a plain gauge. Returns the flat
        {tap key: float} view of what was ingested (the event-log payload).
        """
        flat: Dict[str, float] = {}
        for key, raw in metrics.items():
            try:
                value = float(raw)
            except (TypeError, ValueError):
                continue
            flat[key] = value
            if key.startswith("obs/"):
                name, labels = parse_key(key[len("obs/") :])
                self.histogram(name, value, **labels)
                self.gauge(name + ":last", value, **labels)
            else:
                self.gauge(key, value)
        return flat

    def summary(self) -> Dict[str, Dict[str, Any]]:
        return {k: m.summary() for k, m in sorted(self._metrics.items())}
