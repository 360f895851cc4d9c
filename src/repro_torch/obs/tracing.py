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

``measured_bucket_timeline`` times the bucketed reduce bucket by bucket and
sets the result beside the performance model's overlap timeline
(``analysis.perfmodel.overlap_report``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "measured_bucket_timeline"]


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


def measured_bucket_timeline(
    grads_pw: Any,
    cfg: Any,
    *,
    buckets: Any = True,
    tracer: Optional[Tracer] = None,
) -> Dict[str, Any]:
    """Measure the bucketed reduce per bucket and return spans + model.

    grads_pw: worker-stacked gradient tree ((n, *shape) leaves); cfg: a
    ScaleComConfig. Resolves the same bucket schedule the real launch uses,
    then times (a) the plan stage, (b) each bucket's reduce in isolation,
    over that bucket's tensors from zero residues, and (c) the full bucketed
    reduce, each on the host clock around a call (after one untimed call)
    whose end is waited for with ``torch.cuda.synchronize`` on the card, so
    a span covers the device's work, not its dispatch. Spans land on the
    given or a new Tracer (bucket i on tid i + 1); the return holds them,
    the bucket rows, the full reduce's time, the modeled timeline of
    ``analysis.perfmodel.overlap_report`` (None unbucketed) and the device
    kind (the card's name, or "cpu").

    Imports are call-time: ``repro_torch.obs`` imports no torch, so that its
    report runs where torch is not installed.
    """
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.analysis import perfmodel
    from repro_torch.core import overlap
    from repro_torch.core.plan import plan_tensors
    from repro_torch.core.scalecom import scalecom_reduce
    from repro_torch.core.state import init_state, residue_signature

    tracer = tracer or Tracer()
    flat = tree_util.flatten_with_path(grads_pw)
    n = flat[0][1].shape[0]
    device = flat[0][1].device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def fresh_state(leaves):
        return init_state(leaves, cfg.n_workers(n), cfg.residue_dtype, cfg.min_size, cfg.layout)

    state = fresh_state(tree_util.tree_map(lambda g: g[0], grads_pw))
    with tracer.span("plan", n_tensors=len(flat)):
        plans = plan_tensors(
            tuple((path, tuple(g.shape[1:]), g.shape[0]) for path, g in flat),
            cfg,
            residue_signature(state.residues),
        )
    schedule = overlap.resolve_buckets(buckets, cfg, plans) or ()

    def timed_reduce(grads, st, spec):
        scalecom_reduce(grads, st, cfg, buckets=spec)
        sync()
        t0 = tracer.now_us()
        scalecom_reduce(grads, st, cfg, buckets=spec)
        sync()
        return tracer.now_us() - t0

    bucket_rows = []
    for b in schedule:
        sub = {f"leaf{i}": flat[i][1] for i in b.leaf_ids}
        sub_state = fresh_state({k: v[0] for k, v in sub.items()})
        with tracer.span(
            f"bucket[{b.index}]",
            tid=b.index + 1,
            bytes_dense=b.bytes_dense,
            bytes_payload=b.bytes_payload,
            n_leaves=len(b.leaf_ids),
        ) as s:
            s.args["reduce_us"] = timed_reduce(sub, sub_state, False)
        bucket_rows.append({
            "bucket": b.index,
            "bytes_dense": b.bytes_dense,
            "bytes_payload": b.bytes_payload,
            "measured_us": s.args["reduce_us"],
        })

    with tracer.span("reduce/full", bucketed=bool(schedule)) as s:
        s.args["reduce_us"] = timed_reduce(grads_pw, state, buckets)

    bucket_bytes = overlap.resolve_bucket_bytes(buckets, cfg.bucket_bytes)
    scheme = "local_topk" if cfg.compressor.name == "local_topk" else "scalecom"
    modeled = (
        perfmodel.overlap_report(perfmodel.reference_transformer_perf(), scheme, bucket_bytes)
        if bucket_bytes
        else None
    )
    return {
        "tracer": tracer,
        "buckets": bucket_rows,
        "full_us": s.args["reduce_us"],
        "modeled": modeled,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
