"""``python -m repro_torch.obs.report`` — summarize a telemetry event log.

The port of ``repro.obs.report``: the same summary of the same schema, so
this report and the reference's agree on any log either package wrote.
Consumes the ``events.jsonl`` a ``TelemetryRun`` produced and answers, in
text or ``--json``:

  * per-step compression ratio (dense bytes / payload bytes on the wire) and
    whether measured payload bytes matched the plan's one byte rule;
  * the gradient build-up curve nnz(ĝ)/k per step (union growth is THE
    local-topk failure mode ScaleCom's CLT-k avoids — Fig. 5);
  * exposed-vs-hidden communication from the span stream: bucket/reduce span
    time vs total step span time (on one device nothing truly hides, so the
    text says "measured share", not "hidden");
  * the similarity samples (``metrics_every`` taps of
    core.metrics.residue_similarity_report) and any structured violations.

Pure stdlib on purpose: the report runs anywhere the JSONL lands, without
torch installed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.obs.events import read_events
from repro_torch.obs.taps import parse_key

__all__ = ["summarize", "format_text", "main"]


def _mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def _tap_series(steps: List[dict], name: str) -> Dict[int, List[float]]:
    """step -> values of every ``obs/<name>{...}`` tap at that step."""
    out: Dict[int, List[float]] = {}
    for ev in steps:
        vals = [
            v
            for key, v in ev.get("metrics", {}).items()
            if key.startswith("obs/") and parse_key(key[4:])[0] == name
        ]
        if vals:
            out[int(ev.get("step", len(out)))] = vals
    return out


def summarize(path: str) -> Dict[str, Any]:
    events = read_events(path)
    steps = [e for e in events if e.get("type") == "step"]
    spans = [e for e in events if e.get("type") == "span"]
    violations = [e for e in events if e.get("type") == "violation"]
    prov = next((e for e in events if e.get("type") == "provenance"), {})

    # --- compression: dense vs payload wire bytes, plan-vs-measured check
    ratios, mismatches = [], 0
    for ev in steps:
        m = ev.get("metrics", {})
        dense, payload = m.get("comm_bytes_dense"), m.get("comm_bytes_per_worker")
        if dense and payload:
            ratios.append(dense / payload)
        measured = [
            (key, v)
            for key, v in m.items()
            if key.startswith("obs/") and parse_key(key[4:])[0] == "bytes_measured"
        ]
        for key, v in measured:
            planned = m.get(key.replace("bytes_measured", "bytes_planned"))
            if planned is not None and abs(v - planned) > 0.5:
                mismatches += 1

    # --- build-up curve: mean nnz(ĝ)/k per step across tensors
    nnz, ks = _tap_series(steps, "buildup_nnz"), _tap_series(steps, "buildup_k")
    buildup = {
        s: sum(nnz[s]) / max(sum(ks.get(s, [])), 1.0)
        for s in sorted(nnz)
        if ks.get(s)
    }

    # --- similarity samples (only steps where the metrics_every cond fired)
    sampled = _tap_series(steps, "similarity_sampled")
    sim_steps = sorted(s for s, v in sampled.items() if any(v))
    similarity = {
        metric: {
            s: _mean(vals)
            for s, vals in _tap_series(steps, metric).items()
            if s in sim_steps
        }
        for metric in (
            "pairwise_cosine_distance",
            "hamming_d_over_k",
            "topk_energy_overlap",
            "spearman_rho",
        )
    }

    # --- spans: comm (bucket/reduce) time vs step time
    def _total(pred) -> float:
        return sum(s.get("dur_us", 0.0) for s in spans if pred(s))

    step_us = _total(lambda s: s.get("name") == "step")
    comm_us = _total(
        lambda s: str(s.get("name", "")).startswith(("bucket", "reduce"))
    )
    by_name: Dict[str, Dict[str, float]] = {}
    for s in spans:
        row = by_name.setdefault(str(s.get("name")), {"count": 0, "total_us": 0.0})
        row["count"] += 1
        row["total_us"] += s.get("dur_us", 0.0)

    gammas = [
        v for vals in _tap_series(steps, "contraction_gamma").values() for v in vals
    ]

    # --- fused-path taps: which inner-loop path each tensor took and the
    # per-tensor launch count a kernel backend pays (obs/fused{...} /
    # obs/fused_launches{...} — static plan facts, so any step is
    # representative; we read the last one).
    fused_flags = [
        v for vals in _tap_series(steps, "fused").values() for v in vals
    ]
    launches = [
        v for vals in _tap_series(steps, "fused_launches").values() for v in vals
    ]
    n_steps_fused = len(_tap_series(steps, "fused"))
    per_step = max(1, n_steps_fused)
    fused_path = (
        {
            "tensors": len(fused_flags) // per_step,
            "tensors_fused": int(sum(fused_flags) / per_step),
            "launches_per_step": sum(launches) / per_step,
        }
        if fused_flags
        else None
    )

    return {
        "events": len(events),
        "steps": len(steps),
        "provenance": {k: v for k, v in prov.items() if k not in ("type", "wall_s")},
        "compression_ratio": {
            "mean": _mean(ratios),
            "min": min(ratios) if ratios else None,
            "max": max(ratios) if ratios else None,
        },
        "bytes_plan_mismatches": mismatches,
        "buildup_curve": buildup,
        "similarity": similarity,
        "contraction_gamma_mean": _mean(gammas),
        "fused_path": fused_path,
        "spans": {
            "by_name": by_name,
            "step_total_us": step_us,
            "comm_total_us": comm_us,
            "comm_share_of_step": (comm_us / step_us) if step_us else None,
        },
        "violations": [v.get("message") for v in violations],
    }


def format_text(s: Dict[str, Any]) -> str:
    lines = [f"telemetry report: {s['steps']} steps, {s['events']} events"]
    prov = s["provenance"]
    if prov:
        lines.append(
            "  provenance: "
            + ", ".join(f"{k}={v}" for k, v in sorted(prov.items()))
        )
    cr = s["compression_ratio"]
    if cr["mean"]:
        lines.append(
            f"  compression ratio (dense/payload): mean {cr['mean']:.1f}x "
            f"(min {cr['min']:.1f}x, max {cr['max']:.1f}x), "
            f"{s['bytes_plan_mismatches']} measured-vs-plan byte mismatches"
        )
    if s["buildup_curve"]:
        vals = list(s["buildup_curve"].values())
        lines.append(
            f"  build-up nnz/k: first {vals[0]:.2f} -> last {vals[-1]:.2f} "
            f"over {len(vals)} steps"
        )
    if s["contraction_gamma_mean"] is not None:
        lines.append(f"  contraction gamma: mean {s['contraction_gamma_mean']:.4f}")
    fp = s.get("fused_path")
    if fp:
        lines.append(
            f"  fused path: {fp['tensors_fused']}/{fp['tensors']} compressed "
            f"tensor(s) on the single-launch fused reduce, "
            f"{fp['launches_per_step']:.0f} inner-loop kernel launches/step"
        )
    sim = {k: v for k, v in s["similarity"].items() if v}
    if sim:
        sampled = len(next(iter(sim.values())))
        lines.append(f"  similarity samples: {sampled} sampled step(s)")
        for metric, curve in sorted(sim.items()):
            mean = _mean([v for v in curve.values() if v is not None])
            if mean is not None:
                lines.append(f"    {metric}: mean {mean:.4f}")
    sp = s["spans"]
    if sp["by_name"]:
        if sp["comm_share_of_step"] is not None:
            lines.append(
                f"  comm spans vs step spans (measured share, single-host): "
                f"{sp['comm_total_us'] / 1e3:.2f}ms / "
                f"{sp['step_total_us'] / 1e3:.2f}ms = "
                f"{sp['comm_share_of_step']:.1%}"
            )
        for name, row in sorted(sp["by_name"].items()):
            lines.append(
                f"    span {name}: n={row['count']} "
                f"total={row['total_us'] / 1e3:.2f}ms"
            )
    if s["violations"]:
        lines.append(f"  VIOLATIONS ({len(s['violations'])}):")
        lines.extend(f"    {v}" for v in s["violations"])
    else:
        lines.append("  violations: none")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro telemetry event log (events.jsonl)",
    )
    ap.add_argument("events", help="path to the JSONL event log")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)
    try:
        s = summarize(args.events)
    except OSError as e:
        print(f"cannot read {args.events}: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(s, indent=1))
    else:
        print(format_text(s))
    return 1 if s["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
