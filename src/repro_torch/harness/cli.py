"""CLI for the scenario harness: ``python -m repro_torch.harness``.

The port of ``repro.harness.cli``, with the same flags, topologies and exit
codes plus ``--device`` (``cuda`` by default, which raises without a card;
``cpu`` runs the kernels' plain versions). Runs each requested scenario at each requested worker count, in both flat and
hierarchical (``groups = workers // 4``) topology where the worker count
allows it, plus the build-up sweep (local_topk O(n) vs clt_k flat, measured
against ``analysis.perfmodel.buildup_ratio_model``). Results — per-step
records, re-plan events, violations — land in ``BENCH_scenarios_torch.json``
(override with ``--out`` or the ``SCALECOM_TORCH_SCENARIOS_JSON`` env var;
the reference's ``BENCH_scenarios.json`` and ``SCENARIOS_JSON`` are never
touched) and any invariant violation makes the exit status non-zero.
``--events-out PATH`` additionally emits the run as a structured JSONL event
stream (repro_torch.obs.events: provenance header first, one ``scenario``
event per run, one ``violation`` event per invariant breach, a ``summary``
last) — the format ``python -m repro_torch.obs.report`` summarizes.
``SCALECOM_TORCH_FUSED=1`` puts clt_k and true_topk on the fused reduce.

Examples::

    python -m repro_torch.harness --scenarios drop,straggler,stale --workers 8,64
    python -m repro_torch.harness --device cpu --scenarios all --workers 8 --steps 10 --no-buildup
    python -m repro_torch.harness --list
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

__all__ = ["main", "run_cli"]

DEFAULT_OUT = "BENCH_scenarios_torch.json"
OUT_ENV = "SCALECOM_TORCH_SCENARIOS_JSON"


def _topologies(workers: int, hierarchical: bool) -> List[Optional[int]]:
    """Flat always; hierarchical groups = workers // 4 when it divides."""
    tops: List[Optional[int]] = [None]
    if hierarchical:
        g = workers // 4
        if g >= 2 and workers % g == 0:
            tops.append(g)
    return tops


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.harness",
        description="ScaleCom scale & failure scenario harness",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the reduce runs (cuda raises without a card)",
    )
    p.add_argument(
        "--scenarios",
        default="all",
        help="comma-separated scenario names, or 'all' (see --list)",
    )
    p.add_argument(
        "--workers",
        default="8,16,32,64",
        help="comma-separated worker counts to sweep",
    )
    p.add_argument("--steps", type=int, default=12, help="steps per run")
    p.add_argument(
        "--compressor",
        default="clt_k",
        help="compressor under fault injection (build-up sweep always "
        "compares clt_k vs local_topk)",
    )
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--topm", type=int, default=1)
    p.add_argument(
        "--residue-dtype",
        default="fp32",
        choices=("fp32", "bf16", "fp8", "fp8_ec"),
        help="EF residue codec (sets the trajectory tolerance)",
    )
    p.add_argument(
        "--flat-only",
        action="store_true",
        help="skip the hierarchical (groups = workers // 4) topology",
    )
    p.add_argument(
        "--no-buildup",
        action="store_true",
        help="skip the build-up sweep",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--out",
        default=None,
        help=f"result JSON path (default {DEFAULT_OUT}; env {OUT_ENV})",
    )
    p.add_argument(
        "--events-out",
        default=None,
        metavar="PATH",
        help="also emit the run as a structured JSONL event stream "
        "(repro_torch.obs.events; summarize with python -m repro_torch.obs.report)",
    )
    p.add_argument("--list", action="store_true", help="list scenarios and exit")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def run_cli(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.backends import resolve_fused
    from repro_torch.device import resolve_device
    from repro_torch.harness.scenarios import (
        SCENARIOS, run_buildup_sweep, run_scenario, scenario_names,
    )
    from repro_torch.obs.provenance import provenance

    if args.list:
        for spec in SCENARIOS.values():
            print(f"{spec.name:12s} {spec.description}")
        return 0

    names = scenario_names(args.scenarios)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(
            f"unknown scenario(s): {', '.join(unknown)} "
            f"(have: {', '.join(SCENARIOS)})",
            file=sys.stderr,
        )
        return 2
    workers_list = [int(w) for w in args.workers.split(",") if w.strip()]
    device = resolve_device(args.device)

    say = (lambda *a, **k: None) if args.quiet else print
    prov = provenance()
    events = None
    if args.events_out:
        from repro_torch.obs.events import EventLog

        events = EventLog(args.events_out)
        events.emit("provenance", **prov)
    results = []
    all_violations: List[str] = []
    for workers in workers_list:
        for groups in _topologies(workers, not args.flat_only):
            for name in names:
                res = run_scenario(
                    name,
                    workers,
                    steps=args.steps,
                    compressor=args.compressor,
                    chunk=args.chunk,
                    topm=args.topm,
                    groups=groups,
                    residue_dtype=args.residue_dtype,
                    seed=args.seed,
                    device=device,
                )
                results.append(res.to_json())
                topo = "flat" if groups is None else f"groups={groups}"
                status = "ok" if res.passed else "VIOLATION"
                say(
                    f"[{status:9s}] {name:10s} n={workers:<3d} {topo:10s} "
                    f"dist={res.final_distance:.4f}/{res.tolerance:.4f} "
                    f"buildup={res.mean_buildup:.2f} replans={len(res.replans)}"
                )
                for v in res.violations:
                    say(f"            {v}")
                all_violations.extend(
                    f"{name}@n={workers}/{topo}: {v}" for v in res.violations
                )
                if events is not None:
                    events.emit(
                        "scenario",
                        name=name,
                        workers=workers,
                        topology=topo,
                        passed=res.passed,
                        final_distance=res.final_distance,
                        tolerance=res.tolerance,
                        mean_buildup=res.mean_buildup,
                        replans=len(res.replans),
                    )
                    for v in res.violations:
                        events.emit(
                            "violation",
                            message=v,
                            scenario=name,
                            workers=workers,
                            topology=topo,
                        )

    buildup = None
    if not args.no_buildup:
        buildup = run_buildup_sweep(
            tuple(workers_list), chunk=args.chunk, topm=args.topm, seed=args.seed,
            device=device,
        )
        for row in buildup["rows"]:
            say(
                f"[buildup  ] n={int(row['workers']):<3d} "
                f"clt_k={row['clt_k']:.3f} local_topk={row['local_topk']:.3f} "
                f"(model {row['local_topk_model']:.3f})"
            )
        all_violations.extend(buildup["violations"])
        if events is not None:
            for v in buildup["violations"]:
                events.emit("violation", message=v, scenario="buildup")

    out_path = args.out or os.environ.get(OUT_ENV) or DEFAULT_OUT
    payload = {
        "provenance": prov,
        "config": {
            "scenarios": names,
            "workers": workers_list,
            "steps": args.steps,
            "compressor": args.compressor,
            "chunk": args.chunk,
            "topm": args.topm,
            "residue_dtype": args.residue_dtype,
            "seed": args.seed,
            "device": str(device),
            "fused": resolve_fused("auto"),
        },
        "results": results,
        "buildup": buildup,
        "violations": all_violations,
        "passed": not all_violations,
    }
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    if events is not None:
        events.emit(
            "summary",
            runs=len(results),
            violations=len(all_violations),
            passed=not all_violations,
        )
        events.close()
        say(f"events -> {args.events_out}")
    say(
        f"{len(results)} runs, {len(all_violations)} violation(s) -> {out_path}"
    )
    if all_violations:
        for v in all_violations:
            print(f"VIOLATION: {v}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    return run_cli()
