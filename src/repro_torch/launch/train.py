"""Training entry point: trains an architecture's smoke variant (``--arch``, one
of ``repro_torch.configs.registry.ARCHS``) with ScaleCom on synthetic data,
simulating n workers on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --workers 8 --steps 200 \
        --compressor clt_k --chunk 64 --beta 0.1 [--device cuda|cpu] \
        [--trace-dir DIR [--metrics-every N]] [--checkpoint-dir DIR] \
        [--preflight-scenarios all|NAME,...]

The port of ``repro.launch.train``. It runs on the CUDA card by default and
raises if there is none; ``--device cpu`` runs the plain PyTorch versions of
the kernels instead. ``SCALECOM_TORCH_FUSED=1`` puts clt_k and true_topk
tensors on the single-launch fused reduce. ``--residue-dtype`` picks the
residue codec, ``--bucket-mb`` the bucketed launch (unset:
$SCALECOM_TORCH_BUCKET_MB, <= 0: unbucketed) and ``--no-overlap`` runs the
buckets on the caller's stream. ``--trace-dir`` turns on the telemetry taps
and the recorder (``DIR/trace.json`` and ``DIR/events.jsonl``, summarized
by ``python -m repro_torch.obs.report``); ``--checkpoint-dir`` saves the
train state at half the steps. Each worker's gradient comes from one
batched pass over all workers. ``--preflight-scenarios`` runs the fault
harness (``repro_torch.harness``) at the run's workers, compressor, chunk,
groups and residue dtype on the run's device before the model is built,
and aborts the launch on any invariant violation (``preflight``).
``--autotune`` waits (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch import obs
from repro_torch.backends import resolve_backend
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import make_batches, model_inputs
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainLoop, init_train_state, run_training


def preflight(names: str, workers: int, compressor: str, chunk: int, groups, residue_dtype: str,
              device="cuda") -> None:
    """Run the failure-scenario harness before a launch, as the reference's
    ``--preflight-scenarios``: each scenario of ``names`` ("all" or a comma
    list) at this topology on ``device``; any violation prints it and raises
    ``SystemExit``, a topology the planner rejects raises its ValueError."""
    from repro_torch.harness.scenarios import run_scenario, scenario_names

    for name in scenario_names(names):
        res = run_scenario(
            name, workers, compressor=compressor, chunk=chunk, groups=groups,
            residue_dtype=residue_dtype, device=device,
        )
        print(f"[launch.train] preflight {name}: "
              f"dist={res.final_distance:.4f}/{res.tolerance:.4f} "
              f"{'ok' if res.passed else 'VIOLATION'}")
        if not res.passed:
            for v in res.violations:
                print(f"[launch.train]   {v}")
            raise SystemExit(f"preflight scenario {name!r} failed")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-transformer-base",
                    help=f"architecture id; its SMOKE variant trains: {', '.join(registry.ARCHS)}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adam", "rmsprop"])
    ap.add_argument("--compressor", default="clt_k",
                    choices=["clt_k", "true_topk", "local_topk", "random_k", "none"])
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--warmup-steps", type=int, default=10)
    ap.add_argument("--residue-dtype", default="fp32", choices=["fp32", "bf16", "fp8", "fp8_ec"])
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--backend", default="auto", choices=["auto", "torch", "cuda"],
                    help="kernel backend for the chunked reduce ops (auto: "
                         "$SCALECOM_TORCH_BACKEND, else the device decides)")
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="bucketed reduce: pack tensors into ~this many MB per launch "
                         "bucket (core.overlap). Default: $SCALECOM_TORCH_BUCKET_MB if "
                         "set, else unbucketed; <= 0 forces unbucketed")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the buckets on the caller's stream instead of a side "
                         "CUDA stream (same numerics)")
    ap.add_argument("--preflight-scenarios", default=None, metavar="NAMES",
                    help="before training, run the failure-scenario harness "
                         "(repro_torch.harness) at this worker count / compressor / "
                         "chunk / groups / residue dtype on the run's device: "
                         "comma-separated scenario names or 'all'. Any invariant "
                         "violation (or a topology the planner rejects) aborts the launch")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="enable the telemetry subsystem (repro_torch.obs): metric taps on "
                         "the reduce (measured wire bytes, build-up, contraction gamma, "
                         "codec error), wall-clock step spans, and write DIR/trace.json "
                         "(Chrome trace, Perfetto-loadable) + DIR/events.jsonl (summarize "
                         "with `python -m repro_torch.obs.report`)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="with --trace-dir: sample the paper's residue-similarity "
                         "diagnostics (core.metrics.residue_similarity_report) every N "
                         "steps. 0 disables")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    if args.metrics_every and not args.trace_dir:
        ap.error("--metrics-every requires --trace-dir (the similarity taps "
                 "need the telemetry run to land anywhere)")

    if args.arch not in registry.ARCHS:  # as the reference: exit naming the ids
        raise SystemExit(f"unknown arch {args.arch}; choices: {list(registry.ARCHS)}")
    cfg = registry.smoke(args.arch)
    device = resolve_device(args.device)
    print(f"[launch.train] torch {torch.__version__} on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if args.preflight_scenarios:
        preflight(args.preflight_scenarios, args.workers, args.compressor, args.chunk,
                  args.groups, args.residue_dtype, device)

    model = build_model(cfg, loss_chunk=64)
    # --bucket-mb: None -> "auto" ($SCALECOM_TORCH_BUCKET_MB), <= 0 ->
    # unbucketed, > 0 -> bucketed at that size
    bucket_bytes = ScaleComConfig.bucket_bytes
    if args.bucket_mb is None:
        buckets = None
    elif args.bucket_mb <= 0:
        buckets = False
    else:
        buckets, bucket_bytes = True, int(args.bucket_mb * (1 << 20))
    sc_cfg = ScaleComConfig(
        compressor=CompressorConfig(args.compressor, chunk=args.chunk),
        beta=args.beta,
        min_size=1024,
        residue_dtype=args.residue_dtype,
        groups=args.groups,
        backend=args.backend,
        warmup_steps=args.warmup_steps,
        bucket_bytes=bucket_bytes,
        overlap=not args.no_overlap,
        telemetry=args.trace_dir is not None,
        metrics_every=args.metrics_every,
    )
    opt = make_optimizer(args.optimizer)
    sched = schedule.linear_warmup(schedule.constant(args.lr), args.warmup_steps)
    state = init_train_state(model, opt, sc_cfg, torch.Generator().manual_seed(args.seed),
                             n_workers=args.workers, device=device)
    loop = TrainLoop(model=model, optimizer=opt, schedule=sched, sc_cfg=sc_cfg,
                     n_workers=args.workers, checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=max(args.steps // 2, 1) if args.checkpoint_dir else 0,
                     log_every=args.log_every, buckets=buckets)
    batches = make_batches(cfg.vocab, args.workers, args.local_batch, args.seq, seed=args.seed,
                           **model_inputs(cfg))
    telemetry = None
    if args.trace_dir:
        telemetry = obs.TelemetryRun(
            args.trace_dir,
            backend_name=resolve_backend(args.backend, device).name,
            extra_provenance={"arch": args.arch, "compressor": args.compressor,
                              "workers": args.workers},
        )
    # run_training's default log is the port's (silent by default) logger;
    # the CLI is the consumer that wants visible step lines
    obs.enable_console_logging()
    try:
        state, history = run_training(loop, state, batches, args.steps, telemetry=telemetry)
    finally:
        if telemetry is not None:
            paths = telemetry.close()
            print(f"[launch.train] trace -> {paths['trace']}")
            print(f"[launch.train] events -> {paths['events']} "
                  f"(summarize: python -m repro_torch.obs.report {paths['events']})")
    final = history[-1]
    print(f"final: loss={final['loss']:.4f} at step {final['step']}")
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
