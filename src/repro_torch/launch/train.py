"""Training entry point: trains the paper transformer's smoke variant with ScaleCom
on synthetic data, simulating n workers on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --workers 8 --steps 200 \
        --compressor clt_k --chunk 64 --beta 0.1 [--device cuda|cpu]

The port of ``repro.launch.train`` for the flags this slice covers. It runs
on the CUDA card by default and raises if there is none; ``--device cpu``
runs the plain PyTorch versions of the kernels instead.
``SCALECOM_TORCH_FUSED=1`` puts clt_k and true_topk tensors on the
single-launch fused reduce. ``--residue-dtype`` picks the residue codec,
``--bucket-mb`` the bucketed launch (unset: $SCALECOM_TORCH_BUCKET_MB,
<= 0: unbucketed) and ``--no-overlap`` runs the buckets on the caller's
stream. Microbatches, checkpointing, preflight scenarios, tracing and
autotune wait (ROADMAP Queue 1 items 14-16).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import make_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainLoop, init_train_state, run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-transformer-base", choices=list(registry.ARCHS))
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.smoke(args.arch)
    print(f"[launch.train] torch {torch.__version__} on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

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
    )
    opt = make_optimizer(args.optimizer)
    sched = schedule.linear_warmup(schedule.constant(args.lr), args.warmup_steps)
    state = init_train_state(model, opt, sc_cfg, torch.Generator().manual_seed(args.seed),
                             n_workers=args.workers, device=device)
    loop = TrainLoop(model=model, optimizer=opt, schedule=sched, sc_cfg=sc_cfg,
                     n_workers=args.workers, log_every=args.log_every, buckets=buckets)
    batches = make_batches(cfg.vocab, args.workers, args.local_batch, args.seq, seed=args.seed)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    state, history = run_training(loop, state, batches, args.steps)
    final = history[-1]
    print(f"final: loss={final['loss']:.4f} at step {final['step']}")
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
