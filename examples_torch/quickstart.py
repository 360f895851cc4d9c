"""Quickstart on the CUDA card: train a small LM with ScaleCom gradient
compression, then compare against the uncompressed baseline (the paper's
Table-2 experiment). The port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

It runs on the card by default and raises without CUDA; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU. ``train`` and ``setup``
take ``device``, ``cfg`` (default the paper transformer's SMOKE width, as in
the reference), ``steps`` and ``init`` (a ``TrainState`` to start from in
place of the seed-0 draw). The initial weights come from a CPU generator,
so the card and the CPU start from the same values.

The telemetry recorder (``python -m repro_torch.launch.train --trace-dir D
--metrics-every N``, then ``python -m repro_torch.obs.report
D/events.jsonl``) and the fault harness (``python -m repro_torch.harness
--scenarios all``) run the same path with their taps on. With
``ScaleComConfig(fused=True)`` (or ``SCALECOM_TORCH_FUSED=1`` and the default
``fused="auto"``) each tensor's select, EF update and scatter run as one
kernel launch.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.scalecom import ScaleComConfig  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import make_optimizer, schedule  # noqa: E402
from repro_torch.training import TrainLoop, init_train_state, run_training  # noqa: E402

WORKERS, STEPS = 8, 60
LOCAL_BATCH, SEQ = 2, 64


def setup(compressor: str, chunk: int = 64, beta: float = 1.0, *, device="cuda", cfg=None,
          init=None):
    """The reference ``train``'s loop, initial state and batches:
    (loop, state, batches)."""
    dev = resolve_device(device)
    cfg = registry.smoke("paper-transformer-base") if cfg is None else cfg
    model = build_model(cfg, compute_dtype="float32", loss_chunk=16)
    sc = ScaleComConfig(
        compressor=CompressorConfig(compressor, chunk=chunk),
        beta=beta,
        min_size=512,
        warmup_steps=5,  # the paper trains a few epochs dense first
    )
    opt = make_optimizer("sgdm")
    loop = TrainLoop(model=model, optimizer=opt, schedule=schedule.constant(0.05), sc_cfg=sc,
                     n_workers=WORKERS, log_every=20)
    if init is None:
        init = init_train_state(model, opt, sc, torch.Generator().manual_seed(0),
                                n_workers=WORKERS, device=dev)
    return loop, init, make_batches(cfg.vocab, WORKERS, LOCAL_BATCH, SEQ, seed=0)


def train(compressor: str, chunk: int = 64, beta: float = 1.0, *, device="cuda", cfg=None,
          steps: int = STEPS, init=None) -> float:
    """``steps`` steps (the first 5 dense); the final loss."""
    loop, state, batches = setup(compressor, chunk, beta, device=device, cfg=cfg, init=init)
    print(f"--- {compressor} (chunk={chunk}, beta={beta}) ---")
    _, hist = run_training(loop, state, batches, steps)
    return hist[-1]["loss"]


def overlap_preview(bucket_mb: float = 25.0) -> dict:
    """The overlap-aware bucketed launch: what ``--bucket-mb`` buys.

    The trainer turns it on with ``python -m repro_torch.launch.train
    --bucket-mb 25`` (or ``SCALECOM_TORCH_BUCKET_MB=25``; ``--no-overlap``
    keeps the buckets on the caller's stream). This prints the modeled
    timeline for the paper's transformer: how much of the compressed
    all-reduce hides behind the backward pass at this bucket size.
    """
    from repro_torch.analysis.perfmodel import overlap_report, reference_transformer_perf

    rep = overlap_report(reference_transformer_perf(), "scalecom", int(bucket_mb * (1 << 20)))
    print(f"\n--- overlap model: transformer-base, --bucket-mb {bucket_mb:g} ---")
    print(f"buckets={rep['n_buckets']}  "
          f"hidden_fraction={rep['hidden_fraction']:.2f}  "
          f"exposed_comm={rep['exposed_comm'] * 1e3:.2f}ms  "
          f"speedup_vs_one_shot={rep['speedup_vs_unbucketed']:.2f}x")
    return rep


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    # run_training logs through the (silent by default) repro_torch logger;
    # a console consumer opts in:
    obs.enable_console_logging()
    dense = train("none", device=args.device)
    scalecom = train("clt_k", chunk=64, beta=1.0, device=args.device)
    print(f"\nfinal loss  dense={dense:.4f}  scalecom(64x)={scalecom:.4f}  "
          f"gap={scalecom - dense:+.4f}")
    print("ScaleCom trains to ~baseline loss while all-reducing 64x fewer bytes.")
    overlap_preview()
    return dense, scalecom


if __name__ == "__main__":
    main()
