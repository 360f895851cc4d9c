"""Large-batch ablation on the CUDA card (paper Fig. 5 / Table 3): at a
scaled learning rate, classic error feedback (beta=1) degrades; the
low-pass filter (beta=0.1) rescues convergence. The port of
``examples/large_batch_lowpass.py``.

    PYTHONPATH=src python examples_torch/large_batch_lowpass.py [--device cpu]

It runs on the card by default and raises without CUDA; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU. ``train`` and ``setup``
take ``device``, ``cfg`` (default the paper transformer's SMOKE width),
``steps`` and ``init`` (a ``TrainState`` in place of the seed-0 draw, which
a CPU generator makes).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.scalecom import ScaleComConfig  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import make_optimizer, schedule  # noqa: E402
from repro_torch.training import TrainLoop, init_train_state, run_training  # noqa: E402

WORKERS, STEPS, LR = 16, 80, 0.2
LOCAL_BATCH, SEQ = 4, 64


def setup(compressor: str = "clt_k", beta: float = 1.0, *, device="cuda", cfg=None, init=None):
    """The reference ``train``'s loop, initial state and batches:
    (loop, state, batches)."""
    dev = resolve_device(device)
    cfg = registry.smoke("paper-transformer-base") if cfg is None else cfg
    model = build_model(cfg, compute_dtype="float32", loss_chunk=16)
    sc = ScaleComConfig(compressor=CompressorConfig(compressor, chunk=64),
                        beta=beta, min_size=512, warmup_steps=8)
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(LR), 16)
    loop = TrainLoop(model=model, optimizer=opt, schedule=sched, sc_cfg=sc,
                     n_workers=WORKERS, log_every=20)
    if init is None:
        init = init_train_state(model, opt, sc, torch.Generator().manual_seed(0),
                                n_workers=WORKERS, device=dev)
    return loop, init, make_batches(cfg.vocab, WORKERS, LOCAL_BATCH, SEQ, seed=0)


def train(compressor: str = "clt_k", beta: float = 1.0, *, device="cuda", cfg=None,
          steps: int = STEPS, init=None) -> float:
    """``steps`` steps (the first 8 dense); the final loss."""
    loop, state, batches = setup(compressor, beta, device=device, cfg=cfg, init=init)
    _, hist = run_training(loop, state, batches, steps)
    return hist[-1]["loss"]


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print("=== dense baseline (scaled LR) ===")
    base = train("none", device=args.device)
    print("=== ScaleCom beta=1 (no filter) ===")
    nofilter = train("clt_k", beta=1.0, device=args.device)
    print("=== ScaleCom beta=0.1 (low-pass) ===")
    lowpass = train("clt_k", beta=0.1, device=args.device)
    print(f"\nfinal losses: dense={base:.4f}  beta1={nofilter:.4f}  "
          f"beta0.1={lowpass:.4f}")
    print(f"low-pass filter recovers {nofilter - lowpass:+.4f} of the "
          f"no-filter degradation (paper Fig. 5).")
    return base, nofilter, lowpass


if __name__ == "__main__":
    main()
