"""Hierarchical multi-pod ScaleCom on the CUDA card: dense intra-pod, CLT-k
across pods. The port of ``examples/multipod_groups.py``.

Simulates POD_COUNT pods of RANKS_PER_POD data ranks each, stacked on one
device. With ``ScaleComConfig(groups=POD_COUNT)`` the reduce is two-level:

  * intra-pod: the RANKS_PER_POD gradients inside each pod are averaged
    densely (the fast intra-pod all-reduce; free in this model), and
  * inter-pod: CLT-k runs across the POD_COUNT pod-mean gradients, so the
    slow link between pods only carries k values + k indices per step
    instead of the dense gradient.

The script trains a transformer this way, then checks the measured per-step
payload (``comm_bytes_*`` from scalecom_reduce's stats) against the byte
accounting of the Appendix-F performance model
(``repro_torch.analysis.perfmodel``): it *asserts* the predicted byte
reduction between pods, it does not just print it.

    PYTHONPATH=src python examples_torch/multipod_groups.py [--device cpu]

It runs on the card by default and raises without CUDA; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU. ``main`` takes
``steps``, ``device``, ``cfg`` (default the paper transformer's SMOKE width)
and ``init`` (a ``TrainState`` in place of the seed-0 draw, which a CPU
generator makes).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.analysis.perfmodel import PerfConfig, _comm_bytes  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.plan import payload_bytes  # noqa: E402
from repro_torch.core.scalecom import ScaleComConfig  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import make_optimizer, schedule  # noqa: E402
from repro_torch.training import TrainLoop, init_train_state, run_training  # noqa: E402

POD_COUNT = 2          # ScaleCom workers = pods (groups=2)
RANKS_PER_POD = 4      # dense intra-pod reduction
CHUNK = 64             # compression rate between pods (topm=1)
MIN_SIZE = 512
STEPS, WARMUP = 24, 4
LOCAL_BATCH, SEQ = 2, 64


def _payload_prediction(params) -> tuple[float, float, float]:
    """(k_values, bytes_up, bytes_dense) per step from the parameter shapes:
    the same one-rule accounting scalecom_reduce's plan stage uses
    (core.plan.payload_bytes: 4 B per value each pod, the leader's
    4 B-per-index broadcast amortized over the pods; dense fp32 below
    MIN_SIZE)."""
    comp = CompressorConfig("clt_k", chunk=CHUNK)
    k = up = dense = 0.0
    for leaf in tree.leaves(params):
        size = leaf.numel()
        dense += 4.0 * size
        if size < MIN_SIZE:
            up += 4.0 * size
        else:
            n_chunks = math.ceil(size / CHUNK)
            k += n_chunks
            up += payload_bytes(comp, n_chunks, POD_COUNT)
    return k, up, dense


def setup(*, device="cuda", cfg=None, init=None):
    """The reference ``main``'s loop, initial state and batches:
    (loop, state, batches)."""
    dev = resolve_device(device)
    n_ranks = POD_COUNT * RANKS_PER_POD
    cfg = registry.smoke("paper-transformer-base") if cfg is None else cfg
    model = build_model(cfg, compute_dtype="float32", loss_chunk=16)
    sc = ScaleComConfig(
        compressor=CompressorConfig("clt_k", chunk=CHUNK),
        beta=0.3,
        min_size=MIN_SIZE,
        groups=POD_COUNT,
        warmup_steps=WARMUP,
    )
    opt = make_optimizer("sgdm")
    loop = TrainLoop(model=model, optimizer=opt, schedule=schedule.constant(0.05), sc_cfg=sc,
                     n_workers=n_ranks, log_every=8)
    if init is None:
        init = init_train_state(model, opt, sc, torch.Generator().manual_seed(0),
                                n_workers=n_ranks, device=dev)
    return loop, init, make_batches(cfg.vocab, n_ranks, LOCAL_BATCH, SEQ, seed=0)


def check_pod_residues(state) -> None:
    """Hierarchical residue granularity: one EF memory per POD, not per rank."""
    for path, enc in state.sc_state.residues.items():
        lead = tree.leaves(enc)[0].shape[0]
        if lead != POD_COUNT:
            raise AssertionError((path, lead))


def check_dcn_bytes(params, hist) -> dict:
    """The reference's three checks after training: the last loss below the
    first; the last (compressed) step's payload equal to the parameter shapes'
    accounting at rtol 1e-6; the measured byte reduction between pods within
    x0.85-1.15 of the perf model's. Prints as the reference; returns the
    numbers."""
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"training did not learn: loss {hist[0]['loss']} -> "
                             f"{hist[-1]['loss']}")
    last = hist[-1]  # a compressed step (past warmup)
    meas_up = last["comm_bytes_per_worker"]
    meas_dense = last["comm_bytes_dense"]
    k, pred_up, pred_dense = _payload_prediction(params)
    np.testing.assert_allclose(meas_up, pred_up, rtol=1e-6)
    np.testing.assert_allclose(meas_dense, pred_dense, rtol=1e-6)

    # Full round trip between pods, per pod: up (the plan's transmit payload)
    # + down (k reduced values + the received k-index broadcast) against the
    # dense scheme's gradient up + gradient down. The measured reduction and
    # the Appendix-F model's byte formulas at the same (params, rate, workers)
    # point must agree to tail-chunk rounding.
    meas_ratio = (2 * meas_dense) / (meas_up + 8.0 * k)
    P = sum(leaf.numel() for leaf in tree.leaves(params))
    pm = PerfConfig(params=P, compression=CHUNK, workers=POD_COUNT, topology="ps")
    pred_ratio = _comm_bytes(pm, "none") / _comm_bytes(pm, "scalecom")
    print(f"per-pod DCN bytes/step: scalecom={meas_up + 8 * k:,.0f} "
          f"dense={2 * meas_dense:,.0f}")
    print(f"DCN-byte reduction: measured {meas_ratio:.1f}x, "
          f"perfmodel predicts {pred_ratio:.1f}x")
    if not 0.85 * pred_ratio < meas_ratio < 1.15 * pred_ratio:
        raise AssertionError((meas_ratio, pred_ratio))
    print("OK: hierarchical CLT-k hits the perf model's DCN reduction.")
    return dict(k=k, meas_up=meas_up, meas_dense=meas_dense, pred_up=pred_up,
                pred_dense=pred_dense, meas_ratio=meas_ratio, pred_ratio=pred_ratio)


def main(steps: int = STEPS, *, device="cuda", cfg=None, init=None) -> dict:
    loop, state, batches = setup(device=device, cfg=cfg, init=init)
    check_pod_residues(state)
    print(f"--- {POD_COUNT} pods x {RANKS_PER_POD} ranks, CLT-k across pods "
          f"(chunk={CHUNK}) ---")
    state, hist = run_training(loop, state, batches, steps)
    return check_dcn_bytes(state.params, hist)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=ap.parse_args().device)
