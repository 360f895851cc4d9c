"""Compressor playground on the CUDA card: CLT-k against true top-k,
random-k and local top-k on a synthetic correlated-worker gradient. Prints
contraction coefficients, nonzeros and Hamming distances (the quantities of
the paper's Figs. 2-3 and Table 1). The port of
``examples/compressor_playground.py``.

    PYTHONPATH=src python examples_torch/compressor_playground.py [--device cpu]

It runs on the card by default and raises without CUDA; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU. ``table(ef, chunk)``
takes any worker-stacked (n, size) tensor on either device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import torch  # noqa: E402

from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.compressors import CompressorConfig, compress  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

N, SIZE, CHUNK = 8, 1 << 16, 64
COMPRESSORS = ("true_topk", "clt_k", "random_k", "local_topk")


def correlated_ef(n: int = N, size: int = SIZE, *, device="cuda") -> torch.Tensor:
    """0.7 * a common gradient + 0.3 * each worker's noise, (n, size), drawn
    on ``device`` by a generator seeded 0 there."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    common = torch.randn(size, generator=gen, device=dev)
    return 0.7 * common[None] + 0.3 * torch.randn((n, size), generator=gen, device=dev)


def table(ef: torch.Tensor, chunk: int = CHUNK) -> dict:
    """{compressor: (gamma, nnz, d/k)} of each compressor's ĝ at step 0:
    contraction gamma against the worker mean y, the nonzeros of ĝ, and the
    Hamming distance d/k between worker 0's top-k and y's (k = size // chunk)."""
    y = torch.mean(ef, dim=0)
    k = ef.shape[1] // chunk
    d_over_k = float(metrics.hamming_distance_topk(ef[0], y, k))
    rows = {}
    for name in COMPRESSORS:
        _, _, dense = compress(ef, 0, CompressorConfig(name, chunk=chunk))
        rows[name] = (float(metrics.contraction_gamma(y, dense)), int(torch.count_nonzero(dense)),
                      d_over_k)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ef = correlated_ef(device=ap.parse_args(argv).device)
    print(f"{N} workers, {SIZE} elements, chunk={CHUNK} ({CHUNK}x compression)\n")
    print(f"{'compressor':12s} {'gamma':>8s} {'nnz':>8s} {'d/k':>6s}")
    rows = table(ef, CHUNK)
    for name, (gamma, nnz, d_over_k) in rows.items():
        print(f"{name:12s} {gamma:8.4f} {nnz:8d} {d_over_k:6.3f}")
    print("\nCLT-k ~ true top-k when workers correlate; local top-k's union")
    print(f"has ~{N}x the nonzeros (gradient build-up) yet the same per-worker payload.")
    return rows


if __name__ == "__main__":
    main()
