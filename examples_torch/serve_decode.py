"""Serving on the CUDA card: batched prefill + greedy decode across three
architecture families (dense GQA / RWKV-6 SSM / RG-LRU hybrid) through the
same serve API. The port of ``examples/serve_decode.py``.

    PYTHONPATH=src python examples_torch/serve_decode.py [--device cpu]

It runs on the card by default and raises without CUDA; ``--device cpu``
serves on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARCHS = ("starcoder2-3b", "rwkv6-3b", "recurrentgemma-2b")


def main(device="cuda") -> dict:
    """Each arch's SMOKE variant, 2 prompts of 32 tokens, 8 greedy tokens:
    {arch: (2, 8) token ids}."""
    device = resolve_device(device).type
    out = {}
    for arch in ARCHS:
        print(f"\n=== {arch} ===")
        out[arch] = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "32",
                                "--gen", "8", "--device", device])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
