#!/usr/bin/env python3
"""Device time of chunk_scatter and chunk_gather at the tok_embed shapes for
the kernels of one checkout, and the unit in which the card fetches the
gather's reads from device memory.

    python3 tools/scatter_gather_ab.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch`` is
timed (default: this one's); its kernels are built from that checkout's
sources. To compare two designs on one card, run it on both checkouts in one
session, in turns (A, B, B, A). Needs one CUDA card. Times are per call, from
``chip_smoke.device_ms`` (20 calls queued while the card is held, then run
back to back between two CUDA events, with an exact launch count).

Shapes: the tok_embed tensor over 8 workers (296,000 chunk rows of 64 per
worker). The scatter writes 296,000 rows at top-1, 2 and 8; the gather reads
2,368,000 rows through a shared (296,000,) set or a per-worker set, at
top-1 and 2. The fetch-unit probe gathers two offsets per row of the same
rows, placed in one 32-byte sector, in two sectors of one 64-byte segment,
in two 64-byte segments of one 128-byte line, or in two 128-byte lines: the
time steps up where the pair first spans two of the units the card fetches.
Prints one line per measurement and, last, one JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this checkout", help="a name for the printed lines")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    import chip_smoke as cs

    cs.check(torch.cuda.is_available(), "no CUDA card")
    from repro_torch.kernels import chunk_topk as ct

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"[ab] {args.label}: repro_torch from {os.path.dirname(ct.__file__)}")
    G, R, C = cs.G, cs.R, cs.CHUNK
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def line(key, ms, bound_ms, bound64_ms=None):
        out[key] = dict(ms=ms, bound_ms=bound_ms, bound_64_ms=bound64_ms)
        extra = "" if bound64_ms is None else f", {bound64_ms:.4f} by 64-byte segments"
        print(f"[ab] {args.label}: {key} {ms:.4f} device ms; bound {bound_ms:.4f}{extra} on {card}")

    for topm in (1, 2, 8):
        shape = (R,) if topm == 1 else (R, topm)
        vals = torch.randn(shape, device="cuda", generator=gen)
        idx = torch.randint(0, C, shape, device="cuda", generator=gen, dtype=torch.int32)
        cs.check(cs.bitwise(ct.chunk_scatter(vals, idx, C), ct.chunk_scatter_plain(vals, idx, C)),
                 f"chunk_scatter top-{topm} differs from plain")
        ms = cs.device_ms(lambda: ct.chunk_scatter(vals, idx, C), (cs.counter("chunk_scatter"), 1))
        line(f"chunk_scatter top-{topm}", ms, cs.bound(R * topm * 8 + R * C * 4, 0)[0])
    del vals, idx

    x = torch.randn(G * R, C, device="cuda", generator=gen)
    first = torch.randint(0, C, (G * R,), device="cuda", generator=gen, dtype=torch.int32)
    second = (first + torch.randint(1, C, (G * R,), device="cuda", generator=gen,
                                    dtype=torch.int32)) % C
    sets = {"shared top-1": first[:R], "per-worker top-1": first,
            "shared top-2": torch.stack([first[:R], second[:R]], 1),
            "per-worker top-2": torch.stack([first, second], 1)}
    # the probe: a row's second offset at offset ^ d lies d floats away within
    # an aligned block of 2d floats (d = 1: one sector; 8: one 64-byte segment ...)
    for d, where in ((1, "one sector"), (8, "two sectors of one 64-byte segment"),
                     (16, "two 64-byte segments of one 128-byte line"),
                     (32, "two 128-byte lines")):
        sets[f"probe, offsets in {where}"] = torch.stack([first[:R], first[:R] ^ d], 1)
    for key, ids in sets.items():
        ids = ids.contiguous()
        cs.check(cs.bitwise(ct.chunk_gather(x, ids), ct.chunk_gather_plain(x, ids)),
                 f"chunk_gather {key} differs from plain")
        ms = cs.device_ms(lambda ids=ids: ct.chunk_gather(x, ids), (cs.counter("chunk_gather"), 1))
        line(f"chunk_gather {key}", ms, cs.bound(cs.gather_bytes(ids, G * R), 0)[0],
             cs.bound(cs.gather_bytes(ids, G * R, 64), 0)[0])
    print(json.dumps({"label": args.label, "card": card, "times": out}))


if __name__ == "__main__":
    main()
