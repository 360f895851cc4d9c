"""Try depth cuts of ``chip_smoke.py``'s ``[arch]`` runs on the card.

For each ``ID=D1,D2,...`` argument, runs ``chip_smoke.arch_phase`` on the
``ARCH_RUNS`` entry of that registry id with ``n_layers`` (and, for an
encoder-decoder, ``encoder_layers``) set to each depth in turn, deepest
first, each in a process of its own, and stops at the first depth that
trains. Every run keeps the entry's workers, batch, sequence, fused
settings and holds; a run alone is not held to the phase's launch check.
Each attempt's output goes to ``build/arch_cuts/<id>_<depth>.log`` under
the checkout; the summary prints its peak-memory lines, or the
out-of-memory error.

A fresh process starts with nothing allocated, where ``chip_smoke.py``'s
``[arch]`` phase starts after the main path's phases: a cut that fits
here with less headroom than they leave allocated does not fit there.

    python3 tools/arch_cuts.py whisper-medium=24,22 recurrentgemma-2b=13,11
"""

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "arch_cuts")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def one(name: str, depth: int) -> None:
    """arch_phase on ``name``'s ARCH_RUNS entry cut to ``depth`` layers."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import chip_smoke
    from repro_torch.configs import registry
    from repro_torch.kernels import build

    build.library()
    base = next(r for r in chip_smoke.ARCH_RUNS if r.name == name)
    cut = dict(n_layers=depth)
    if registry.arch(name).is_encdec:
        cut["encoder_layers"] = depth
    chip_smoke.ARCH_RUNS = (dataclasses.replace(base, cut=cut),)
    chip_smoke.ARCH_KERNELS = ()  # one run launches only its own path's kernels
    chip_smoke.arch_phase(card_line())


def main(args) -> int:
    if args[:1] == ["--one"]:
        one(args[1], int(args[2]))
        return 0
    os.makedirs(OUT, exist_ok=True)
    print(card_line(), flush=True)
    sys.path[:0] = [os.path.join(ROOT, "src")]
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()  # built once; each attempt loads it from build/
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for arg in args:
        name, depths = arg.split("=")
        for depth in sorted((int(d) for d in depths.split(",")), reverse=True):
            log = os.path.join(OUT, f"{name}_{depth}.log")
            t0 = time.perf_counter()
            with open(log, "w") as f:
                rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name,
                                     str(depth)], stdout=f, stderr=subprocess.STDOUT,
                                    timeout=900).returncode
            lines = open(log).read().splitlines()
            shown = [l for l in lines if "peak allocated" in l or "OutOfMemoryError" in l
                     or "FAIL" in l]
            print(f"== {name} at {depth} layers: {'trained' if rc == 0 else f'rc {rc}'}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for line in shown:
                print("   " + line[:400], flush=True)
            if rc == 0:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
