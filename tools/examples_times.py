"""Wall time of each ``examples_torch/`` script run alone, as a user runs it.

Builds the kernels once (``repro_torch.kernels.build.library``), then runs
each of the five scripts in a fresh interpreter (``python3
examples_torch/<name>.py [--device cpu]``) and prints its exit code and the
seconds from its start to its exit: the interpreter's start, the imports,
the card's initialisation and the script's work. Each script's output goes
to ``<out>/<name>.log``. Prints the card's name and power limit first.

    PYTHONPATH=src python3 tools/examples_times.py --out DIR [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
EXAMPLES = ("quickstart", "large_batch_lowpass", "multipod_groups", "compressor_playground",
            "serve_decode")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory for each script's output")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        print(smi.stdout.strip())
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        build.library()
        print(f"build {time.perf_counter() - t0:.1f} s")
    failed = 0
    for name in EXAMPLES:
        cmd = [sys.executable, os.path.join(ROOT, "examples_torch", f"{name}.py")]
        if args.device == "cpu":
            cmd += ["--device", "cpu"]
        with open(os.path.join(args.out, f"{name}.log"), "w") as log:
            t0 = time.perf_counter()
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, timeout=900).returncode
        print(f"{name}: rc {rc}, {time.perf_counter() - t0:.1f} s on {args.device}")
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
