#!/usr/bin/env python3
"""Registers and spills of the kernels of one or more checkouts, as ptxas
reports them, summed per template, mode and block size the way
``chip_smoke.print_ptxas`` prints them.

    python3 tools/ptxas_ab.py [SRC ...]

Each SRC is the ``src`` directory of a checkout (default: this one's). Its
``repro_torch`` kernels are built from its own sources into its own
``build/``, every checkout at once, one process each; each build's seconds
are printed beside its lines. Needs a Hopper card and ``nvcc``. To hold a
change's kernels against its parent's, unpack the parent into an ignored
directory (``git archive HEAD | tar -x -C experiments/base``) and pass both
``src`` directories.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; build.library(); "
         "print(json.dumps(build.build_info))")


def main() -> None:
    srcs = [os.path.abspath(s) for s in sys.argv[1:]] or [os.path.join(ROOT, "src")]
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    procs = [subprocess.Popen([sys.executable, "-c", BUILD, src], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for src in srcs]
    outs = [p.communicate() for p in procs]
    for src, proc, (out, err) in zip(srcs, procs, outs):
        cs.check(proc.returncode == 0, f"building the kernels of {src} failed:\n{err}")
        info = json.loads(out.strip().splitlines()[-1])
        print(f"[ptxas] {src}: built in {info['seconds']:.1f} s -> {info['path']}")
        cs.print_ptxas(info["ptxas"])


if __name__ == "__main__":
    main()
