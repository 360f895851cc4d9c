"""``chip_smoke.py``'s ``[tp]`` phase alone on the card: the ``TP_RUNS``
cells named by their archs (the tensor-parallel step at full width, held
against the stacked step), with ``--configs`` the ``TP_CONFIGS``
(paper-transformer-base's configurations on (4 data, 2 model)), and with
``--fsdp`` the ``[fsdp]`` cell (the reference's fsdp policy on (2 pod, 2
data, 2 model), ``chip_smoke.fsdp_run_rank``).

Builds the kernels once (``repro_torch.kernels.build.library``), spawns
``chip_smoke.RING_WORLD`` (8) ranks on the one card, joined by gloo through
a ``file://`` store in a temporary directory, each running
``chip_smoke.tp_run_rank`` for the named cells and then, with
``--configs``, ``chip_smoke.tp_configs_rank`` and with ``--fsdp``
``chip_smoke.fsdp_run_rank``, and prints what they measured as the whole
script does (``chip_smoke.tp_phase``'s ``[tp:...]`` lines and
``chip_smoke.fsdp_phase``'s ``[fsdp:...]`` ones, each cell's seconds on
rank 0). A rank that fails, or ranks that
outlast ``TIMEOUT_S`` seconds, exit non-zero. Prints the card's name and
power limit first.

    python3 tools/tp_cells.py recurrentgemma-2b whisper-medium
    python3 tools/tp_cells.py --configs
    python3 tools/tp_cells.py --fsdp
"""

import argparse
import datetime
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from multiprocessing import connection

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import chip_smoke as cs  # noqa: E402

TIMEOUT_S = 700  # from the spawn to the last rank's result


def rank_main(rank: int, world: int, store: str, runs: tuple, configs: bool, fsdp: bool,
              conn) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(cs.RING_BACKEND, init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=cs.RING_TIMEOUT_S))
    out = {"tp": [], "tp_s": []}
    for run in runs:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["tp"].append(cs.tp_run_rank(rank, run))
        out["tp_s"].append(time.perf_counter() - t0)
    if configs:
        torch.cuda.empty_cache()
        out["tp_configs"] = cs.tp_configs_rank(rank)
    if fsdp:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["fsdp"] = cs.fsdp_run_rank(rank)
        out["fsdp_s"] = time.perf_counter() - t0
    conn.send(out)
    dist.destroy_process_group()


def main(argv) -> int:
    sys.stdout.reconfigure(line_buffering=True)
    known = [run.arch for run in cs.TP_RUNS]
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cells", nargs="*", choices=known, metavar="ARCH",
                        help=f"TP_RUNS cells to run, by arch: {', '.join(known)}")
    parser.add_argument("--configs", action="store_true", help="also run TP_CONFIGS")
    parser.add_argument("--fsdp", action="store_true", help="also run the [fsdp] cell")
    args = parser.parse_args(argv)
    if not args.cells and not args.configs and not args.fsdp:
        parser.error("name a cell or pass --configs or --fsdp")
    runs = tuple(run for run in cs.TP_RUNS if run.arch in args.cells)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    print(card)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    world = cs.RING_WORLD
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, os.path.join(tmp, "store"), runs, args.configs,
                                   args.fsdp, pipes[r][1]))
                 for r in range(world)]
        t1 = time.perf_counter()
        results, deadline = {}, time.monotonic() + TIMEOUT_S
        try:
            for p in procs:
                p.start()
            while len(results) < world:
                pending = [r for r in range(world) if r not in results]
                if time.monotonic() > deadline:
                    print(f"ranks {pending} did not finish within {TIMEOUT_S} s",
                          file=sys.stderr)
                    return 1
                connection.wait([pipes[r][0] for r in pending]
                                + [procs[r].sentinel for r in pending], 5)
                for r in pending:
                    if pipes[r][0].poll():
                        results[r] = pipes[r][0].recv()
                    elif procs[r].exitcode not in (None, 0):
                        print(f"rank {r} failed (exit code {procs[r].exitcode})",
                              file=sys.stderr)
                        return 1
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    print(f"[tp] the ranks took {time.perf_counter() - t1:.1f} s from the spawn")
    if runs or args.configs:
        cs.tp_phase(card, results, runs=runs)
    if args.fsdp:
        cs.fsdp_phase(card, results)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
