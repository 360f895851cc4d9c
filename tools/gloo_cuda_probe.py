"""Which ``torch.distributed`` collectives gloo takes for CUDA tensors.

Spawns two gloo ranks on the one card (a ``file://`` store in a temporary
directory) and calls ``broadcast``, ``all_reduce``, ``all_gather`` and
``all_gather_into_tensor`` on int32 and float32 CUDA tensors, checking each
result. Prints one line per collective (ok, or the error) and the torch,
CUDA and card versions; exits 1 if any collective that
``repro_torch.distributed.ring`` calls fails.

    python3 tools/gloo_cuda_probe.py
"""

import datetime
import multiprocessing
import os
import sys
import tempfile

USED = ("broadcast", "all_reduce", "all_gather")  # what the ring calls
WORLD = 2


def rank_main(rank: int, store: str, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    out = {}
    for dtype in (torch.int32, torch.float32):
        x = torch.arange(4, dtype=dtype, device="cuda") + 10 * rank
        calls = {
            "broadcast": lambda: (dist.broadcast(y := x.clone(), src=1), y)[1],
            "all_reduce": lambda: (dist.all_reduce(y := x.clone()), y)[1],
            "all_gather": lambda: (dist.all_gather(ys := [torch.empty_like(x) for _ in
                                                          range(WORLD)], x), torch.cat(ys))[1],
            "all_gather_into_tensor": lambda: (dist.all_gather_into_tensor(
                y := torch.empty(WORLD * 4, dtype=dtype, device="cuda"), x), y)[1],
        }
        want = {
            "broadcast": torch.arange(4, dtype=dtype) + 10,
            "all_reduce": 2 * torch.arange(4, dtype=dtype) + 10,
            "all_gather": torch.cat([torch.arange(4, dtype=dtype), torch.arange(4, dtype=dtype)
                                     + 10]),
        }
        want["all_gather_into_tensor"] = want["all_gather"]
        for name, call in calls.items():
            try:
                got = call()
                torch.cuda.synchronize()
                ok = got.is_cuda and torch.equal(got.cpu(), want[name])
                out[(name, str(dtype))] = "ok" if ok else f"wrong result {got.tolist()}"
            except (RuntimeError, ValueError, NotImplementedError) as e:
                out[(name, str(dtype))] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            dist.barrier()
    conn.send(out)
    dist.destroy_process_group()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the probe is of CUDA tensors")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        pipes = [ctx.Pipe(duplex=False) for _ in range(WORLD)]
        procs = [ctx.Process(target=rank_main, args=(r, os.path.join(tmp, "store"), pipes[r][1]))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            results = [pipes[r][0].recv() if pipes[r][0].poll(120) else None
                       for r in range(WORLD)]
        finally:
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
    if any(r is None for r in results):
        sys.exit("a rank sent no result")
    failed = False
    for key in results[0]:
        lines = {r[key] for r in results}
        print(f"[gloo-cuda] {key[0]} {key[1]}: " + " / ".join(sorted(lines)))
        failed |= key[0] in USED and lines != {"ok"}
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
