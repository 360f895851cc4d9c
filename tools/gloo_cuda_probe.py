"""What gloo does with CUDA tensors: which collectives it takes, how its async
calls synchronise, and what packing several tensors into one call changes.

Spawns ``--world`` gloo ranks on the one card (a ``file://`` store in a
temporary directory; 8 by default, the ring's world in ``chip_smoke.py``)
and, on each:

1. calls ``broadcast``, ``all_reduce``, ``all_gather`` and
   ``all_gather_into_tensor`` on int32 and float32 CUDA tensors, checking
   each result;
2. ``async_op=True`` on tensors a side stream writes: the side stream spins
   ``--spin-ms`` and then fills x; the async all_reduce (and broadcast) is
   issued on that stream and waited for. It prints the host ms of the issue
   and of ``wait()``, whether the result is right when read on the stream
   that waited and when read at once on another stream, and whether that
   stream still had work queued after ``wait()`` returned (the copy back
   from host memory);
3. issues async all_reduces of 64 MB down to 64 KB, largest first, and
   prints the order in which they complete (``is_completed()`` polled);
4. all-reduces the values of one compressed step of the main path
   (paper-transformer-base, chunk 64: the 17 compressed tensors' k values)
   one call per tensor and as one packed call, and counts the elements
   whose sums differ bit for bit;
5. times (host ms between device syncs, median of ``--reps``) those values'
   all-reduce and the offsets' broadcast: 17 blocking calls, 17 async calls
   waited for together, and one packed call.

Prints one line per finding and the torch, CUDA and card versions; exits 1
if any collective that ``repro_torch.distributed.ring`` calls fails.

    python3 tools/gloo_cuda_probe.py [--world 8] [--reps 5] [--spin-ms 50]
"""

import argparse
import datetime
import multiprocessing
import os
import statistics
import sys
import tempfile
import time

USED = ("broadcast", "all_reduce", "all_gather")  # what the ring calls
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_sizes():
    """k of each compressed tensor of one main-path step (the plan at chunk
    64, min_size 1024, 8 workers)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.plan import plan_tensors
    from repro_torch.core.scalecom import ScaleComConfig
    from repro_torch.models import build_model

    params = build_model(registry.arch("paper-transformer-base"), compute_dtype="float32").init(
        torch.Generator().manual_seed(0), "cpu")
    flat = tree.flatten_with_path(params)
    sc = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=64), min_size=1024)
    plans = plan_tensors(tuple((p, tuple(v.shape), 8) for p, v in flat), sc,
                         frozenset(p for p, v in flat if v.numel() >= 1024))
    return [p.k for p in plans if not p.dense]


def _collectives(world: int, rank: int) -> dict:
    import torch
    import torch.distributed as dist

    out = {}
    for dtype in (torch.int32, torch.float32):
        x = torch.arange(4, dtype=dtype, device="cuda") + 10 * rank
        calls = {
            "broadcast": lambda: (dist.broadcast(y := x.clone(), src=1), y)[1],
            "all_reduce": lambda: (dist.all_reduce(y := x.clone()), y)[1],
            "all_gather": lambda: (dist.all_gather(ys := [torch.empty_like(x) for _ in
                                                          range(world)], x), torch.cat(ys))[1],
            "all_gather_into_tensor": lambda: (dist.all_gather_into_tensor(
                y := torch.empty(world * 4, dtype=dtype, device="cuda"), x), y)[1],
        }
        base = torch.arange(4, dtype=dtype)
        want = {
            "broadcast": base + 10,
            "all_reduce": world * base + 10 * sum(range(world)),
            "all_gather": torch.cat([base + 10 * r for r in range(world)]),
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
    return out


def _spin_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that spin about ``ms`` on this card."""
    import torch

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    cycles = 10_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return int(cycles * ms / start.elapsed_time(end))


def _async_wait(world: int, rank: int, spin_ms: float) -> dict:
    """The side-stream probe (2) for an all_reduce and a broadcast."""
    import torch
    import torch.distributed as dist

    cycles = _spin_cycles(spin_ms)
    side, other = torch.cuda.Stream(), torch.cuda.Stream()
    out = {}
    for op in ("all_reduce", "broadcast"):
        x = torch.zeros(1 << 20, device="cuda")
        want = float(sum(range(1, world + 1)) if op == "all_reduce" else 1 + 1)
        dist.barrier()
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
            x.fill_(rank + 1)
            t0 = time.perf_counter()
            work = (dist.all_reduce(x, async_op=True) if op == "all_reduce" else
                    dist.broadcast(x, src=1, async_op=True))
            t1 = time.perf_counter()
            work.wait()
            t2 = time.perf_counter()
            queued = not side.query()
        with torch.cuda.stream(other):
            early = float(x[-1].item())  # read at once on another stream
        with torch.cuda.stream(side):
            late = float(x[-1].item())
        torch.cuda.synchronize()
        out[op] = {"issue_ms": (t1 - t0) * 1e3, "wait_ms": (t2 - t1) * 1e3,
                   "right_on_waiting_stream": late == want, "right_on_other_stream": early == want,
                   "waiting_stream_busy_after_wait": queued}
    return out


def _issue_order(world: int) -> list:
    """Probe (3): async all_reduces of 64 MB down to 64 KB, largest first;
    the order they complete in."""
    import torch
    import torch.distributed as dist

    sizes = [(64 << 20) >> (2 * i) for i in range(6)]
    bufs = [torch.ones(n // 4, device="cuda") for n in sizes]
    dist.barrier()
    torch.cuda.synchronize()
    works = [dist.all_reduce(b, async_op=True) for b in bufs]
    done = []
    while len(done) < len(works):
        for i, w in enumerate(works):
            if i not in done and w.is_completed():
                done.append(i)
    for w in works:
        w.wait()
    return done


def _timed(fn, reps: int) -> float:
    import torch
    import torch.distributed as dist

    ms = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _packing(rank: int, sizes: list, reps: int) -> dict:
    """Probes (4) and (5) on one step's values and offsets."""
    import torch
    import torch.distributed as dist

    gen = torch.Generator(device="cuda").manual_seed(rank)
    vals = [1e-3 * torch.randn(k, device="cuda", generator=gen) for k in sizes]
    offs = [torch.randint(0, 64, (k,), device="cuda", generator=gen, dtype=torch.int32)
            for k in sizes]
    # (4): one call a tensor against one packed call, bit for bit
    each = [v.clone() for v in vals]
    for v in each:
        dist.all_reduce(v)
    packed = torch.cat(vals)
    dist.all_reduce(packed)
    differ = int((torch.cat(each).view(torch.int32) != packed.view(torch.int32)).sum())

    def blocking(xs, op):
        for x in xs:
            op(x.clone())

    def in_flight(xs, op):
        for w in [op(x.clone(), async_op=True) for x in xs]:
            w.wait()

    def one(xs, op):
        op(torch.cat(xs))

    reduce = dist.all_reduce
    bcast = lambda x, **kw: dist.broadcast(x, src=0, **kw)  # noqa: E731
    times = {}
    for what, xs, op in (("values all_reduce", vals, reduce), ("offsets broadcast", offs, bcast)):
        times[what] = {design: _timed(lambda f=f: f(xs, op), reps)
                       for design, f in (("blocking", blocking), ("async", in_flight),
                                         ("packed", one))}
    return {"differ": differ, "elements": packed.numel(), "times": times}


def rank_main(rank: int, world: int, store: str, conn, reps: int, spin_ms: float,
              sizes: list) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {"collectives": _collectives(world, rank), "async": _async_wait(world, rank, spin_ms),
           "order": _issue_order(world), "packing": _packing(rank, sizes, reps)}
    conn.send(out)
    dist.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=8)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--spin-ms", type=float, default=50.0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the probe is of CUDA tensors")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {args.world} gloo ranks on the card")
    sizes = _step_sizes()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        pipes = [ctx.Pipe(duplex=False) for _ in range(args.world)]
        procs = [ctx.Process(target=rank_main,
                             args=(r, args.world, os.path.join(tmp, "store"), pipes[r][1],
                                   args.reps, args.spin_ms, sizes))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        try:
            results = [pipes[r][0].recv() if pipes[r][0].poll(300) else None
                       for r in range(args.world)]
        finally:
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
    if any(r is None for r in results):
        sys.exit("a rank sent no result")
    failed = False
    for key in results[0]["collectives"]:
        lines = {r["collectives"][key] for r in results}
        print(f"[gloo-cuda] {key[0]} {key[1]}: " + " / ".join(sorted(lines)))
        failed |= key[0] in USED and lines != {"ok"}
    for op in ("all_reduce", "broadcast"):
        rows = [r["async"][op] for r in results]
        print(f"[gloo-async] {op} async_op=True on a side stream that spins {args.spin_ms:.0f} ms "
              f"then writes x: issue host ms median "
              f"{statistics.median(x['issue_ms'] for x in rows):.3f}, wait() host ms median "
              f"{statistics.median(x['wait_ms'] for x in rows):.3f}; result right on the waiting "
              f"stream on {sum(x['right_on_waiting_stream'] for x in rows)} of {len(rows)} ranks, "
              f"read at once on another stream on {sum(x['right_on_other_stream'] for x in rows)}; "
              f"the waiting stream still busy after wait() on "
              f"{sum(x['waiting_stream_busy_after_wait'] for x in rows)}")
    orders = {tuple(r["order"]) for r in results}
    print(f"[gloo-async] 6 async all_reduces of 64 MB down to 64 KB issued largest first "
          f"completed in the order(s) {sorted(orders)} (issue order is (0, 1, 2, 3, 4, 5))")
    pk = [r["packing"] for r in results]
    print(f"[gloo-pack] one step's values ({len(sizes)} tensors, {pk[0]['elements']:,} floats): "
          f"one all_reduce a tensor against one packed all_reduce: "
          f"{max(x['differ'] for x in pk):,} elements differ bit for bit (most on any rank)")
    for what in pk[0]["times"]:
        med = {d: statistics.median(x["times"][what][d] for x in pk) for d in pk[0]["times"][what]}
        print(f"[gloo-pack] {what} of one step's {len(sizes)} tensors, host ms (median over "
              f"ranks of the median of {args.reps}): " + ", ".join(f"{d} {v:.2f}"
                                                                for d, v in med.items()))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
