#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one Hopper (sm_90) card, PyTorch built for CUDA and ``nvcc``. It
imports only ``repro_torch`` (never JAX or the ``repro`` package) and fails,
printing no result, without a card or outside a checkout of the repository.
Phases, each fatal on failure:

  1. card and versions: ``nvidia-smi`` name and power limit, torch and CUDA
     versions, and the build of the kernels from ``src/repro_torch/csrc``;
  2. each CUDA kernel against its plain PyTorch version on the card at the
     shapes of the main path (the ``tok_embed`` select over 8 workers'
     stacked residues, shared and per-worker index sets, 1-D and worker-
     stacked scatters, a chunk tail, small shapes full of ties with top-m 1
     and 2), bitwise, with its time beside the plain version's, a PyTorch
     library chain's and the bytes bound;
  3. the main path: ``run_training`` trains paper-transformer-base at full
     width (6 layers, d 512, vocab 37000) with CLT-k, 8 workers of batch 4 x
     128 tokens, 2 dense warm-up steps then 3 compressed steps; the loss must
     be finite and every kernel must have launched 3 times per compressed
     tensor per compressed step (tensor count from the reduce plan);
  4. teacher-forced reduce: from the trained state and from the state before
     the first compressed step, ``scalecom_reduce`` on the "cuda" backend
     must equal the "torch" backend bit for bit; host-clock times of the
     per-worker gradients, the dense gradients and the reduce;
  5. one more compressed step under ``torch.profiler``: device busy time,
     idle share and the kernels that take the most device time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
CSRC = "src/repro_torch/csrc/scalecom_kernels.cu"

# the main path's largest compressed tensor: tok_embed, 37000 x 512, over 8 workers
G, P, CHUNK, BETA = 8, 37000 * 512, 64, 0.1
R = P // CHUNK


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    marks = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes time and the fp32 ops time."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b)


def max_abs_err(a, b) -> float:
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0 for x, y in pairs)


def kernel_phase(card_line: str):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import torch

    from repro_torch.backends import resolve_backend
    from repro_torch.kernels import chunk_topk, ef_update as efk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(G, P, device=dev, generator=gen)
    xr = x.view(-1, CHUNK)
    xr[::997] = torch.randint(-3, 4, xr[::997].shape, device=dev, generator=gen).float()  # ties
    rows = xr.shape[0]
    results = {}

    def record(name, replaces, kern, plain, library, library_name, nbytes, ops):
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        check(equal(out_k, out_p), f"{name}: kernel and plain version differ")
        err = max_abs_err(out_k, out_p)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        library_ms = time_ms(library) if library is not None else None
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(name=name, route="cuda", source=CSRC, replaces=replaces,
                             launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        print(f"[kernel] {name}: bitwise equal to plain; kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms "
              f"{'null' if library_ms is None else f'{library_ms:.4f}'} ({library_name}) "
              f"bound_ms {bound_ms:.4f} ({bound_by}) on {card_line}")

    # select over the worker-stacked EF: (G*R, 64) rows
    record("chunk_argmax", "src/repro/kernels/chunk_topk.py:65",
           lambda: chunk_topk.chunk_argmax(xr), lambda: chunk_topk.chunk_argmax_plain(xr),
           lambda: torch.argmax(xr.abs(), dim=-1), "torch.argmax(x.abs(), -1)",
           rows * CHUNK * 4 + rows * 8, 2 * rows * CHUNK)

    # Eq. 5 update with the shared (R,) leader set, read by all G workers
    m = torch.randn(G, P, device=dev, generator=gen).view(-1, CHUNK)
    g = torch.randn(G, P, device=dev, generator=gen).view(-1, CHUNK)
    idx_shared = chunk_topk.chunk_argmax_plain(xr[:R])[0]
    record("ef_update", "src/repro/kernels/ef_update.py:44",
           lambda: efk.ef_update(m, g, idx_shared, BETA),
           lambda: efk.ef_update_plain(m, g, idx_shared, BETA), None, "no single call",
           3 * rows * CHUNK * 4 + R * 4 + rows * 4, 5 * rows * CHUNK)

    # ghat scatter of the (R,) worker-mean values
    vmean = torch.randn(R, device=dev, generator=gen)
    record("chunk_scatter", "src/repro/kernels/chunk_topk.py:101",
           lambda: chunk_topk.chunk_scatter(vmean, idx_shared, CHUNK),
           lambda: chunk_topk.chunk_scatter_plain(vmean, idx_shared, CHUNK),
           lambda: torch.zeros(R, CHUNK, device=dev).scatter_(
               1, idx_shared.long()[:, None], vmean[:, None]),
           "torch.zeros().scatter_()", R * 8 + R * CHUNK * 4, R * CHUNK)

    # the other main-path forms, bitwise only
    idx_pw = chunk_topk.chunk_argmax_plain(xr)[0]  # per-worker (local_topk) sets
    check(equal(efk.ef_update(m, g, idx_pw, BETA), efk.ef_update_plain(m, g, idx_pw, BETA)),
          "ef_update with per-worker indices differs from plain")
    vpw = torch.randn(rows, device=dev, generator=gen)
    check(equal(chunk_topk.chunk_scatter(vpw, idx_pw, CHUNK),
                chunk_topk.chunk_scatter_plain(vpw, idx_pw, CHUNK)),
          "chunk_scatter of (G, R) values differs from plain")
    tail = torch.randn(G, 1_000_037, device=dev, generator=gen)  # no multiple of 64
    cuda_be, torch_be = resolve_backend("cuda"), resolve_backend("torch")
    check(equal(cuda_be.select(tail, CHUNK), torch_be.select(tail, CHUNK)),
          "select with a chunk tail differs from the torch backend")
    ti = cuda_be.select_indices(tail, CHUNK)
    check(equal(cuda_be.ef_update(tail, tail, ti[3], BETA, CHUNK),
                torch_be.ef_update(tail, tail, ti[3], BETA, CHUNK)),
          "ef_update with a chunk tail differs from the torch backend")
    check(equal(cuda_be.scatter(tail[0, :ti.shape[1]], ti[3], CHUNK, 1_000_037),
                torch_be.scatter(tail[0, :ti.shape[1]], ti[3], CHUNK, 1_000_037)),
          "scatter with a chunk tail differs from the torch backend")
    # small odd shapes full of ties, top-m 1 and 2: the corner cases of the kernels
    for rows_s, chunk_s in ((999, 17), (37, 100), (5, 1)):
        xs = torch.randint(-3, 4, (rows_s, chunk_s), device=dev, generator=gen).float()
        check(equal(chunk_topk.chunk_argmax(xs), chunk_topk.chunk_argmax_plain(xs)),
              f"chunk_argmax differs from plain at ({rows_s}, {chunk_s}) with ties")
        for topm in sorted({1, min(2, chunk_s)}):
            order = torch.rand(rows_s, chunk_s, device=dev, generator=gen).argsort(-1)
            ids = order[:, :topm].to(torch.int32).contiguous()
            ids = ids[:, 0].contiguous() if topm == 1 else ids
            ms, gs = torch.randn(2, rows_s, chunk_s, device=dev, generator=gen)
            check(equal(efk.ef_update(ms, gs, ids, BETA), efk.ef_update_plain(ms, gs, ids, BETA)),
                  f"ef_update differs from plain at ({rows_s}, {chunk_s}), topm {topm}")
            vs = torch.randn(ids.shape, device=dev, generator=gen)
            check(equal(chunk_topk.chunk_scatter(vs, ids, chunk_s),
                        chunk_topk.chunk_scatter_plain(vs, ids, chunk_s)),
                  f"chunk_scatter differs from plain at ({rows_s}, {chunk_s}), topm {topm}")
    torch.cuda.synchronize()
    print("[kernel] per-worker ef_update, (G, R) scatter, chunk-tail select/update/scatter and "
          "small tied shapes with top-m 1 and 2: bitwise equal")
    return results


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)  # a cut run still shows how far it got
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on a CUDA card")
    sys.path.insert(0, SRC)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels, tree
    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.plan import plan_tensors
    from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
    from repro_torch.core.state import ScaleComState, residue_signature
    from repro_torch.data import make_batches
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule
    from repro_torch.training import TrainLoop, init_train_state, run_training
    from repro_torch.training.train_step import dense_grads, per_worker_grads

    # -- 1. card and versions ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    print(f"[card] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s); "
          f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.library()
    spills = [ln.strip() for ln in build.build_info["ptxas"].splitlines()
              if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {build.build_info['seconds']:.1f} s -> {build.build_info['path']}")
    for ln in spills:
        print(f"[build] {ln}")

    # -- 2. kernels against their plain versions -----------------------------
    results = kernel_phase(card_line)

    # -- 3. the main path at full width ----------------------------------------
    cfg = registry.arch("paper-transformer-base")
    warmup, steps, workers = 2, 5, 8
    model = build_model(cfg, loss_chunk=64)
    sc_cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                            min_size=1024, warmup_steps=warmup)
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(0.05), warmup)
    state = init_train_state(model, opt, sc_cfg, torch.Generator().manual_seed(0),
                             n_workers=workers, device="cuda")
    plans = plan_tensors(
        tuple((p, tuple(v.shape), workers) for p, v in tree.flatten_with_path(state.params)),
        sc_cfg, residue_signature(state.sc_state.residues))
    n_compressed = sum(not p.dense for p in plans)
    print(f"[train] {cfg.name}: {cfg.param_count():,} parameters, {n_compressed} of "
          f"{len(plans)} tensors compressed")
    loop = TrainLoop(model=model, optimizer=opt, schedule=sched, sc_cfg=sc_cfg,
                     n_workers=workers, log_every=1)
    batches = make_batches(cfg.vocab, workers, 4, 128, seed=0)
    before = ScaleComState(
        residues={k: {"q": torch.zeros_like(v["q"])} for k, v in state.sc_state.residues.items()},
        t=warmup)
    torch.cuda.synchronize()
    kernels.reset_launches()
    state, history = run_training(loop, state, batches, steps, log=None)
    torch.cuda.synchronize()
    launches = kernels.launches()
    per_step = [history[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                         for a, b in zip(history, history[1:])]
    for h, dt in zip(history, per_step):
        kind = "compressed" if loop.compressed_at(h["step"]) else "dense"
        print(f"[train] step {h['step']} {kind}: loss {h['loss']:.4f} gnorm {h['grad_norm']:.4f} "
              f"lr {h['lr']:.3f} {dt * 1e3:.1f} ms on {card_line}")
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"non-finite loss or grad norm at step {h['step']}")
    want = n_compressed * (steps - warmup)
    print(f"[train] launches {launches} (want {want} each: {n_compressed} tensors x "
          f"{steps - warmup} compressed steps)")
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times on the main path, want {want}")
        results[name]["launches"] = n

    # -- 4. teacher-forced reduce: cuda backend == torch backend ---------------
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(batches).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, gpw = per_worker_grads(model, state.params, batch, workers)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dense_grads(model, state.params, batch)
    torch.cuda.synchronize()
    print(f"[time] per_worker_grads ({workers} workers x 4 x 128 tokens): "
          f"{(t1 - t0) * 1e3:.1f} ms; dense_grads (the same {workers * 4} x 128 tokens folded): "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms (host clock) on {card_line}")
    for label, sc_state in (("trained", state.sc_state), ("before-first-compressed", before)):
        out_c = scalecom_reduce(gpw, sc_state, dataclasses.replace(sc_cfg, backend="cuda"))
        out_t = scalecom_reduce(gpw, sc_state, dataclasses.replace(sc_cfg, backend="torch"))
        torch.cuda.synchronize()
        for (path, a), (_, b) in zip(tree.flatten_with_path(out_c[0]),
                                     tree.flatten_with_path(out_t[0])):
            check(torch.equal(a, b), f"{label}: ghat {path} differs between backends")
            check(bool(torch.isfinite(a).all()), f"{label}: ghat {path} is not finite")
        for path, enc in out_t[1].residues.items():
            check(torch.equal(out_c[1].residues[path]["q"], enc["q"]),
                  f"{label}: residue {path} differs between backends")
        check(out_c[1].t == out_t[1].t == sc_state.t + 1, f"{label}: step counter")
        print(f"[reduce] {label} state (t={sc_state.t}): cuda backend == torch backend, bitwise")
        del out_c, out_t
    for name in ("cuda", "torch"):
        cfg_b = dataclasses.replace(sc_cfg, backend=name)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            scalecom_reduce(gpw, state.sc_state, cfg_b)
        torch.cuda.synchronize()
        print(f"[reduce] scalecom_reduce on the {name} backend: "
              f"{(time.perf_counter() - t0) / reps * 1e3:.2f} ms per call (host clock, "
              f"{reps} calls) on {card_line}")
    print(f"[memory] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del gpw

    # -- 5. where a compressed step's time goes ---------------------------------
    step_batch = next(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = loop.step(state, step_batch, steps)
        check(math.isfinite(float(metrics["loss"])), "non-finite loss in the profiled step")
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if busy_ms > 0:
        print(f"[profile] one compressed step under torch.profiler: {wall_ms:.1f} ms host clock, "
              f"{busy_ms:.1f} ms device busy, idle share {1 - busy_ms / wall_ms:.3f} "
              f"on {card_line}")
        for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:100]}")
    else:
        print(f"[profile] device time not measured: torch.profiler recorded no device events "
              f"({wall_ms:.1f} ms host clock)")

    print(json.dumps({"kernels": [results[k] for k in ("chunk_argmax", "ef_update",
                                                        "chunk_scatter")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
