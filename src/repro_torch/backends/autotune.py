"""Launch-geometry autotuner for the CUDA kernels: the port of
``repro.backends.autotune``.

The reference tunes Pallas ``block_chunks``, the tile height a TPU kernel
streams. On the H100 its counterpart is the block size of the kernel that
the main path launches for each of the three ops the reference tunes:

  select        the vec4 ``chunk_argmax`` (top-1)
  ef_update     ``ef_update`` (a block of threads / 32 warps, a row each)
  fused_reduce  the vec4 fused reduce's clt_k route at top-1

Rows are independent in all three and each row is handled by a fixed set of
lanes, so every candidate gives the same bits and only the time changes.
This module sweeps ``CANDIDATE_THREADS`` on the live card and caches the
winner on disk keyed by the card's name, so the sweep runs once per (card,
op, chunk, dtype, size bucket) and every later process start is a dict
lookup.

Cache file: ``$SCALECOM_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/scalecom_torch/autotune.json`` (never the reference's
``$SCALECOM_AUTOTUNE_CACHE``). Entries are plain JSON:

    {"NVIDIA H100 80GB HBM3|select|c64|float32|nr4194304": 512, ...}

``best_threads`` is the read path the CUDA backend consults for each tuned
launch, keyed by all the launch's rows (workers included); it never times
anything and returns the default on a miss. ``autotune`` is the write path
(the ``--autotune`` flag of ``repro_torch.launch.train`` drives it through
``autotune_params``, at the run's worker count, so the sweep writes the keys
the run's stacked launches read). It times on the card's clock
(``device_ms``: CUDA events around calls queued while the card is held,
since a host clock around a 0.03-0.2 ms kernel measures its launch). On the
CPU (``device="cpu"``) it times the plain versions on the host clock, as the
reference's interpret mode does: the plumbing works, the numbers mean
nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import chunk_topk, ef_update, fused_reduce
from repro_torch.kernels.build import CANDIDATE_THREADS, DEFAULT_THREADS

__all__ = [
    "CANDIDATE_THREADS",
    "autotune",
    "autotune_params",
    "best_threads",
    "cache_path",
    "clear_cache",
    "device_ms",
]

_OPS = ("select", "ef_update", "fused_reduce")

# An op with no cache entry of its own borrows the block size of the op it
# most resembles before giving up to the default: the fused reduce streams
# the same (rows, chunk) rows as ef_update, with the workers in one launch.
_FALLBACK = {"fused_reduce": "ef_update"}

_FUSED_WORKERS = 4  # the fused reduce's worker stack when none is given, as the reference's
_BETA = 0.1
# a spin of this many cycles lasts at least 1 ms on a card clocked up to 2 GHz
_SPIN_CYCLES_PER_MS = 2_000_000

_cache: Optional[Dict[str, int]] = None  # in-process mirror of the file
_names: Dict[int, str] = {}  # card index -> name


def cache_path() -> str:
    env = os.environ.get("SCALECOM_TORCH_AUTOTUNE_CACHE", "").strip()
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "scalecom_torch", "autotune.json")


def _device_kind(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _names:
        _names[index] = torch.cuda.get_device_name(index)
    return _names[index]


def _bucket(rows: int) -> int:
    """Power-of-two size bucket: the best block size is insensitive to +-2x rows."""
    return 1 << max(0, rows - 1).bit_length()


def _key(op: str, chunk: int, rows: int, device) -> str:
    return f"{_device_kind(device)}|{op}|c{chunk}|float32|nr{_bucket(rows)}"


def _load() -> Dict[str, int]:
    """The on-disk cache, read once into the in-process mirror. A corrupt,
    truncated or mistyped file reads as an empty cache: ``best_threads``
    then gives the default and ``autotune`` sweeps again."""
    global _cache
    if _cache is None:
        try:
            with open(cache_path()) as f:
                _cache = {str(k): int(v) for k, v in json.load(f).items()}
        except (OSError, ValueError, TypeError, AttributeError):
            _cache = {}
    return _cache


def _store(key: str, threads: int) -> None:
    cache = _load()
    cache[key] = threads
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # a private temp file, then os.replace: processes sharing the cache
        # see the old whole file or the new whole file, never a torn one
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only file system: keep the in-process mirror only


def clear_cache() -> None:
    """Drop the in-process mirror (the file is left alone)."""
    global _cache
    _cache = None


def best_threads(op: str, rows: int, chunk: int, device="cuda") -> int:
    """The cached block size for ``op`` over ``rows`` chunk rows (all of a
    launch's rows, workers included), or ``DEFAULT_THREADS`` on a miss.

    One dict lookup after the first read (two through ``_FALLBACK``); never
    times anything. A cached size that is not among ``CANDIDATE_THREADS``
    (a stale file) gives the default. An unknown op raises: a typo would
    otherwise pin the default for good.
    """
    if op not in _OPS:
        raise ValueError(f"unknown autotune op {op!r}; known ops: {_OPS}")
    cache = _load()
    got = cache.get(_key(op, chunk, rows, device))
    if got is None and op in _FALLBACK:
        got = cache.get(_key(_FALLBACK[op], chunk, rows, device))
    return got if got in CANDIDATE_THREADS else DEFAULT_THREADS


def _host_ms(fn, iters: int) -> float:
    fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def device_ms(fn, iters: int = 20, warmup: int = 3, launched=None, what: str = "") -> float:
    """Device ms per call of ``fn``: ``iters`` calls queued while the card is
    held in a spin kernel, timed between one pair of CUDA events, so the time
    holds the kernels and the gaps between queued launches but no host
    dispatch. If the card reached the timed calls before the host had queued
    them all, it tries again with a longer hold and a quarter of the calls,
    down to one, and raises a RuntimeError if that does not help. With
    ``launched`` = (a launch counter, launches per call) it raises unless
    the timed calls launched exactly that many kernels per call. ``what``
    names the calls in those errors."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    hold_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1  # twice the time it took to queue them
    torch.cuda.synchronize()
    for _ in range(5):
        before = launched[0]() if launched else 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * _SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()  # the card was still held when the last call was queued
        torch.cuda.synchronize()
        if launched:
            got = launched[0]() - before
            if got != iters * launched[1]:
                raise RuntimeError(f"{what}: {iters} timed calls launched {got} kernels, want "
                                   f"{iters * launched[1]}")
        if ahead:
            return start.elapsed_time(end) / iters
        hold_ms, iters = 2 * hold_ms, max(1, iters // 4)
    raise RuntimeError(f"{what}: the host did not queue {iters} call(s) within a "
                       f"{hold_ms / 2:.1f} ms hold (a host sync in the calls?)")


def autotune(
    op: str,
    size: int,
    chunk: int,
    *,
    workers: Optional[int] = None,
    candidates: Tuple[int, ...] = CANDIDATE_THREADS,
    iters: int = 3,
    seed: int = 0,
    device="cuda",
    timings: Optional[Dict[str, Dict[int, float]]] = None,
) -> int:
    """Sweep ``candidates`` for ``op`` over ``size`` elements a worker (padded
    to a chunk multiple) and cache the winner; returns it.

    op: "select", "ef_update", or "fused_reduce", each launched as the main
    path launches it over a stack of ``workers``: the select over all the
    stack's rows, ef_update over them with one shared index row set, the
    fused clt_k top-1 reduce on the (workers, rows, chunk) stack. The entry
    is keyed by all the launch's rows, workers x chunk rows, as the CUDA
    backend looks it up. ``workers`` None is the reference's sweep: one
    worker for select and ef_update, four for the fused reduce. Raises a
    RuntimeError naming CUDA without a card unless ``device="cpu"``. With
    ``timings``, each candidate's ms per call (the faster of two rounds over
    the candidates) goes into ``timings[cache key]``.
    """
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    dev = resolve_device(device)
    if workers is None:
        workers = _FUSED_WORKERS if op == "fused_reduce" else 1
    rows = -(-size // chunk)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if op == "fused_reduce":
        m, g = normal(workers, rows, chunk), normal(workers, rows, chunk)
        call = lambda t: fused_reduce.fused_reduce(m, g, _BETA, 1, "clt_k", 0, threads=t)  # noqa: E731
    elif op == "ef_update":
        m, g = normal(workers * rows, chunk), normal(workers * rows, chunk)
        idx = torch.zeros(rows, dtype=torch.int32, device=dev)
        call = lambda t: ef_update.ef_update(m, g, idx, _BETA, threads=t)  # noqa: E731
    else:
        x = normal(workers * rows, chunk)
        call = lambda t: chunk_topk.chunk_argmax(x, threads=t)  # noqa: E731
    counts = {"select": chunk_topk.chunk_argmax, "ef_update": ef_update.ef_update,
              "fused_reduce": fused_reduce.fused_reduce}[op].threads

    def timed(t: int) -> float:
        if dev.type != "cuda":
            return _host_ms(lambda: call(t), iters)
        # every timed call launched the candidate's size, none another
        return device_ms(lambda: call(t), iters, launched=(lambda: counts[t], 1),
                         what=f"autotune {op} at {t} threads")

    # two rounds over the candidates, each keeping its faster: a transient
    # slowdown of the card then costs no candidate the sweep
    times = dict.fromkeys(candidates, float("inf"))
    for _ in range(2):
        for t in candidates:
            times[t] = min(times[t], timed(t))
    best = min(times, key=times.get)
    key = _key(op, chunk, workers * rows, dev)
    if timings is not None:
        timings[key] = times
    _store(key, best)
    return best


def autotune_params(params, chunk: int, *, min_size: int = 0, workers: Optional[int] = None,
                    **kw) -> Dict[str, int]:
    """Sweep the three ops for every distinct size bucket of a parameter tree
    (what ``--autotune`` drives) over a stack of ``workers``, the run's worker
    count: each sweep writes the key of the launches the run makes over its
    stacked tensors, ``workers`` x chunk rows. Tensors below ``min_size`` are
    reduced densely and skipped. Returns {f"{op}|n{size}": winner}, ``size``
    the elements a worker each sweep launched over. ``workers`` None sweeps
    as the reference does: its bucketed sizes, the fused reduce over four
    workers and the other two over one."""
    from repro_torch import tree

    if workers is not None and workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    w = workers or 1
    # the launch buckets, and a worker's rows in each: the largest multiple of
    # ``w`` in a bucket is in it, since some launch's rows (a multiple of ``w``
    # above half the bucket) are
    launch = {_bucket(w * -(-s // chunk))
              for s in (p.numel() for p in tree.leaves(params)) if s >= min_size}
    sizes = sorted(b // w * chunk for b in launch)
    out: Dict[str, int] = {}
    for op in _OPS:
        for size in sizes:
            out[f"{op}|n{size}"] = autotune(op, size, chunk, workers=workers, **kw)
    return out
