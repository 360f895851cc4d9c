#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one Hopper (sm_90) card, PyTorch built for CUDA and ``nvcc``. It
imports only ``repro_torch`` (never JAX or the ``repro`` package) and fails,
printing no result, without a card or outside a checkout of the repository.
Phases, each fatal on failure:

  1. card and versions: ``nvidia-smi`` name and power limit, torch and CUDA
     versions, and the build of the kernels from ``src/repro_torch/csrc``
     (one nvcc per source, all started together);
  2. each of the six CUDA kernels against its plain PyTorch version on the
     card at the shapes of its path (the ``tok_embed`` tensor over 8
     workers: select, top-2 select, shared and per-worker gathers at top-m 1
     and 2, Eq. 5 update, scatter, the fused reduce for clt_k and true_topk
     at top-m 1 and 2; a chunk tail; small shapes full of ties with top-m 1,
     2 and chunk, and 1, 3 and 64 workers for the fused reduce), the gather
     and scatter bit for bit, with its device time (``device_ms``: 20 calls
     queued while the card is held, then run back to back between two CUDA
     events, with an exact launch count) beside the plain version's, a
     PyTorch library call's and the bound, and the kernel's and library
     call's time between CUDA events around one call (host dispatch
     included). The two selects, the scatter and the fused reduce must run
     their vec4 variant at the tok_embed shapes; the selects' scalar variant
     runs on the same rows from a misaligned base, the scalar kernels of the
     scatter and of the fused reduce are called directly on the same inputs
     (the fused reduce's bitwise too). Then the variant edges, each checked
     for the variant that ran: the selects at rows 1 to 100,003, chunk
     4/8/64/128, top-m at the register limit (8) and above it, misaligned
     bases; the scatter and gather at rows 1, 33 and 100,003, chunk
     4/8/17/64/128, top-m 1/2/8/9, duplicates, shared sets over 3, 8 and 16
     copies and per-worker sets, offsets outside the chunk; the fused reduce
     over 1, 3, 8 and 64 workers, rows 1, 33 and 100,003, chunk
     4/8/17/64/128, top-m 1/2/8/9, m or g misaligned, both modes; NaN
     payloads, -0 and +-inf throughout; and one tensor past 2^31 elements
     through every variant of the selects, the scatter and the fused reduce
     and the gather. The fused reduce's one-row variant
     (``fused_select_update``, a process group leader's select and Eq. 5
     update) bitwise against its plain twin at the tok_embed one-row shapes
     (m + g and keyed selects, top-1 and 2), timed beside its bound and the
     unfused chunk_argmax + ef_update, at every block size the autotuner
     tries, and at small odd rows x chunk 4/8/64/128 x top-m 1/2/8 full of
     ties and NaNs (``select_update_checks``);
  2b. ``[harness]``, the fault harness on the card: the launch preflight
     (``launch.train.preflight``: 8 workers, clt_k, chunk 64, fp32, all five
     scenarios) and its wall time; the harness CLI's sweeps
     (``HARNESS_SWEEPS``: every scenario, flat and hierarchical, 12 steps,
     with the build-up sweep; clt_k unfused and fused at 8-64 workers,
     true_topk fused at 16 and 64, top-2 at 8, each lossy codec at 8 and 64),
     each passing every invariant. Every reduce of the preflight and the
     sweeps is held against the torch backend's composition on the card from
     the same inputs (``ReduceShadow``: unfused bitwise; fused, residues
     bitwise and ĝ to rtol 1e-6 on the same lanes, with a counted few near
     ties for true_topk), and every sweep runs again through the CLI on the
     CPU, with equal records, re-plans and build-up rows and distances
     within ``HARNESS_DIST_ATOL`` (``HARNESS_CODEC_DIST_SHARE`` of a run's
     tolerance with a lossy codec). The true_topk sweep's fused launches must
     take both routes the library reports: staged (G <= 12) and the L2
     re-read. Their kernel launches count toward each kernel's
     ``launches``, and stand alone under ``harness_launches``;
  3. the main path: ``run_training`` trains paper-transformer-base at full
     width (6 layers, d 512, vocab 37000; fp32 compute, as the reference's
     CLI trains, like every phase but the bf16 ones) with CLT-k, 8 workers of batch 4 x
     128 tokens, 2 dense warm-up steps then 3 compressed steps, once unfused
     and once with ``fused=True``; the loss must be finite and each kernel
     must have launched as often as the reduce plan says (unfused: select,
     update and scatter once per compressed tensor and step, every select
     and scatter in its vec4 variant; fused: one fused_reduce, in its vec4
     variant, and nothing else); every compressed step's comm bytes equal
     the plan's (the harness's ``check_comm_accounting``) and its nnz(ĝ)/k,
     counted as the optimizer receives ĝ, passes ``check_buildup``;
  4. teacher-forced reduce from the trained state: the unfused "cuda"
     backend equals the "torch" backend bit for bit (and from the state
     before the first compressed step); the fused cuda reduce equals the
     unfused one (residues and the tok_embed idx/vals bitwise, ĝ to rtol
     1e-6) and the fused torch backend (clt_k; true_topk up to near ties,
     counted), and its nnz(ĝ)/k passes ``check_buildup``; a rate rule
     putting the blocks' tensors at top-2 runs chunk_topm (vec4 variant),
     fused and unfused, cuda against torch;
     host-clock times of the per-worker gradients and of each reduce; both
     selects and the scatter timed at their path's own shapes (chunk_argmax
     and chunk_scatter over the 17 compressed tensors of one step,
     chunk_topm over the 15 top-2 ones), device time per step of both
     variants beside the summed byte bound;
  4b. ``compress()`` on the tok_embed EF gradient for clt_k, true_topk,
     local_topk and random_k at top-m 1 and 2, cuda backend against torch
     backend bitwise, one chunk_gather launch per call; the exact path once;
  5. the lossy residue codecs: bf16, fp8 and fp8_ec each train the model
     fused, 2 dense + 3 compressed steps (finite loss, launches as the plan
     says, residue bytes as ``residue_bytes`` says); from each trained state
     the unfused cuda reduce equals the torch backend's bitwise and the
     fused one's residues bitwise; ``[codec]`` lines time one step's decode
     and encode over the 17 compressed tensors against their byte bound;
     the trained tok_embed residue encodes on the card bit for bit as on the
     CPU (every codec; stochastic rounding with one dither on both), and
     the casts at their edges (+-inf, NaN payloads, 448..480, subnormals);
     ``remap_state`` on the card (fp32 8 -> 4 -> 8 bitwise, every codec
     8 -> 6 within its bound);
  6. bucketed reduces (25 MB and 4 MB, overlap on the side stream and off,
     unfused and fused), two calls back to back, bitwise equal to the
     unbucketed one; telemetry reduces (metrics_every 1, bucketed too) and
     the compute_stats reduce under ``set_sync_debug_mode("error")``, so a
     host sync fails the run, with ĝ and residues bitwise equal to
     telemetry off; ``[path]`` lines for ef_update and fused_reduce (both
     variants) over the 17 tensors of one step; the fused reduces' variants;
     ``measured_bucket_timeline`` at the default 25 MB buckets (each
     bucket's reduce alone, the full bucketed reduce) beside the modeled
     overlap timeline;
  6b. ``[autotune]``, the launch-geometry autotuner on the main path
     (``autotune_phase``). The autotuner's cache is pinned to an empty file
     under a temporary directory from the start of the run, so every other
     phase launches the default block size (``train_run`` checks it), and
     this phase removes what it writes. It sweeps the block sizes
     (``CANDIDATE_THREADS``) of the vec4 select at top-1, ef_update and the
     fused reduce's clt_k route over the paper model's parameters
     (``autotune_params``) and at the three tok_embed launches; holds every
     size bitwise against the default size and the plain version at the
     tok_embed shapes (timed beside the bound), at small odd shapes full of
     ties and NaNs and past a small size's grid; runs the reduce from the
     trained state unfused and fused with the tuned cache (bitwise the
     untuned reduce, each launch at the cache's size, ``count_launches`` 1
     fused and 3 unfused for one tensor, ``[path]`` device ms with and
     without the cache); and runs ``launch.train --autotune`` at SMOKE width;
  7. the rest of the training path as the CLI runs it, at full width:
     ``[grads]`` holds the batched per-worker pass (one ``torch.func.vmap``
     pass over the 8 workers, which every training run above goes through)
     against ``per_worker_grads_loop`` (one autograd pass per worker) from
     the trained state to rtol 1e-5 / atol 1e-7, two of its calls bit for
     bit, with host ms of both beside ``dense_grads``;
     ``[train:microbatches]`` holds one step's gradients at microbatches=2
     against one pass (peak memory of each) and trains 2 dense + 3 fused
     compressed steps through ``build_train_step(microbatches=2)``;
     ``[telemetry:run]`` trains 5 fused steps with the recorder
     (``run_training(telemetry=TelemetryRun)``, taps on, metrics_every 1)
     and reads back its trace, event log and report; ``[checkpoint]`` saves
     a trained TrainState and restores it onto the card, bit for bit (the
     fp8 run's state where the fp32 one would take more than ~30 s). Each
     run's launches are counted from 0 and held to the plan;
  8. one more fused compressed step under ``torch.profiler``: device busy
     time, idle share and the kernels that take the most device time;
  8b. ``[bf16]``, the main path in the reference's mixed precision (bf16
     compute over fp32 parameters, ``build_model``'s default): the same
     runs as 3 (unfused, then fused), each kernel launched as the plan says,
     in its vec4 variant, on fp32 inputs only (every launch's tensors
     recorded); the bytes the plan's, build-up and a finite loss. On the
     trained weights and one batch the bf16 batched pass against the fp32
     one (``BF16_LOSS_REL``, ``BF16_GRAD_REL``) and against the bf16 loop,
     each with its peak memory; every matrix product of one forward pass
     on bf16 operands; the teacher-forced reduces from the bf16
     state held as ``[arch]`` holds them (cuda against torch, unfused
     bitwise); one profiled fused step; host ms a step, device busy ms,
     idle share and the pass's peak beside the fp32 run's;
  9. ``[arch]``, the registry's model families at full width, depth cut
     (``ARCH_RUNS``), their initial weights drawn on the card:
     starcoder2-3b (RMSNorm / SwiGLU, GQA with 2 KV heads) at 2 of 30
     layers, 8 workers, unfused and then fused; phi3.5-moe-42b-a6.6b (16
     experts, top-2) at 1 of 32 layers, 2 workers, fused; rwkv6-3b (the
     RWKV-6 time loop) at 2 of 32 layers, 8 workers, unfused and fused;
     recurrentgemma-2b (RG-LRU and local attention; one stacked unit and
     one un-stacked tail layer) at 4 of 26 layers, 2 workers of 1 x 2304
     positions, fused; whisper-medium at 2 + 2 of 24 + 24 layers, 8
     workers of 4 x 128 text positions over 1500 stub frames, fused; and
     internvl2-26b at 1 of 48 layers, 2 workers of 4 x (256 stub vision +
     128 text) positions, fused. Each trained by ``run_training`` for 2
     dense and 3 compressed steps with its launches held to the plan,
     every select, scatter and fused launch vec4, the comm-bytes and
     build-up invariants on every compressed step and a finite loss; step
     ms and peak memory. From each trained state a fused reduce (and for
     starcoder2, phi3.5-moe and rwkv6 an unfused one) on the card, timed
     beside its byte bound and held tensor by tensor against the torch
     backend's composition (``hold_reduce``, ``ReduceShadow``'s rules);
     for phi3.5-moe and rwkv6 the batched per-worker pass against the
     loop (``grads_phase``) and for the MoE arch nnz(ĝ)/k of the expert
     tensors. These launches stand under ``arch_launches`` in the JSON
     line and are not in ``launches``.
  9b. ``[arch:bf16]``, each ``ARCH_RUNS`` cut in bf16 compute over fp32
     parameters, fused: 1 dense + 1 compressed step, launches and bytes as
     planned, a finite loss, the peak beside the fp32 run's (their
     launches join ``arch_launches``);
  10. ``[serve]``, serving the registry's families at full width
     (``SERVE_RUNS``), each one's weights drawn on the card and freed before
     the next: paper-transformer-base (6 layers), starcoder2-3b (30),
     rwkv6-3b (32), recurrentgemma-2b (26, a 2304-position prompt past its
     2048-position window) and whisper-medium (24 + 24 over 1500 stub
     frames) at full depth; phi3.5-moe-42b-a6.6b at 8 of 32 and
     internvl2-26b at 24 of 48 layers (256 stub vision tokens), whose fp32
     weights do not fit whole. 4 prompts of 64 tokens, 32 greedy tokens
     through ``build_serve_fns`` and ``launch.serve.generate``, twice
     (equal tokens): prefill ms (first call and warm), decode ms a token
     and tokens/s against the decode step's weight-read bound, one decode
     step under ``torch.profiler``, peak memory; prefill/decode
     consistency (rtol = atol = 2e-3, MoE at its no-drop capacity
     factor), the card against the CPU on the same weights cut in depth
     (``SERVE_CPU_REL_TOL``), the recurrent states' size, and no ScaleCom
     kernel launched.
  10b. ``[serve:bf16]``, the reference's production serving configuration
     (bf16 parameters and compute, ``BF16_SERVE_RUNS``, the same phase
     function): paper-transformer-base and rwkv6-3b at full depth and
     internvl2-26b at all 48 layers, which fp32 weights cannot hold, each
     stacked leaf drawn in fp32 one layer at a time and stored in bf16.
     ``[serve]``'s timings, the weight-read bound at 2 bytes a weight; every
     matrix product of a decode step on bf16 operands but RWKV-6's fp32
     ones; prefill/decode consistency at each run's fixed tolerance, for
     rwkv6-3b also at 1 to 16 layers; the greedy tokens' agreement with an
     fp32 run of the same draw where one fits;
  11. ``[ring]``, real collectives (``repro_torch.distributed.ring``):
     ``RING_WORLD`` = 8 spawned processes on the one card, joined by gloo
     through a ``file://`` store (NCCL puts one rank on a card; gloo's
     broadcast, all_reduce and all_gather take CUDA tensors through host
     memory), the kernel library built before they start. (a) On 4 of them
     the tok_embed tensor's ring reduce at t = 0..3 (each rank leading once):
     the cuda ring bitwise its torch-backend ring, offsets and m' bitwise
     the single-process stacked cuda reduce of the same rows, ĝ within
     ``TOL``; device ms of the leader's select, ef_update and the scatter
     on one rank's row against their byte bounds (one rank at a time), host
     ms of the broadcast and the all_reduce. (b) On all 8 the main path's
     training through ``build_train_step(group=...)``, one worker per rank:
     paper-transformer-base at full width, 4 x 128 tokens a rank, 2 dense +
     3 compressed steps; after each step rank 0 runs the stacked step from
     the same state and the ranks' own gradients (recomputed there, digests
     equal) and holds ĝ, params and the loss within ``TOL``, rank 0's
     offsets bitwise the stacked reduce's; the params bitwise identical on
     every rank and every residue row bitwise the stacked step's (by 64-bit
     digests, ``digest``); the counted payload bytes, averaged over the
     ranks, the plan's; launches per rank (the leader's chunk_argmax, every
     rank's ef_update and chunk_scatter, all vec4); step ms (max and median
     over ranks) with the gradient pass and the collectives inside it, the
     dense warm-up's all-reduce, the reduce's kernels of one step on one
     rank (device ms) and peak memory by rank. Then ``RING_RUNS``, each 1
     dense + 2 compressed steps in the same spawn, held the same way:
     ``[ring:compressors]`` true_topk, local_topk and random_k (fp32),
     ``[ring:codecs]`` clt_k with bf16, fp8 and fp8_ec residues and
     ``[ring:pod2]`` clt_k, fp8, ``groups=2`` (2 groups of 4 ranks, the
     reference's pod2 setting) with ``compute_stats``: every field of every
     residue row bitwise the stacked step's row (under groups its group's,
     the replicas bitwise each other), true_topk's offsets bitwise outside
     the chunks whose top two in the stacked worker-mean EF lie within the
     rounding of an 8-term sum (counted, printed), contraction gamma within
     ``GAMMA_RTOL``, the payload the plan's with the oracle, intra-group and
     stats bytes beside it; per run step ms, collectives' host ms by kind,
     the reduce's kernels' device ms on rank 0, the dither draw's device ms
     and bytes (bf16, fp8_ec) and peak memory by rank. Then, held the same
     way, ``[ring:buckets]`` (25 MB and 4 MB buckets with overlap, 25 MB
     without: packed async collectives, the stacked reduce bucketed alike),
     ``[ring:telemetry]`` (metrics_every 1 with ``compute_stats``: the taps'
     keys the stacked reduce's, their values the same on every rank by
     digest and within rtol 1e-5 of the stacked reduce's, the rank-based
     ones counted where they move), ``[ring:fused]`` (clt_k and true_topk:
     the leader's ``fused_select_update`` launches, on the key route for
     true_topk) and ``[ring:exact]`` (clt_k: no kernel; offsets held by ĝ's
     support), each step printing its gloo calls and their host ms by kind
     (an async call: its issue and its ``wait()``). A rank that fails, or a
     phase past ``RING_PHASE_S``, fails the script. These launches stand
     under ``ring_launches`` in the JSON line; ``fused_select_update``'s,
     whose path is the ring's alone, are its ``launches``. A ``[time]`` line
     gives each phase's seconds.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. The bf16 main path's
launches (8b) count in each kernel's ``launches`` and stand alone under
``bf16_launches``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
CSRC = "src/repro_torch/csrc/"
KERNELS = {  # name: (source of the kernel timed, the Pallas body it replaces)
    "chunk_argmax": ("chunk_select.cuh", "src/repro/kernels/chunk_topk.py:65"),
    "chunk_topm": ("chunk_select.cuh", "src/repro/kernels/chunk_topk.py:74"),
    "chunk_gather": ("chunk_topm_gather.cu", "src/repro/kernels/chunk_topk.py:91"),
    "chunk_scatter": ("scalecom_kernels.cu", "src/repro/kernels/chunk_topk.py:101"),
    "ef_update": ("scalecom_kernels.cu", "src/repro/kernels/ef_update.py:44"),
    "fused_reduce": ("fused_reduce_vec4.cuh", "src/repro/kernels/fused_reduce.py:63"),
    # the fused reduce's one-row variant: a process group's leader, no ĝ
    "fused_select_update": ("fused_select_update.cuh", "src/repro/kernels/fused_reduce.py:63"),
}
# the kernels whose path is the ring's alone (a process group's leader)
RING_ONLY = ("fused_select_update",)
# the kernels with two variants, and the one each runs on the main path
VARIANTS = {"chunk_argmax": "vec4", "chunk_topm": "vec4", "chunk_scatter": "vec4",
            "fused_reduce": "vec4"}

# the main path's largest compressed tensor: tok_embed, 37000 x 512, over 8 workers
G, P, CHUNK, BETA = 8, 37000 * 512, 64, 0.1
R = P // CHUNK
TAIL = 1_000_037  # a trailing axis that is no multiple of CHUNK
TOL = dict(rtol=1e-6, atol=1e-7)  # worker means summed in another order


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` between two CUDA events: the device
    work plus whatever host dispatch the device waits for inside the pair
    (for a kernel shorter than its wrapper's host work, mostly dispatch)."""
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


def device_ms(fn, launched=None, reps: int = 20, warmup: int = 3, what: str = "") -> float:
    """Device ms per call of ``fn``: ``reps`` calls queued while the card is
    held in a spin kernel, timed between one pair of CUDA events
    (``repro_torch.backends.autotune.device_ms``, the autotuner's timer). The
    card runs them back to back from its queue, so the time holds the kernels
    and the gaps between queued launches but no host dispatch. A hold that
    ran out before the host had queued the calls is retried longer with a
    quarter of the calls. With ``launched`` = (a launch counter, launches per
    call), it fails unless the timed calls launched exactly that many kernels
    per call. ``what`` names the calls in those failures."""
    from repro_torch.backends import autotune

    try:
        return autotune.device_ms(fn, reps, warmup, launched, what)
    except RuntimeError as e:
        fail(str(e))


def counter(name: str, variant: str | None = None):
    """A function returning the launch count of kernel ``name`` (of one of
    its variants, with ``variant``), as its wrapper counts it."""
    from repro_torch import kernels

    if variant is None:
        return lambda: kernels.launches()[name]
    wrapper = {k.__name__: k for k in kernels.KERNELS}[name]
    return lambda: wrapper.variants[variant]


def scatter_scalar(vals, idx, chunk: int):
    """chunk_scatter's scalar kernel (the first design) on any shape,
    launched as the wrapper launches it: ``scatter_variant`` picks vec4
    wherever it takes the shape, and the two are held against each other on
    the same inputs. Counts its launches in ``scatter_scalar.launches``."""
    import torch

    from repro_torch.kernels import build

    rows, topm = idx.shape[0], 1 if idx.dim() == 1 else idx.shape[1]
    out = torch.empty((rows, chunk), dtype=torch.float32, device=vals.device)
    rc = build.library().scalecom_chunk_scatter(vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                                rows, chunk, topm, build.stream_of(vals))
    check(rc == 0, f"chunk_scatter scalar kernel: CUDA error {rc}")
    scatter_scalar.launches += 1
    return out


scatter_scalar.launches = 0


def fused_scalar(m, g, beta: float, topm: int, mode: str, leader: int = 0):
    """fused_reduce's scalar kernel (the first design) on any (G, rows,
    chunk) m and g, launched as the wrapper launches it: ``fused_variant``
    picks vec4 wherever it takes the shape and bases, and the two are held
    against each other on the same inputs. Counts its launches in
    ``fused_scalar.launches``."""
    import torch

    from repro_torch.kernels import build, fused_reduce as frk

    G, rows, chunk = m.shape
    tail = () if topm == 1 else (topm,)
    idx = torch.empty((rows,) + tail, dtype=torch.int32, device=m.device)
    vals = torch.empty((G, rows) + tail, dtype=torch.float32, device=m.device)
    m_new = torch.empty_like(m)
    ghat = torch.empty((rows, chunk), dtype=torch.float32, device=m.device)
    rc = build.library().scalecom_fused_reduce(
        m.data_ptr(), g.data_ptr(), idx.data_ptr(), vals.data_ptr(), m_new.data_ptr(),
        ghat.data_ptr(), rows, G, chunk, topm, frk.MODES.index(mode), leader, beta,
        build.stream_of(m))
    check(rc == 0, f"fused_reduce scalar kernel: CUDA error {rc}")
    fused_scalar.launches += 1
    return idx, vals, m_new, ghat


fused_scalar.launches = 0


def host_ms(fn):
    """(result, host-clock ms) of ``fn`` between two device syncs."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes time and the fp32 ops time."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def bitwise(a, b) -> bool:
    """Equal shapes, dtypes and bit patterns (NaN payloads and the sign of
    zero included), of tensors on any devices."""
    import torch

    if isinstance(a, tuple):
        return all(bitwise(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints).to(a.device))


def close(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.allclose(a, b, **TOL)


def max_abs_err(a, b) -> float:
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0 for x, y in pairs)


def gather_bytes(idx, rows: int, sector: int = 32) -> int:
    """Bytes a gather must move: one ``sector``-byte segment of x per distinct
    (row, offset * 4 // sector), plus the index set and the output."""
    import torch

    i2 = idx[:, None] if idx.dim() == 1 else idx
    s = torch.sort(torch.div(i2, sector // 4, rounding_mode="floor"), dim=-1).values
    segments = int((1 + (s[:, 1:] != s[:, :-1]).sum(-1)).sum()) * (rows // i2.shape[0])
    return segments * sector + i2.numel() * 4 + rows * i2.shape[1] * 4


def kernel_phase(card_line: str):
    """Phase 2: each kernel against its plain version at its path's shapes."""
    import torch

    from repro_torch import kernels
    from repro_torch.backends import resolve_backend
    from repro_torch.kernels import chunk_topk as ct, ef_update as efk, fused_reduce as frk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(G, P, device=dev, generator=gen)
    xr = x.view(-1, CHUNK)
    xr[::997] = torch.randint(-3, 4, xr[::997].shape, device=dev, generator=gen).float()  # ties
    rows = xr.shape[0]
    results = {}

    def record(key, kern, plain, library, library_name, nbytes, ops):
        """Check one kernel bitwise against its plain version and time both,
        and the library call, by device time (``device_ms``), with the
        kernel's and the library call's per-call CUDA-event time beside."""
        name = key.split("[")[0]
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        same = (bitwise if name in ("chunk_gather", "chunk_scatter", "fused_reduce",
                                    "fused_select_update") else equal)
        check(same(out_k, out_p), f"{key}: kernel and plain version differ")
        err = max_abs_err(out_k, out_p)
        ms = device_ms(kern, (counter(name, VARIANTS.get(name)), 1), what=f"{key} kernel")
        call = time_ms(kern)
        plain_ms = device_ms(plain, what=f"{key} plain")
        library_ms = device_ms(library, what=f"{key} library") if library is not None else None
        library_call = time_ms(library) if library is not None else None
        bound_ms, bound_by = bound(nbytes, ops)
        source, replaces = KERNELS[name]
        results[key] = dict(name=name, route="cuda", source=CSRC + source, replaces=replaces,
                            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                            call_ms=call, library_call_ms=library_call)

        def fmt(t):
            return "null" if t is None else f"{t:.4f}"

        print(f"[kernel] {key}: equal to plain{' bit for bit' if same is bitwise else ''}; "
              f"device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, library {fmt(library_ms)} "
              f"({library_name}); bound_ms {bound_ms:.4f} ({bound_by}), {bound_ms / ms:.0%} of "
              f"it; one call between CUDA events (host dispatch included): kernel {call:.4f}, "
              f"library {fmt(library_call)} on {card_line}")

    # select over the worker-stacked EF: (G*R, 64) rows; top-2 for a rate rule's tensors
    kernels.reset_launches()
    record("chunk_argmax", lambda: ct.chunk_argmax(xr), lambda: ct.chunk_argmax_plain(xr),
           lambda: torch.argmax(xr.abs(), dim=-1), "torch.argmax(x.abs(), -1)",
           rows * CHUNK * 4 + rows * 8, 2 * rows * CHUNK)
    record("chunk_topm", lambda: ct.chunk_topm(xr, 2), lambda: ct.chunk_topm_plain(xr, 2),
           lambda: torch.topk(xr.abs(), 2, dim=-1), "torch.topk(x.abs(), 2, -1)",
           rows * CHUNK * 4 + rows * 2 * 8, 2 * 2 * rows * CHUNK)
    for kern in (ct.chunk_argmax, ct.chunk_topm):
        check(kern.variants["scalar"] == 0 and kern.variants["vec4"] == kern.launches,
              f"{kern.__name__} at the tok_embed shapes ran {kern.variants}, want vec4 only")
        results[kern.__name__]["variant"] = "vec4"
    print(f"[kernel] chunk_argmax and chunk_topm at the tok_embed shapes ran the vec4 variant "
          f"only ({ct.chunk_argmax.launches} and {ct.chunk_topm.launches} launches)")
    # the same rows from a base 4 bytes past 16-byte alignment: the scalar variant
    buf = torch.empty(rows * CHUNK + 4, device=dev)
    mis = buf[1:1 + rows * CHUNK].view(rows, CHUNK)
    mis.copy_(xr)
    for kern, fn, plain in ((ct.chunk_argmax, lambda: ct.chunk_argmax(mis),
                             lambda: ct.chunk_argmax_plain(mis)),
                            (ct.chunk_topm, lambda: ct.chunk_topm(mis, 2),
                             lambda: ct.chunk_topm_plain(mis, 2))):
        before = kern.variants["scalar"]
        check(bitwise(fn(), plain()) and kern.variants["scalar"] == before + 1,
              f"{kern.__name__} on a misaligned base: scalar variant differs from plain "
              f"or did not run ({kern.variants})")
        results[kern.__name__]["scalar_ms"] = device_ms(fn, (counter(kern.__name__, "scalar"), 1))
        print(f"[kernel] {kern.__name__} scalar variant (misaligned base, same rows): bitwise "
              f"equal to plain; device ms {results[kern.__name__]['scalar_ms']:.4f} against "
              f"vec4 {results[kern.__name__]['ms']:.4f} on {card_line}")
    # top-m at the register-list limit: vec4 against the scalar pass design
    topm = ct.VEC4_MAX_TOPM
    want = ct.chunk_topm_plain(xr, topm)
    check(bitwise(ct.chunk_topm(xr, topm), want) and bitwise(ct.chunk_topm(mis, topm), want),
          f"chunk_topm top-{topm} at the tok_embed shapes differs from plain")
    print(f"[kernel] chunk_topm top-{topm}: both variants bitwise equal to plain; device ms "
          f"vec4 {device_ms(lambda: ct.chunk_topm(xr, topm), (counter('chunk_topm', 'vec4'), 1)):.4f}, "
          f"scalar {device_ms(lambda: ct.chunk_topm(mis, topm), (counter('chunk_topm', 'scalar'), 1)):.4f}, "
          f"bound_ms "
          f"{bound(rows * CHUNK * 4 + rows * topm * 8, 0)[0]:.4f} on {card_line}")
    del buf, mis, want

    # Eq. 5 update with the shared (R,) leader set, read by all G workers
    m = torch.randn(G, P, device=dev, generator=gen).view(-1, CHUNK)
    g = torch.randn(G, P, device=dev, generator=gen).view(-1, CHUNK)
    idx_shared = ct.chunk_argmax_plain(xr[:R])[0]
    record("ef_update", lambda: efk.ef_update(m, g, idx_shared, BETA),
           lambda: efk.ef_update_plain(m, g, idx_shared, BETA), None, "no single call",
           3 * rows * CHUNK * 4 + R * 4 + rows * 4, 5 * rows * CHUNK)

    # ghat scatter of the (R,) worker-mean values: the vec4 variant, then the
    # scalar one forced on the same inputs
    vmean = torch.randn(R, device=dev, generator=gen)
    before = dict(ct.chunk_scatter.variants)
    record("chunk_scatter", lambda: ct.chunk_scatter(vmean, idx_shared, CHUNK),
           lambda: ct.chunk_scatter_plain(vmean, idx_shared, CHUNK),
           lambda: torch.zeros(R, CHUNK, device=dev).scatter_(
               1, idx_shared.long()[:, None], vmean[:, None]),
           "torch.zeros().scatter_()", R * 8 + R * CHUNK * 4, R * CHUNK)
    check(ct.chunk_scatter.variants["scalar"] == before["scalar"],
          f"chunk_scatter at the tok_embed shapes ran {ct.chunk_scatter.variants}, want vec4 only")
    results["chunk_scatter"]["variant"] = "vec4"
    scalar = lambda: scatter_scalar(vmean, idx_shared, CHUNK)  # noqa: E731
    check(bitwise(scalar(), ct.chunk_scatter_plain(vmean, idx_shared, CHUNK)),
          "chunk_scatter scalar variant at the tok_embed shapes differs from plain")
    results["chunk_scatter"]["scalar_ms"] = device_ms(
        scalar, (lambda: scatter_scalar.launches, 1))
    print(f"[kernel] chunk_scatter ran the vec4 variant; its scalar kernel (called directly, same "
          f"inputs): "
          f"bitwise equal to plain; device ms {results['chunk_scatter']['scalar_ms']:.4f} against "
          f"vec4 {results['chunk_scatter']['ms']:.4f} on {card_line}")
    for topm in (2, ct.VEC4_MAX_TOPM):
        vm = torch.randn(R, topm, device=dev, generator=gen)
        im = torch.randint(0, CHUNK, (R, topm), device=dev, generator=gen, dtype=torch.int32)
        want = ct.chunk_scatter_plain(vm, im, CHUNK)
        check(bitwise(ct.chunk_scatter(vm, im, CHUNK), want)
              and bitwise(scatter_scalar(vm, im, CHUNK), want),
              f"chunk_scatter top-{topm} at the tok_embed shapes differs from plain")
        t4 = device_ms(lambda: ct.chunk_scatter(vm, im, CHUNK), (counter("chunk_scatter", "vec4"), 1))
        t1 = device_ms(lambda: scatter_scalar(vm, im, CHUNK), (lambda: scatter_scalar.launches, 1))
        print(f"[kernel] chunk_scatter top-{topm}: both variants bitwise equal to plain; device "
              f"ms vec4 {t4:.4f}, scalar {t1:.4f}, bound_ms "
              f"{bound(R * topm * 8 + R * CHUNK * 4, 0)[0]:.4f} on {card_line}")
    del vm, im, want

    # gather of compress(): the shared (R,) set over all G*R rows, then the
    # per-worker set and top-2 sets of both kinds
    idx_pw = ct.chunk_argmax_plain(xr)[0]  # per-worker (local_topk) sets
    idx2_shared = ct.chunk_topm_plain(xr[:R], 2)[0]
    idx2_pw = ct.chunk_topm_plain(xr, 2)[0]
    for key, ids in (("chunk_gather", idx_shared), ("chunk_gather[per-worker]", idx_pw),
                     ("chunk_gather[top-2]", idx2_shared),
                     ("chunk_gather[top-2, per-worker]", idx2_pw)):
        full = (ids[:, None] if ids.dim() == 1 else ids).long().repeat(rows // ids.shape[0], 1)
        record(key, lambda ids=ids: ct.chunk_gather(xr, ids),
               lambda ids=ids: ct.chunk_gather_plain(xr, ids),
               lambda full=full: torch.gather(xr, 1, full), "torch.gather(x, 1, idx)",
               gather_bytes(ids, rows), 0)
        # the same least time if the card fetches device memory in 64-byte units
        r = results[key]
        r["bound_64_ms"] = bound(gather_bytes(ids, rows, 64), 0)[0]
        print(f"[kernel] {key}: bound_ms {r['bound_ms']:.4f} by 32-byte sectors "
              f"({r['bound_ms'] / r['ms']:.0%} of it), {r['bound_64_ms']:.4f} by 64-byte segments "
              f"({r['bound_64_ms'] / r['ms']:.0%} of it) on {card_line}")

    # the fused reduce of the same tensor, leader 3; clt_k at top-1 is the fused run's call.
    # The vec4 variant through the wrapper, then the scalar kernel on the same inputs
    m3, g3 = m.view(G, R, CHUNK), g.view(G, R, CHUNK)
    cuda_be, torch_be = resolve_backend("cuda"), resolve_backend("torch")
    before = frk.fused_reduce.variants["scalar"]
    for mode in ("clt_k", "true_topk"):
        for topm in (1, 2):
            key = "fused_reduce" if (mode, topm) == ("clt_k", 1) else f"fused_reduce[{mode}, top-{topm}]"
            leader = 3 if mode == "clt_k" else None
            nbytes = 3 * G * P * 4 + G * R * topm * 4 + R * topm * 4 + R * CHUNK * 4
            ops = (7 if mode == "clt_k" else 9) * G * P
            plain = lambda mode=mode, topm=topm, leader=leader: frk.fused_reduce_plain(  # noqa: E731
                m3, g3, BETA, topm, mode, leader or 0)
            record(key, lambda mode=mode, topm=topm, leader=leader:
                   frk.fused_reduce(m3, g3, BETA, topm, mode, leader),
                   plain, None, "no single call", nbytes, ops)
            scalar = lambda mode=mode, topm=topm, leader=leader: fused_scalar(  # noqa: E731
                m3, g3, BETA, topm, mode, leader or 0)
            check(bitwise(scalar(), plain()),
                  f"{key}: the scalar kernel at the tok_embed shapes differs from plain")
            r = results[key]
            r["variant"] = "vec4"
            r["scalar_ms"] = device_ms(scalar, (lambda: fused_scalar.launches, 1),
                                       what=f"{key} scalar")
            print(f"[kernel] {key}: vec4 variant {r['ms']:.4f} device ms ({r['bound_ms'] / r['ms']:.0%}"
                  f" of the bound); the scalar kernel (the first design, called directly, same "
                  f"inputs) bitwise equal to plain, {r['scalar_ms']:.4f} device ms "
                  f"({r['bound_ms'] / r['scalar_ms']:.0%}) on {card_line}")
    check(frk.fused_reduce.variants["scalar"] == before,
          f"fused_reduce at the tok_embed shapes ran {frk.fused_reduce.variants}, want vec4 only")
    # true_topk's two vec4 designs, on both sides of the staging limit: 12 workers' rows
    # fit a staged block at chunk 64 (shared memory), 13 do not (the L2 re-read)
    for workers, route, design in ((12, "staged", "staged in shared memory"),
                                   (13, "l2_reread", "L2 re-read")):
        mw = torch.randn(workers, R, CHUNK, device=dev, generator=gen)
        gw = torch.randn(workers, R, CHUNK, device=dev, generator=gen)
        run = lambda mw=mw, gw=gw: frk.fused_reduce(mw, gw, BETA, 1, "true_topk")  # noqa: E731
        before = dict(frk.fused_reduce.routes)
        check(bitwise(run(), frk.fused_reduce_plain(mw, gw, BETA, 1, "true_topk")),
              f"fused_reduce true_topk at {workers} workers differs from plain")
        took = {k: n - before[k] for k, n in frk.fused_reduce.routes.items() if n != before[k]}
        check(took == {route: 1}, f"fused_reduce true_topk at {workers} workers took {took}, "
                                  f"want the {design}")
        ms = device_ms(run, (counter("fused_reduce", "vec4"), 1), what=f"true_topk {workers}")
        b = bound(3 * workers * R * CHUNK * 4 + workers * R * 4 + R * 4 + R * CHUNK * 4, 0)[0]
        results["fused_reduce"][f"true_topk_{workers}_workers_ms"] = ms
        print(f"[kernel] fused_reduce[true_topk, top-1] at {workers} workers ({design}): vec4 "
              f"bitwise equal to plain; device ms {ms:.4f}, bound_ms {b:.4f}, {b / ms:.0%} of it "
              f"on {card_line}")
        del mw, gw
    # clt_k against the unfused kernels from the same state: idx, vals, m' bitwise
    for topm in (1, 2):
        idx, vals, m_new, _ = cuda_be.fused_reduce(m3, g3, BETA, CHUNK, topm, "clt_k", 3)
        want_idx = cuda_be.select_indices(m3 + g3, CHUNK, topm)[3]
        want_m, want_vals = cuda_be.ef_update(m3, g3, want_idx, BETA, CHUNK, topm)
        check(equal(idx, want_idx) and equal(vals, want_vals) and equal(m_new, want_m),
              f"fused clt_k top-{topm} differs from the unfused kernels")
    del m3, g3, m, g

    # a chunk tail through the layout layer, against the torch backend
    tail = torch.randn(G, TAIL, device=dev, generator=gen)
    pad = (-TAIL) % CHUNK
    for topm in (1, 2):
        check(equal(cuda_be.select(tail, CHUNK, topm), torch_be.select(tail, CHUNK, topm)),
              f"top-{topm} select with a chunk tail differs from the torch backend")
        ti = cuda_be.select_indices(tail, CHUNK, topm)[3]
        check(equal(cuda_be.ef_update(tail, tail, ti, BETA, CHUNK, topm),
                    torch_be.ef_update(tail, tail, ti, BETA, CHUNK, topm)),
              f"top-{topm} ef_update with a chunk tail differs from the torch backend")
        check(equal(cuda_be.gather(tail, ti, CHUNK, topm), torch_be.gather(tail, ti, CHUNK, topm)),
              f"top-{topm} gather with a chunk tail differs from the torch backend")
        v = tail[0, :ti.shape[0]]
        if topm > 1:
            v = torch.stack([v, -v], -1)
        check(equal(cuda_be.scatter(v, ti, CHUNK, TAIL, topm),
                    torch_be.scatter(v, ti, CHUNK, TAIL, topm)),
              f"top-{topm} scatter with a chunk tail differs from the torch backend")
        got = cuda_be.fused_reduce(tail, tail * 0.5, BETA, CHUNK, topm, "clt_k", 5)
        want = frk.fused_reduce_plain(
            torch.nn.functional.pad(tail, (0, pad)).view(G, -1, CHUNK),
            torch.nn.functional.pad(tail * 0.5, (0, pad)).view(G, -1, CHUNK), BETA, topm, "clt_k", 5)
        check(equal(got[0], want[0]) and equal(got[1], want[1])
              and equal(got[2], want[2].reshape(G, -1)[:, :TAIL])
              and equal(got[3], want[3].reshape(-1)[:TAIL]),
              f"top-{topm} fused reduce with a chunk tail differs from its plain version")
    del tail

    # small odd shapes full of ties (NaN too for the selects): the kernels' corner cases
    for rows_s, chunk_s in ((999, 17), (37, 100), (5, 1)):
        xs = torch.randint(-3, 4, (rows_s, chunk_s), device=dev, generator=gen).float()
        check(equal(ct.chunk_argmax(xs), ct.chunk_argmax_plain(xs)),
              f"chunk_argmax differs from plain at ({rows_s}, {chunk_s}) with ties")
        xn = xs.clone()
        xn[::7, ::3] = float("nan")
        for topm in sorted({1, min(2, chunk_s), chunk_s}):
            check(bitwise(ct.chunk_topm(xn, topm), ct.chunk_topm_plain(xn, topm)),
                  f"chunk_topm differs from plain at ({rows_s}, {chunk_s}), top-{topm}, NaN")
            order = torch.rand(rows_s, chunk_s, device=dev, generator=gen).argsort(-1)
            ids = order[:, :topm].to(torch.int32).contiguous()
            ids = ids[:, 0].contiguous() if topm == 1 else ids
            ms, gs = torch.randn(2, rows_s, chunk_s, device=dev, generator=gen)
            check(equal(efk.ef_update(ms, gs, ids, BETA), efk.ef_update_plain(ms, gs, ids, BETA)),
                  f"ef_update differs from plain at ({rows_s}, {chunk_s}), topm {topm}")
            vs = torch.randn(ids.shape, device=dev, generator=gen)
            check(equal(ct.chunk_scatter(vs, ids, chunk_s), ct.chunk_scatter_plain(vs, ids, chunk_s)),
                  f"chunk_scatter differs from plain at ({rows_s}, {chunk_s}), topm {topm}")
            x3 = torch.randn(3 * rows_s, chunk_s, device=dev, generator=gen)
            for xg in (xn, x3):
                check(bitwise(ct.chunk_gather(xg, ids), ct.chunk_gather_plain(xg, ids)),
                      f"chunk_gather differs from plain at ({rows_s}, {chunk_s}), topm {topm}")
            for workers in (1, 3, 64):
                mg = torch.randint(-3, 4, (2, workers, rows_s, chunk_s), device=dev,
                                   generator=gen).float()
                for mode, leader in (("clt_k", workers - 1), ("clt_k", workers // 2),
                                     ("true_topk", 0)):
                    check(equal(frk.fused_reduce(mg[0], mg[1], BETA, topm, mode, leader),
                                frk.fused_reduce_plain(mg[0], mg[1], BETA, topm, mode, leader)),
                          f"fused_reduce differs from plain at ({workers}, {rows_s}, {chunk_s}), "
                          f"{mode}, top-{topm}")
    torch.cuda.synchronize()
    print("[kernel] fused clt_k == unfused kernels; chunk tails through the cuda backend; small "
          "tied shapes (NaN in the selects) with top-m 1, 2 and chunk, fused over 1, 3 and 64 "
          "workers: bitwise equal")
    select_boundaries(gen)
    scatter_gather_boundaries(gen)
    fused_boundaries(gen)
    select_update_checks(gen, record, results, card_line)
    past_int32(gen)
    fused_past_int32(gen)
    return results


def tied_nan(rows: int, chunk: int, gen):
    """(rows, chunk) fp32 full of ties, with -0, +-inf and NaNs of both signs
    and many payloads: every corner of the selects' order."""
    import torch

    x = torch.randint(-3, 4, (rows, chunk), device="cuda", generator=gen).float()
    x[::3, ::5] = -0.0
    x[::11, 2::6] = float("inf")
    x[::13, ::4] = float("-inf")
    x[6::13, ::4] = float("inf")
    x[::7, ::3] = float("nan")
    xi = x.view(torch.int32)
    pay = torch.randint(1, 1 << 22, xi[1::4, ::2].shape, device="cuda", generator=gen,
                        dtype=torch.int32)
    xi[1::4, ::2] = (0x7F800000 | pay) | torch.where(pay % 2 == 0, 0, -2**31).to(torch.int32)
    return x


def select_boundaries(gen) -> None:
    """Both selects at the edges of their variants, bitwise against the plain
    versions, checking which variant ran: row counts that fill no warp or
    block (1 included), chunk 4, 8, 64 and 128, top-m at the register-list
    limit and one above it, a misaligned base, and one tensor past 2^31
    elements if the card holds it."""
    import torch

    from repro_torch.kernels import chunk_topk as ct

    def run(x, topm):
        """(out, out_plain, variant that ran) of one select."""
        kern = ct.chunk_argmax if topm is None else ct.chunk_topm
        before = dict(kern.variants)
        out = ct.chunk_argmax(x) if topm is None else ct.chunk_topm(x, topm)
        ran = [v for v in before if kern.variants[v] != before[v]]
        plain = ct.chunk_argmax_plain(x) if topm is None else ct.chunk_topm_plain(x, topm)
        return out, plain, ran

    def expect(x, topm, want, label):
        out, plain, ran = run(x, topm)
        check(ran == [want], f"{label}: ran {ran}, want the {want} variant")
        check(bitwise(out, plain), f"{label}: {want} variant differs from plain")

    limit = ct.VEC4_MAX_TOPM
    n = 0
    for rows in (1, 7, 9, 63, 65, 257, 100_003):
        for chunk in (4, 8, 64, 128):
            x = tied_nan(rows, chunk, gen)
            flat = torch.empty(rows * chunk + 4, device="cuda")
            mis = flat[1:1 + rows * chunk].view(rows, chunk)
            mis.copy_(x)
            for topm in sorted({None, 1, 2, min(limit, chunk), min(limit + 1, chunk)},
                               key=lambda m: m or 0):
                label = f"({rows}, {chunk}) {'argmax' if topm is None else f'top-{topm}'}"
                expect(x, topm, "vec4" if (topm or 1) <= limit else "scalar", label)
                expect(mis, topm, "scalar", label + " misaligned")
                n += 2
    torch.cuda.synchronize()
    print(f"[kernel] select boundaries: {n} cases (rows 1..100003, chunk 4/8/64/128, top-m "
          f"1, 2, {limit} and {limit + 1}, aligned and misaligned bases, ties, -0, inf, NaN "
          f"payloads): each ran its expected variant, bitwise equal to plain")



def scatter_gather_boundaries(gen) -> None:
    """chunk_scatter (the variant it picks, and the scalar kernel where it
    picks vec4) and chunk_gather bitwise against their plain versions at the
    edges: rows 1, 33 and 100,003; chunk 4, 8, 17, 64 and 128; top-m 1, 2, 8
    and 9; duplicate offsets within a row at top-m > 1; values with -0, +-inf
    and NaNs of both signs and many payloads; the gather with per-worker sets
    and shared sets over 3, 8 and 16 copies, and with offsets -chunk, -1,
    chunk and -chunk - 1."""
    import torch

    from repro_torch.kernels import chunk_topk as ct

    limit, n = ct.VEC4_MAX_TOPM, 0
    for rows in (1, 33, 100_003):
        for chunk in (4, 8, 17, 64, 128):
            for topm in sorted({1, 2, min(limit, chunk), min(limit + 1, chunk)}):
                shape = (rows,) if topm == 1 else (rows, topm)
                vals = tied_nan(rows, topm, gen).view(shape)
                idx = torch.randint(0, chunk, (rows, topm), device="cuda", generator=gen,
                                    dtype=torch.int32)
                if topm > 1:
                    idx[::2, 1] = idx[::2, 0]  # a duplicate offset in every other row
                idx = idx.view(shape)
                want = ct.chunk_scatter_plain(vals, idx, chunk)
                picked = ct.scatter_variant(chunk, topm)
                before = dict(ct.chunk_scatter.variants)
                got = ct.chunk_scatter(vals, idx, chunk)
                ran = [v for v in before if ct.chunk_scatter.variants[v] != before[v]]
                label = f"chunk_scatter ({rows}, {chunk}) top-{topm} {picked}"
                check(ran == [picked], f"{label}: ran {ran}")
                check(bitwise(got, want), f"{label}: differs from plain")
                n += 1
                if picked == "vec4":  # the scalar kernel on the same inputs
                    check(bitwise(scatter_scalar(vals, idx, chunk), want),
                          f"chunk_scatter ({rows}, {chunk}) top-{topm} scalar: differs from plain")
                    n += 1
                for copies in (1, 3, 8, 16):
                    x = tied_nan(rows * copies, chunk, gen)
                    order = torch.rand(rows, chunk, device="cuda", generator=gen).argsort(-1)
                    ids = order[:, :topm].to(torch.int32)
                    if topm > 1:
                        ids[::3, -1] = ids[::3, 0]
                    ids = ids.reshape(shape).contiguous()
                    label = f"chunk_gather ({rows} x {copies}, {chunk}) top-{topm}"
                    check(bitwise(ct.chunk_gather(x, ids), ct.chunk_gather_plain(x, ids)),
                          f"{label}: differs from plain")
                    # offsets outside the chunk: [-chunk, 0) counts from the row's
                    # end, as jnp.take_along_axis does; the rest give NaN
                    bad = ids.clone().view(rows, -1)
                    bad[::4, 0], bad[1::4, -1] = -1, chunk
                    bad[2::4, 0], bad[3::4, -1] = -chunk, -chunk - 1
                    bad = bad.view(shape)
                    check(bitwise(ct.chunk_gather(x, bad), ct.chunk_gather_plain(x, bad)),
                          f"{label}: offsets outside the chunk differ from plain")
                    n += 2
    torch.cuda.synchronize()
    print(f"[kernel] scatter and gather boundaries: {n} cases (rows 1, 33 and 100003, chunk "
          f"4/8/17/64/128, top-m 1, 2, {limit} and {limit + 1}, duplicates, -0, inf, NaN "
          f"payloads; the scatter in each variant that takes the shape, the gather per worker "
          f"and shared over 3, 8 and 16 copies, offsets -chunk, -1, chunk and -chunk - 1): bitwise "
          f"equal to plain, each scatter in the variant it picks and the scalar kernel beside vec4")


def fused_boundaries(gen) -> None:
    """fused_reduce at the edges of its variants, both bitwise against the
    plain version, checking which variant the wrapper ran: chunk 4, 8, 17,
    64 and 128; top-m 1, 2, 8 and 9; 1, 3, 8 and 64 workers (at 8 the vec4
    true_topk select is staged in shared memory, at 64 it re-reads L2); 1 and
    33 rows, and 100,003 at 3 and 8 workers; m or g 4 bytes past 16-byte
    alignment; clt_k with the first and the last worker as leader, and
    true_topk; ties, -0, +-inf and NaNs of both signs and many payloads.
    Where the wrapper runs vec4, the scalar kernel runs on the same inputs."""
    import torch

    from repro_torch.kernels import chunk_topk as ct, fused_reduce as frk

    limit, n = ct.VEC4_MAX_TOPM, 0
    for workers in (1, 3, 8, 64):
        for rows in (1, 33) + ((100_003,) if workers in (3, 8) else ()):
            for chunk in (4, 8, 17, 64, 128):
                if rows > 33 and chunk not in (17, 64):
                    continue
                size = workers * rows * chunk
                mg = tied_nan(2 * workers * rows, chunk, gen).view(2, workers, rows, chunk)
                flat = torch.empty(2 * size + 4, device="cuda")
                mis = flat[1:1 + 2 * size].view(2, workers, rows, chunk)  # m and g misaligned
                mis.copy_(mg)
                for topm in sorted({1, 2, min(limit, chunk), min(limit + 1, chunk)}):
                    if rows > 33 and topm > 2:
                        continue
                    for mode, leader in (("clt_k", 0), ("clt_k", workers - 1), ("true_topk", 0)):
                        want = frk.fused_reduce_plain(mg[0], mg[1], BETA, topm, mode, leader)
                        label = f"fused_reduce ({workers}, {rows}, {chunk}) {mode} top-{topm}"
                        for m_, g_, where in ((mg[0], mg[1], ""), (mis[0], mg[1], ", m misaligned"),
                                              (mg[0], mis[1], ", g misaligned")):
                            picked = frk.fused_variant(chunk, m_.data_ptr(), g_.data_ptr(), topm)
                            before = dict(frk.fused_reduce.variants)
                            got = frk.fused_reduce(m_, g_, BETA, topm, mode, leader)
                            ran = [v for v in before if frk.fused_reduce.variants[v] != before[v]]
                            check(ran == [picked], f"{label}{where}: ran {ran}, want {picked}")
                            check(bitwise(got, want),
                                  f"{label}{where}: {picked} differs from plain")
                            n += 1
                            if picked == "vec4":
                                check(bitwise(fused_scalar(m_, g_, BETA, topm, mode, leader), want),
                                      f"{label}{where}: the scalar kernel differs from plain")
                                n += 1
                del mg, flat, mis
    torch.cuda.synchronize()
    print(f"[kernel] fused boundaries: {n} cases (1, 3, 8 and 64 workers; rows 1, 33 and 100003; "
          f"chunk 4/8/17/64/128; top-m 1, 2, {limit} and {limit + 1}; m or g misaligned; clt_k "
          f"with the first and last leader, true_topk; ties, -0, inf, NaN payloads): each ran the "
          f"variant fused_variant picks, and the scalar kernel beside vec4: bitwise equal to plain")


SELECT_UPDATE_ODD_ROWS = (1, 3, 33, 255, 1031)  # small odd row counts, every block size
SELECT_UPDATE_CHUNKS = (4, 8, 64, 128)  # lanes per row 1, 2, 4 and 8; 2 batches at 128


def select_update_checks(gen, record, results: dict, card_line: str) -> None:
    """``fused_select_update`` (the fused reduce's one-row variant, a process
    group leader's select and Eq. 5 update) against its plain twin, bitwise:
    at the tok_embed one-row shapes (296,000 rows of 64) for the m + g
    select and the keyed one (true_topk's), top-1 and top-2, timed beside
    its byte bound and beside the unfused kernels it replaces
    (``chunk_argmax`` on m + g, then ``ef_update``); at every block size the
    autotuner tries for the fused reduce (``CANDIDATE_THREADS``), at the
    tok_embed shapes and at small odd row counts; at chunk 4, 8, 64 and 128
    (128: a lane's share of a row is two batches, re-read in the update),
    top-m 1, 2 and 8, on rows full of ties, -0, +-inf and NaN payloads."""
    import torch

    from repro_torch.kernels import build, chunk_topk as ct, ef_update as efk
    from repro_torch.kernels import fused_reduce as frk

    m1 = torch.randn(R, CHUNK, device="cuda", generator=gen)
    g1 = torch.randn(R, CHUNK, device="cuda", generator=gen)
    ties = torch.randint(-3, 4, g1[::997].shape, device="cuda", generator=gen).float()
    g1[::997] = ties - m1[::997]  # m + g near small integers: ties in the select
    key = torch.randn(R, CHUNK, device="cuda", generator=gen)
    for route, k in (("", None), ("key", key)):
        for topm in (1, 2):
            label = "fused_select_update" + (f"[{', '.join(filter(None, (route, f'top-{topm}')))}]"
                                             if (route, topm) != ("", 1) else "")
            nbytes = (3 + (k is not None)) * R * CHUNK * 4 + R * topm * 8
            record(label, lambda k=k, topm=topm: frk.fused_select_update(m1, g1, BETA, CHUNK,
                                                                           topm, k),
                   lambda k=k, topm=topm: frk.fused_select_update_plain(m1, g1, BETA, CHUNK,
                                                                          topm, k),
                   None, "no single call", nbytes, 7 * R * CHUNK)
            results[label]["variant"] = "vec4"
    # the unfused kernels it replaces on the leader, from the same inputs
    ef = m1 + g1
    idx = ct.chunk_argmax(ef)[0]
    sel_ms = device_ms(lambda: ct.chunk_argmax(ef), (counter("chunk_argmax"), 1),
                       what="[kernel] select on one row")
    upd_ms = device_ms(lambda: efk.ef_update(m1, g1, idx, BETA), (counter("ef_update"), 1),
                       what="[kernel] ef_update on one row")
    r = results["fused_select_update"]
    r["unfused_ms"] = {"chunk_argmax": sel_ms, "ef_update": upd_ms}
    unfused_bound = bound(R * CHUNK * 4 + R * 8 + 3 * R * CHUNK * 4 + R * 8, 0)[0]
    print(f"[kernel] fused_select_update at the tok_embed one-row shapes: {r['ms']:.4f} device ms "
          f"({r['bound_ms'] / r['ms']:.0%} of its bound {r['bound_ms']:.4f}) against the "
          f"unfused chunk_argmax {sel_ms:.4f} + ef_update {upd_ms:.4f} = {sel_ms + upd_ms:.4f} "
          f"(their bound {unfused_bound:.4f}, and m + g before them) on {card_line}")
    # every block size at top-1, both routes, against the plain twin
    n = 0
    for threads in build.CANDIDATE_THREADS:
        for k in (None, key):
            want = frk.fused_select_update_plain(m1, g1, BETA, CHUNK, 1, k)
            before = frk.fused_select_update.threads[threads]
            check(bitwise(frk.fused_select_update(m1, g1, BETA, CHUNK, 1, k, threads=threads),
                          want) and frk.fused_select_update.threads[threads] == before + 1,
                  f"fused_select_update at {threads} threads differs from plain or ran at "
                  f"another size")
            n += 1
        r[f"threads_{threads}_ms"] = device_ms(
            lambda threads=threads: frk.fused_select_update(m1, g1, BETA, CHUNK, 1,
                                                            threads=threads),
            (counter("fused_select_update"), 1), what=f"fused_select_update {threads}")
    del m1, g1, key, ef, idx
    for rows in SELECT_UPDATE_ODD_ROWS:
        for chunk in SELECT_UPDATE_CHUNKS:
            mg = tied_nan(3 * rows, chunk, gen).view(3, rows, chunk)
            for topm in sorted({1, 2, min(ct.VEC4_MAX_TOPM, chunk)}):
                for k in (None, mg[2]):
                    want = frk.fused_select_update_plain(mg[0], mg[1], BETA, chunk, topm, k)
                    sizes = build.CANDIDATE_THREADS if topm == 1 else (None,)
                    for threads in sizes:
                        got = frk.fused_select_update(mg[0], mg[1], BETA, chunk, topm, k,
                                                      threads=threads)
                        check(bitwise(got, want),
                              f"fused_select_update ({rows}, {chunk}) top-{topm} "
                              f"{'key' if k is not None else 'm + g'} at {threads} threads "
                              f"differs from plain")
                        n += 1
            del mg
    torch.cuda.synchronize()
    print(f"[kernel] fused_select_update: {n} cases bitwise equal to plain: both routes at "
          f"every block size {build.CANDIDATE_THREADS} at the tok_embed one-row shapes (device "
          f"ms " + ", ".join(f"{t}: {r[f'threads_{t}_ms']:.4f}" for t in build.CANDIDATE_THREADS)
          + f"), and rows {SELECT_UPDATE_ODD_ROWS} x chunk {SELECT_UPDATE_CHUNKS} x top-m "
          f"1/2/8 full of ties, -0, inf and NaN payloads, top-1 at every block size, on "
          f"{card_line}")


def fused_past_int32(gen) -> None:
    """fused_reduce over (8, rows, 64) m and g past 2^31 elements, if the card
    holds it: both variants at clt_k top-1 and top-2 and true_topk top-1,
    against the plain version on the first and the last 4096 rows (rows are
    independent, so a slice's reduce is the whole one's slice)."""
    import torch

    from repro_torch.kernels import fused_reduce as frk

    rows, tail = 2**31 // (G * CHUNK) + 1001, 4096
    nbytes = G * rows * CHUNK * 4
    free, _ = torch.cuda.mem_get_info()
    if free < 4 * nbytes:
        print(f"[kernel] fused past 2^31 elements: not run, {free / 2**30:.1f} GiB free of the "
              f"{4 * nbytes / 2**30:.1f} GiB it needs")
        return
    m = torch.empty(G, rows, CHUNK, device="cuda").normal_(generator=gen)
    g = torch.empty(G, rows, CHUNK, device="cuda").normal_(generator=gen)
    m[:, ::997] = torch.randint(-3, 4, m[:, ::997].shape, device="cuda", generator=gen).float()
    m[-1, -1, ::3] = float("nan")
    ends = (slice(0, tail), slice(rows - tail, rows))
    for mode, topm, leader in (("clt_k", 1, 7), ("clt_k", 2, 7), ("true_topk", 1, 0)):
        wants = [frk.fused_reduce_plain(m[:, e].contiguous(), g[:, e].contiguous(), BETA, topm,
                                        mode, leader) for e in ends]
        before = frk.fused_reduce.variants["vec4"]
        for name, fn in (("vec4", frk.fused_reduce), ("scalar", fused_scalar)):
            idx, vals, m_new, ghat = fn(m, g, BETA, topm, mode, leader)
            for e, want in zip(ends, wants):
                check(bitwise((idx[e], vals[:, e], m_new[:, e], ghat[e]), want),
                      f"fused_reduce {name} {mode} top-{topm} past 2^31 elements differs from "
                      f"plain on rows {e.start}..{e.stop}")
            del idx, vals, m_new, ghat
        check(frk.fused_reduce.variants["vec4"] == before + 1,
              f"fused_reduce past 2^31 elements did not run vec4 ({frk.fused_reduce.variants})")
        del wants
    del m, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[kernel] fused past 2^31 elements ({G} x {rows:,} rows of {CHUNK}, "
          f"{G * rows * CHUNK:,} elements): clt_k top-1 and top-2, true_topk top-1, vec4 and "
          f"scalar: bitwise equal to plain on the first and last {tail} rows")


def past_int32(gen) -> None:
    """One tensor past 2^31 elements, if the card holds it: int64 offsets in
    both variants of the selects and the scatter, and in the gather."""
    import torch

    from repro_torch.kernels import chunk_topk as ct

    rows = 2**31 // CHUNK + 1001
    nbytes = rows * CHUNK * 4
    free, _ = torch.cuda.mem_get_info()
    if free < 5 * nbytes:
        print(f"[kernel] past 2^31 elements: not run, {free / 2**30:.1f} GiB free of the "
              f"{5 * nbytes / 2**30:.1f} GiB it needs")
        return
    big = torch.empty(rows * CHUNK + 4, device="cuda")
    big.normal_(generator=gen)
    for base, want in ((0, "vec4"), (1, "scalar")):
        x = big[base:base + rows * CHUNK].view(rows, CHUNK)
        x[::997] = torch.randint(-3, 4, x[::997].shape, device="cuda", generator=gen).float()
        x[-1] = float("nan")
        for topm in (None, 2):
            kern = ct.chunk_argmax if topm is None else ct.chunk_topm
            before = kern.variants[want]
            out = ct.chunk_argmax(x) if topm is None else ct.chunk_topm(x, topm)
            plain = ct.chunk_argmax_plain(x) if topm is None else ct.chunk_topm_plain(x, topm)
            check(kern.variants[want] == before + 1 and bitwise(out, plain),
                  f"{rows * CHUNK:,} elements, {want}, {kern.__name__}: differs from plain or "
                  f"ran another variant")
            del out, plain
    # the gather of the last worker's rows (a shared set over 8 copies and a
    # per-worker set), and the scatter of the whole tensor's rows
    x = big[:rows * CHUNK].view(rows, CHUNK)
    shared = rows // 8
    for xs, ids in ((x[-8 * shared:], torch.randint(0, CHUNK, (shared,), device="cuda",
                                                   generator=gen, dtype=torch.int32)),
                    (x, torch.randint(0, CHUNK, (rows,), device="cuda", generator=gen,
                                      dtype=torch.int32))):
        check(bitwise(ct.chunk_gather(xs, ids), ct.chunk_gather_plain(xs, ids)),
              f"chunk_gather past 2^31 elements ({ids.shape[0]:,} offsets) differs from plain")
    vals = x[:, 0].contiguous()
    want = ct.chunk_scatter_plain(vals, ids, CHUNK)
    before = ct.chunk_scatter.variants["vec4"]
    check(bitwise(ct.chunk_scatter(vals, ids, CHUNK), want)
          and ct.chunk_scatter.variants["vec4"] == before + 1,
          "chunk_scatter vec4 past 2^31 elements differs from plain or did not run")
    check(bitwise(scatter_scalar(vals, ids, CHUNK), want),
          "chunk_scatter scalar past 2^31 elements differs from plain")
    del want
    del big, x, xs, ids, vals
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[kernel] past 2^31 elements ({rows:,} rows of {CHUNK}, "
          f"{rows * CHUNK:,} elements): argmax and top-2, vec4 and scalar variants; the "
          f"scatter in both variants; the gather, shared and per-worker: bitwise equal to plain")


def path_selects(plans, rr_plans, workers: int, card_line: str) -> None:
    """Both selects at the shapes one compressed step gives them on their
    path: chunk_argmax over every compressed tensor of the unfused CLT-k step,
    chunk_topm over the tensors a top-2 rate rule puts at top-2. Each
    tensor's rows are selected from an aligned base (vec4) and a misaligned
    one (scalar). Prints the device time of one step's calls (``device_ms``:
    queued ahead, so no host dispatch; CUDA events around a small tensor's
    call would count the wrapper's host dispatch too) beside the summed byte
    bound, and the CUDA-event time of the step's calls back to back, dispatch
    gaps included, which is what the path sees."""
    import torch

    from repro_torch.kernels import chunk_topk as ct

    reps = 10
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, chosen in (("chunk_argmax", [p for p in plans if not p.dense and p.comp.topm == 1]),
                         ("chunk_topm", [p for p in rr_plans if not p.dense and p.comp.topm > 1])):
        calls, bound_ms, elements = [], 0.0, 0
        for p in chosen:
            rows, chunk, topm = workers * p.n_chunks, p.comp.chunk, p.comp.topm
            buf = torch.randn(rows * chunk + 4, device="cuda", generator=gen)
            xs = [buf[base:base + rows * chunk].view(rows, chunk) for base in (0, 1)]
            for x, want in zip(xs, ("vec4", "scalar")):
                check(ct.select_variant(chunk, x.data_ptr(), topm) == want,
                      f"{name} at {p.path}: the {want} variant would not run")
            calls.append((xs, topm))
            bound_ms += bound(rows * chunk * 4 + rows * topm * 8, 0)[0]
            elements += rows * chunk

        def step(base, calls=calls):
            for xs, topm in calls:
                ct.chunk_argmax(xs[base]) if topm == 1 else ct.chunk_topm(xs[base], topm)

        wall = [time_ms(lambda: step(base)) for base in (0, 1)]
        vec4, scalar = (device_ms(lambda base=base: step(base), (counter(name, v), len(calls)), reps)
                        for base, v in ((0, "vec4"), (1, "scalar")))
        dev_text = (f"device ms {vec4:.4f} per step (scalar variant {scalar:.4f}), bound ms "
                    f"{bound_ms:.4f}, lost {vec4 - bound_ms:.4f} per step")
        print(f"[path] {name} over the {len(chosen)} tensors one compressed step gives it "
              f"({elements:,} elements, {workers} workers): {dev_text}; the calls back to back "
              f"{wall[0]:.4f} ms on the card's clock (scalar {wall[1]:.4f}) on {card_line}")
        del calls


def path_scatter(plans, card_line: str) -> None:
    """chunk_scatter at the shapes one unfused CLT-k step gives it: the ĝ of
    every compressed tensor, R = n_chunks rows of (worker-mean value, leader
    offset). Prints the device time of one step's calls (``device_ms``) in
    both variants on the same inputs (vec4, the new design; scalar, the
    first) beside the summed byte bound, and the calls back to back on the
    card's clock (CUDA events, dispatch included)."""
    import torch

    from repro_torch.kernels import chunk_topk as ct

    reps = 10
    gen = torch.Generator(device="cuda").manual_seed(2)
    chosen = [p for p in plans if not p.dense and p.comp.topm == 1]
    calls, bound_ms, rows = [], 0.0, 0
    for p in chosen:
        n, chunk = p.n_chunks, p.comp.chunk
        calls.append((torch.randn(n, device="cuda", generator=gen),
                      torch.randint(0, chunk, (n,), device="cuda", generator=gen,
                                    dtype=torch.int32), chunk))
        bound_ms += bound(n * 8 + n * chunk * 4, 0)[0]
        rows += n
    for _, _, chunk in calls:
        check(ct.scatter_variant(chunk) == "vec4", f"chunk_scatter at chunk {chunk}: not vec4")

    def step(variant):
        scatter = ct.chunk_scatter if variant == "vec4" else scatter_scalar
        for v, i, chunk in calls:
            scatter(v, i, chunk)

    wall = {v: time_ms(lambda v=v: step(v)) for v in ("vec4", "scalar")}
    text = []
    for v, launched in (("vec4", counter("chunk_scatter", "vec4")),
                        ("scalar", lambda: scatter_scalar.launches)):
        ms = device_ms(lambda v=v: step(v), (launched, len(calls)), reps)
        text.append(f"{v} variant {ms:.4f} device ms ({bound_ms / ms:.0%} of the bound), "
                    f"{wall[v]:.4f} ms back to back")
    print(f"[path] chunk_scatter over the {len(chosen)} tensors one unfused compressed step gives "
          f"it ({rows:,} rows, {sum(i.numel() * c for _, i, c in calls):,} elements written): "
          f"bound ms {bound_ms:.4f}; {'; '.join(text)} on {card_line}")
    del calls


LOSSY = ("bf16", "fp8", "fp8_ec")
# relative error a re-encode may add: the per-step bounds of the JAX package's
# 50-step codec contraction test (tests/test_compat.py), which the port's
# CPU tests hold it to as well
CODEC_TOL = {"fp32": 1e-6, "bf16": 6e-3, "fp8": 6e-2, "fp8_ec": 5e-4}


def same_enc(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(bitwise(a[k], b[k]) for k in a)


def enc_bytes(enc: dict) -> int:
    return sum(t.numel() * t.element_size() for t in enc.values())


def same_reduce(a, b, what: str, ghat_exact: bool = True) -> None:
    """ĝ (bitwise, or to TOL) and every residue leaf (bitwise) of two reduces."""
    from repro_torch import tree

    for (path, x), (_, y) in zip(tree.flatten_with_path(a[0]), tree.flatten_with_path(b[0])):
        check(bitwise(x, y) if ghat_exact else close(x, y), f"{what}: ghat {path} differs")
    check(a[1].residues.keys() == b[1].residues.keys() and a[1].t == b[1].t,
          f"{what}: state keys or step counter differ")
    for path, enc in a[1].residues.items():
        check(same_enc(enc, b[1].residues[path]), f"{what}: residue {path} differs")


def edge_values():
    """fp32 values at the casts' edges (CPU): a hair above 448, the 464 tie,
    overflow, +-inf, NaN payloads of both signs, e4m3 and fp32 subnormals,
    +-0, bf16 rounding ties; then normal values."""
    import torch

    gen = torch.Generator().manual_seed(7)
    s = torch.tensor([0.0, -0.0, 448.0, 448.01, 455.0, 463.99, 464.0, 464.01, 470.0, 479.9,
                      480.0, 1e9, 3.39e38, 3.4028235e38, float("inf"), float("nan"), 2.0**-9,
                      2.0**-10, 1.5 * 2.0**-9, 2.0**-7, 1.0001 * 2.0**-10, 1e-30, 1e-40, 2e-45,
                      1.0 + 2.0**-9, 1.0 + 3 * 2.0**-9])
    pay = torch.randint(1, 1 << 22, (16,), generator=gen, dtype=torch.int32)
    nans = (pay | 0x7F800000).view(torch.float32)
    return torch.cat([s, -s, nans, -nans, 100 * torch.randn(4096, generator=gen)])


def codec_card_vs_cpu(m, t: int) -> None:
    """Encode of the same fp32 residue on the card and on the CPU, bitwise,
    for every codec: nearest rounding, and stochastic rounding with one
    dither tensor on both. Then the casts and stochastic rounding at their
    edges (NaN, inf and all) and whole encodes of finite edge blocks."""
    import torch

    from repro_torch.core import state as st

    m_cpu = m.cpu()
    storage = (m.shape[1],)
    for name, codec in st.CODECS.items():
        enc = codec.encode(m, storage)
        check(same_enc(enc, codec.encode(m_cpu, storage)),
              f"{name}: nearest encode on the card differs from the CPU's")
        check(bitwise(codec.decode(enc, storage), codec.decode(
            {k: v.cpu() for k, v in enc.items()}, storage)), f"{name}: decode card vs CPU")
        rounded = {"bf16": "q", "fp8_ec": "c"}.get(name)
        if rounded:
            d = st.codec_dither(st.codec_key("['tok_embed']", t), enc[rounded].shape, m.device)
            check(same_enc(codec.encode(m, storage, key=d), codec.encode(m_cpu, storage,
                                                                          key=d.cpu())),
                  f"{name}: stochastic encode on the card differs from the CPU's, same dither")
        del enc
    e = edge_values()
    ec = e.to(m.device)
    d = torch.randint(0, 1 << 16, e.shape, generator=torch.Generator().manual_seed(8),
                      dtype=torch.int32)
    check(bitwise(st._to_e4m3(ec), st._to_e4m3(e)), "e4m3 cast at the edges: card vs CPU")
    check(bitwise(st._to_bf16(ec), st._to_bf16(e)), "bf16 cast at the edges: card vs CPU")
    check(bitwise(st.stochastic_round(ec, d.to(m.device)), st.stochastic_round(e, d)),
          "stochastic rounding at the edges: card vs CPU")
    finite = e[torch.isfinite(e) & (e.abs() < 1e38)]
    blocks = torch.stack([finite * s for s in (1.0, 2.0**-60, 2.0**60, 2.0**-120)])
    for name, codec in st.CODECS.items():
        shape = (blocks.shape[1],)
        check(same_enc(codec.encode(blocks.to(m.device), shape), codec.encode(blocks, shape)),
              f"{name}: encode of the finite edge blocks, card vs CPU")
    print(f"[codec] the trained tok_embed residue ({m.numel():,} elements): encode and decode on "
          f"the card == on the CPU, bitwise, for {', '.join(st.CODECS)} (nearest; bf16 and "
          f"fp8_ec also stochastic, one dither on both); the e4m3 and bf16 casts and "
          f"stochastic rounding at {e.numel()} edge values (+-inf, NaN payloads, 448.01..480, "
          f"subnormals, +-0) and every codec's encode of finite edge blocks at scales "
          f"2^-120..2^60: bitwise")


def codec_table_card() -> None:
    """``python -m repro_torch.analysis.report --codecs`` on the card (its
    default device): every codec's per-step roundtrip error a contraction
    under the bound the CPU tests hold it to, the drift under ten times it."""
    import io

    from repro_torch.analysis import report

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report.main(["--codecs"])
    table = out.getvalue().strip()
    bounds = {"fp32": 1e-12, "bf16": 6e-3, "fp8": 6e-2, "fp8_ec": 5e-4}
    rows = {}
    for line in table.splitlines()[4:]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        rows[cells[0]] = [float(c) for c in cells[1:]]
    check(list(rows) == list(bounds), f"[codec] the --codecs table's rows: {list(rows)}")
    for name, (worst, last, drift) in rows.items():
        check(0 <= last <= worst < bounds[name] and drift < max(10 * bounds[name], 1e-12),
              f"[codec] --codecs on the card, {name}: worst {worst}, last {last}, drift {drift}")
    print("[codec] python -m repro_torch.analysis.report --codecs on the card, every codec "
          "within its bound:")
    print(table)


def codec_reduces(gpw, state, cfg, name: str, card_line: str) -> None:
    """Teacher-forced from a codec's trained state: unfused cuda == torch
    backend (ĝ and residues bitwise: the same draws on one card); fused cuda
    == unfused cuda on the residues bitwise, ĝ to TOL."""
    unfused = dataclasses.replace(cfg, fused=False)
    from repro_torch.core.scalecom import scalecom_reduce

    u_c, ms_u = host_ms(lambda: scalecom_reduce(gpw, state,
                                                dataclasses.replace(unfused, backend="cuda")))
    u_t = scalecom_reduce(gpw, state, dataclasses.replace(unfused, backend="torch"))
    same_reduce(u_c, u_t, f"{name} unfused cuda vs torch backend")
    del u_t
    from repro_torch.kernels import fused_reduce as frk

    fused = dataclasses.replace(cfg, fused=True, backend="cuda")
    before = dict(frk.fused_reduce.variants)
    f_c, ms_f = host_ms(lambda: scalecom_reduce(gpw, state, fused))
    same_reduce(f_c, u_c, f"{name} fused vs unfused cuda", ghat_exact=False)
    ms_f2 = host_ms(lambda: scalecom_reduce(gpw, state, fused))[1]
    ran = {v: frk.fused_reduce.variants[v] - before[v] for v in before}
    print(f"[reduce] {name} residues, teacher-forced from the trained state (t={state.t}): "
          f"unfused cuda == torch backend (ghat and residues bitwise); fused cuda == unfused "
          f"cuda (residues bitwise, ghat within rtol 1e-6 / atol 1e-7; fused_reduce launches by "
          f"variant {ran}); host clock: unfused cuda {ms_u:.2f} ms, fused cuda {ms_f:.2f} and "
          f"{ms_f2:.2f} ms on {card_line}")


def codec_times(state, plans, name: str, card_line: str) -> dict:
    """Device time of one compressed step's decode and of its encode (with
    the step's stochastic-rounding draws) over the tensors the step
    compresses, beside their summed byte bound (decode reads the encoding
    and writes fp32, encode the reverse), and their host clock."""
    from repro_torch.core.state import CODECS, codec_key

    codec = CODECS[name]
    chosen = [p for p in plans if not p.dense]
    encs = [state.residues[p.path] for p in chosen]
    ms = [codec.decode(e, p.storage).contiguous() for e, p in zip(encs, chosen)]
    nbytes = sum(enc_bytes(e) + m.numel() * 4 for e, m in zip(encs, ms))
    bound_ms = bound(nbytes, 0)[0]

    def decode_all():
        return [codec.decode(e, p.storage) for e, p in zip(encs, chosen)]

    def encode_all():
        return [codec.encode(m, p.storage, key=codec_key(p.path, state.t))
                for m, p in zip(ms, chosen)]

    out = {}
    for what, fn in (("decode", decode_all), ("encode", encode_all)):
        # a few hundred launches per call: two calls queue ahead, or one
        out[what] = dict(ms=device_ms(fn, reps=2, what=f"{name} {what}"),
                         host_ms=host_ms(fn)[1])
    print(f"[codec] {name} over the {len(chosen)} tensors one compressed step gives it "
          f"({sum(m.numel() for m in ms):,} elements, {nbytes / 1e9:.3f} GB each way): decode "
          f"{out['decode']['ms']:.4f} device ms, encode {out['encode']['ms']:.4f}; bound ms "
          f"{bound_ms:.4f} each ({bound_ms / out['decode']['ms']:.0%} and "
          f"{bound_ms / out['encode']['ms']:.0%} of it); host clock {out['decode']['host_ms']:.2f} "
          f"and {out['encode']['host_ms']:.2f} ms on {card_line}")
    return out


def remap_checks(states: dict, workers: int) -> None:
    """``remap_state`` on the card. fp32 8 -> 4 -> 8: the expand repeats
    each row bitwise and folding back gives the 4-worker state bitwise.
    Every codec 8 -> 6 (through lcm 24): the re-encoded residue within the
    codec's bound of the fp32 remap of its decoded rows, and the worker mean
    kept within that bound (a mean's error is at most the rows' rms error)."""
    import torch

    from repro_torch.core.state import CODECS, remap_state

    four = remap_state(states["fp32"], workers, 4)
    eight = remap_state(four, 4, workers)
    back = remap_state(eight, workers, 4)
    r = workers // 4
    for path, enc in four.residues.items():
        q8 = eight.residues[path]["q"]
        check(all(bitwise(q8[i::r], enc["q"]) for i in range(r))
              and bitwise(back.residues[path]["q"], enc["q"]),
              f"fp32 remap {workers} -> 4 -> {workers}: {path} not bitwise")
    del four, eight, back
    worst = {}
    for name, state in states.items():
        codec = CODECS[name]
        six = remap_state(state, workers, 6, name)
        worst[name] = (0.0, 0.0)
        for path, enc in state.residues.items():
            shape = tuple(enc["q"].shape[1:])
            old = codec.decode(enc, shape)
            lcm = math.lcm(workers, 6)
            exact = torch.repeat_interleave(old, lcm // workers, 0).reshape(
                (6, lcm // 6) + tuple(old.shape[1:])).mean(1)
            new = codec.decode(six.residues[path], shape)
            norm = float(torch.linalg.norm(exact)) or 1.0
            err = float(torch.linalg.norm(new - exact)) / norm
            mean_err = float(torch.linalg.norm(new.mean(0) - old.mean(0)))
            mean_lim = CODEC_TOL[name] * norm / math.sqrt(6) + 1e-5 * float(
                torch.linalg.norm(old.mean(0)))
            check(six.residues[path]["q"].shape[0] == 6 and six.t == state.t,
                  f"{name} remap {workers} -> 6: {path} shape or t")
            check(err <= CODEC_TOL[name] and mean_err <= mean_lim,
                  f"{name} remap {workers} -> 6: {path} error {err:.3g} (bound "
                  f"{CODEC_TOL[name]}), mean error {mean_err:.3g} (bound {mean_lim:.3g})")
            worst[name] = (max(worst[name][0], err), max(worst[name][1], mean_err / mean_lim))
            del old, exact, new
        del six
    text = ", ".join(f"{n} {e:.2g} (bound {CODEC_TOL[n]:g}), mean at {m:.0%} of its bound"
                     for n, (e, m) in worst.items())
    print(f"[remap] on the card: fp32 {workers} -> 4 -> {workers} bitwise (the expand repeats, "
          f"the fold back); {workers} -> 6 through lcm 24, worst relative error of the "
          f"re-encoded residues against the fp32 remap: {text}")


def bucket_phase(gpw, state, cfg, workers: int, card_line: str) -> None:
    """Bucketed reduces (25 MB and 4 MB, overlap on and off, unfused and
    fused) against the unbucketed one: ĝ and residues bitwise, two calls
    back to back each (the side stream's tensors are handed back to the
    caller's stream). The number of buckets, host ms and device ms. Then
    ``measured_bucket_timeline`` at the default 25 MB: each bucket's reduce
    alone and the full bucketed reduce, beside the modeled timeline."""
    from repro_torch import tree
    import torch

    from repro_torch.core.plan import plan_buckets, plan_tensors
    from repro_torch.core.scalecom import scalecom_reduce
    from repro_torch.core.state import residue_signature
    from repro_torch.kernels import fused_reduce as frk
    from repro_torch.obs.tracing import measured_bucket_timeline

    plans = plan_tensors(tuple((p, tuple(g.shape[1:]), workers)
                               for p, g in tree.flatten_with_path(gpw)), cfg,
                         residue_signature(state.residues))
    for fused in (False, True):
        base = dataclasses.replace(cfg, fused=fused, backend="cuda")
        before = dict(frk.fused_reduce.variants)
        ref, ms = host_ms(lambda: scalecom_reduce(gpw, state, base, buckets=False))
        label = "fused" if fused else "unfused"
        # a reduce is 50-150 launches: two calls queue ahead of the card
        dev = device_ms(lambda: scalecom_reduce(gpw, state, base, buckets=False), reps=2,
                        what=f"{label} unbucketed reduce")
        print(f"[bucket] {label} unbucketed: {ms:.2f} ms host clock, {dev:.3f} device ms "
              f"on {card_line}")
        for mb in ((25, 4) if not fused else (4,)):
            n_buckets = len(plan_buckets(plans, mb << 20))
            for overlap in (True, False):
                c = dataclasses.replace(base, overlap=overlap)
                (a, b), ms = host_ms(lambda: (scalecom_reduce(gpw, state, c, buckets=mb << 20),
                                              scalecom_reduce(gpw, state, c, buckets=mb << 20)))
                what = f"{label} {mb} MB buckets, overlap {'on' if overlap else 'off'}"
                same_reduce(a, ref, what + " (first call)")
                same_reduce(b, ref, what + " (second call, back to back)")
                del a, b
                dev = device_ms(lambda: scalecom_reduce(gpw, state, c, buckets=mb << 20),
                                reps=2, what=what)
                print(f"[bucket] {what}: {n_buckets} buckets; two calls back to back bitwise "
                      f"equal to unbucketed; {ms / 2:.2f} ms host clock per call, {dev:.3f} "
                      f"device ms on {card_line}")
        if fused:
            ran = {v: frk.fused_reduce.variants[v] - before[v] for v in before}
            print(f"[bucket] fused reduces, unbucketed and bucketed: fused_reduce launches by "
                  f"variant {ran}")
        del ref
    # the measured timeline at the default 25 MB buckets, beside the modeled one
    tl = measured_bucket_timeline(gpw, dataclasses.replace(cfg, fused=False, backend="cuda"),
                                  buckets=True)
    spans = tl["tracer"].spans
    check(tl["device_kind"] == torch.cuda.get_device_name(0) and len(tl["buckets"]) > 1
          and [s.name for s in spans] == ["plan"] + [f"bucket[{r['bucket']}]" for r in tl["buckets"]]
          + ["reduce/full"] and all(s.dur_us > 0 for s in spans) and tl["modeled"] is not None,
          f"[bucket] measured_bucket_timeline: {[(s.name, s.dur_us) for s in spans]}")
    print(f"[bucket] measured_bucket_timeline, unfused, {cfg.bucket_bytes >> 20} MB buckets: plan "
          f"{spans[0].dur_us / 1e3:.3f} ms; " + "; ".join(
              f"bucket[{r['bucket']}] {r['bytes_dense'] / 2**20:.2f} MB dense, "
              f"{r['bytes_payload'] / 2**20:.3f} MB payload: {r['measured_us'] / 1e3:.3f} ms"
              for r in tl["buckets"])
          + f"; buckets summed {sum(r['measured_us'] for r in tl['buckets']) / 1e3:.3f} ms, the "
          f"full bucketed reduce {tl['full_us'] / 1e3:.3f} ms (host clock around synced calls) "
          f"on {card_line}")
    print(f"[bucket] modeled (analysis.perfmodel.overlap_report of reference_transformer_perf, "
          f"scalecom, {cfg.bucket_bytes >> 20} MB): "
          + ", ".join(f"{k} {v:.6g}" for k, v in tl["modeled"].items()))


def telemetry_phase(gpw, state, cfg, card_line: str) -> None:
    """Reduces with telemetry=True (metrics_every 1, unbucketed and 4 MB
    buckets on the side stream, unfused and fused) and with compute_stats,
    under ``torch.cuda.set_sync_debug_mode("error")``: any host sync in the
    reduce raises. ĝ and residues bitwise those of telemetry off; every tap
    a finite 0-d tensor on the card. Reduce time (host clock, and CUDA
    events around one call) with telemetry off, on with a sampled step and on
    with an unsampled one."""
    import torch

    from repro_torch.core.scalecom import scalecom_reduce

    off = dataclasses.replace(cfg, fused=False, backend="cuda")
    on = dataclasses.replace(off, telemetry=True, metrics_every=1)
    runs = {"unfused": (off, False), "unfused, 4 MB buckets": (off, 4 << 20),
            "fused": (dataclasses.replace(off, fused=True), False)}
    refs = {k: scalecom_reduce(gpw, state, c, buckets=b) for k, (c, b) in runs.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {k: scalecom_reduce(gpw, state, dataclasses.replace(
            on, fused=c.fused), buckets=b) for k, (c, b) in runs.items()}
        stats_run = scalecom_reduce(gpw, state, off, compute_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n_taps = {}
    for k, out in outs.items():
        same_reduce(out, refs[k], f"telemetry on vs off ({k})")
        obs = {key: v for key, v in out[2].items() if key.startswith("obs/")}
        for key, v in obs.items():
            check(isinstance(v, torch.Tensor) and v.dim() == 0 and v.is_cuda
                  and bool(torch.isfinite(v)), f"tap {key} ({k}): not a finite 0-d card tensor")
        n_taps[k] = len(obs)
    gamma = stats_run[2]["contraction_gamma"]
    check(isinstance(gamma, torch.Tensor) and gamma.is_cuda and bool(torch.isfinite(gamma)),
          "compute_stats contraction_gamma: not a finite tensor on the card")
    sampled = n_taps["unfused"]
    print(f"[telemetry] {', '.join(f'{k}: {n} taps' for k, n in n_taps.items())}; no host sync "
          f"in these reduces nor in compute_stats (set_sync_debug_mode error); ghat and "
          f"residues bitwise those of telemetry off; contraction_gamma "
          f"{float(gamma):.4f} left on the card")
    unsampled = dataclasses.replace(on, metrics_every=2 if state.t % 2 else 3)
    check(state.t % unsampled.metrics_every != 0, "the unsampled telemetry step is sampled")
    for label, c in (("off", off), ("on, similarity sampled", on),
                     ("on, similarity not sampled", unsampled)):
        _, ms = host_ms(lambda: scalecom_reduce(gpw, state, c))
        # a sampled step is thousands of launches, more than the card's launch
        # queue holds: CUDA events around one call, host dispatch included
        card = time_ms(lambda: scalecom_reduce(gpw, state, c), reps=3, warmup=1)
        print(f"[telemetry] unfused reduce, telemetry {label}: {ms:.2f} ms host clock, "
              f"{card:.2f} ms on the card's clock (CUDA events, dispatch included) on "
              f"{card_line}")
    del outs, refs, stats_run


def path_update(plans, workers: int, card_line: str, results: dict) -> None:
    """ef_update and fused_reduce at the shapes one compressed step gives
    them: every compressed tensor, (G x n_chunks, chunk) rows with a shared
    (n_chunks,) leader set for ef_update, (G, n_chunks, chunk) for the fused
    clt_k reduce. Device time per step (``device_ms``, exact launch count)
    beside the summed byte bound."""
    import torch

    from repro_torch.kernels import ef_update as efk, fused_reduce as frk

    gen = torch.Generator(device="cuda").manual_seed(3)
    chosen = [p for p in plans if not p.dense and p.comp.topm == 1]
    calls, b_ef, b_fr = [], 0.0, 0.0
    for p in chosen:
        n, chunk = p.n_chunks, p.comp.chunk
        m = torch.randn(workers, n, chunk, device="cuda", generator=gen)
        g = torch.randn(workers, n, chunk, device="cuda", generator=gen)
        idx = torch.randint(0, chunk, (n,), device="cuda", generator=gen, dtype=torch.int32)
        calls.append((m, g, idx))
        elems = workers * n * chunk
        b_ef += bound(3 * elems * 4 + n * 4 + workers * n * 4, 5 * elems)[0]
        b_fr += bound(3 * elems * 4 + workers * n * 4 + n * 4 + n * chunk * 4, 7 * elems)[0]

    def ef_step():
        for m, g, idx in calls:
            efk.ef_update(m.view(-1, m.shape[-1]), g.view(-1, g.shape[-1]), idx, BETA)

    def fr_step():
        for m, g, _ in calls:
            frk.fused_reduce(m, g, BETA, 1, "clt_k", 3)

    def fr_scalar_step():
        for m, g, _ in calls:
            fused_scalar(m, g, BETA, 1, "clt_k", 3)

    for key, fn, b, launched in (
            ("ef_update", ef_step, b_ef, counter("ef_update")),
            ("fused_reduce", fr_step, b_fr, counter("fused_reduce", "vec4")),
            ("fused_reduce scalar", fr_scalar_step, b_fr, lambda: fused_scalar.launches)):
        ms = device_ms(fn, (launched, len(calls)), reps=10, what=f"{key} path")
        name = key.split()[0]
        field = "path_scalar_ms" if key.endswith("scalar") else "path_ms"
        results[name][field], results[name]["path_bound_ms"] = ms, b
        kind = {"fused_reduce": " (vec4 variant)", "fused_reduce scalar": " (scalar kernel, the "
                "first design, same inputs)"}.get(key, "")
        print(f"[path] {name}{kind} over the {len(chosen)} tensors one compressed step gives it "
              f"({sum(m.numel() for m, _, _ in calls):,} elements, {workers} workers): device ms "
              f"{ms:.4f} per step, bound ms {b:.4f} ({b / ms:.0%} of it), lost {ms - b:.4f} per "
              f"step on {card_line}")
    del calls


AUTOTUNE_ITERS = 20  # calls queued per candidate in the sweep (the reference times 3)
AUTOTUNE_ODD_ROWS = (1, 3, 33, 255, 1031)  # small odd row counts, every block size
AUTOTUNE_ODD_CHUNKS = (4, 8, 64, 128)  # lanes per row 1, 2, 4 and 8


@contextlib.contextmanager
def autotune_cache(path: str):
    """The launch cache read from ``path`` inside the with-block; the
    in-process mirror is dropped on the way in and out."""
    from repro_torch.backends import autotune as at

    old = os.environ["SCALECOM_TORCH_AUTOTUNE_CACHE"]
    os.environ["SCALECOM_TORCH_AUTOTUNE_CACHE"] = path
    at.clear_cache()
    try:
        yield
    finally:
        os.environ["SCALECOM_TORCH_AUTOTUNE_CACHE"] = old
        at.clear_cache()


# the tuned launches: op (the autotuner's name) -> kernel
TUNED = {"select": "chunk_argmax", "ef_update": "ef_update", "fused_reduce": "fused_reduce"}


def tuned_wrappers() -> dict:
    """op -> the kernel wrapper of each tuned launch (its ``threads`` counts)."""
    from repro_torch import kernels

    by_name = {k.__name__: k for k in kernels.KERNELS}
    return {op: by_name[name] for op, name in TUNED.items()}


def tuned_bound(op: str, rows: int, workers: int) -> float:
    """bound_ms of one tuned launch as the main path makes it over a stack of
    ``workers`` x ``rows`` chunk rows of CHUNK: the select over all of them
    (read, (idx, val) written), ef_update over them with one shared index
    row set (m, g and idx read; m' and vals written), the fused clt_k top-1
    reduce on the stack (m and g read; idx, vals, m' and ghat written)."""
    elems = workers * rows * CHUNK
    if op == "select":
        return bound(elems * 4 + workers * rows * 8, 2 * elems)[0]
    if op == "ef_update":
        return bound(3 * elems * 4 + rows * 4 + workers * rows * 4, 5 * elems)[0]
    return bound(3 * elems * 4 + workers * rows * 4 + rows * 4 + rows * CHUNK * 4, 7 * elems)[0]


def autotune_holds(tok_winner: dict, results: dict, card_line: str) -> None:
    """``[autotune]`` (b): every block size of each tuned kernel bitwise its
    default size and its plain version at the tok_embed shapes, timed
    (device ms and share of the bound beside the sweep's winner,
    ``tok_winner`` by op, and the default, into ``results``); at small odd
    shapes full of ties, -0, inf and NaN payloads (the fused reduce over 1,
    3 and 8 workers); and, where the card has room, the select and
    ef_update past the 2^20-block grid of the small sizes."""
    import torch

    from repro_torch.kernels import build, chunk_topk as ct, ef_update as efk, fused_reduce as frk

    default, cands = build.DEFAULT_THREADS, build.CANDIDATE_THREADS
    tuned = tuned_wrappers()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(G * R, CHUNK, device="cuda", generator=gen)
    x[::997] = torch.randint(-3, 4, x[::997].shape, device="cuda", generator=gen).float()
    m = torch.randn(G * R, CHUNK, device="cuda", generator=gen)
    g = torch.randn(G * R, CHUNK, device="cuda", generator=gen)
    idx = ct.chunk_argmax_plain(x[:R])[0]
    m3, g3 = m.view(G, R, CHUNK), g.view(G, R, CHUNK)
    calls = {
        "select": (lambda t: ct.chunk_argmax(x, threads=t), lambda: ct.chunk_argmax_plain(x)),
        "ef_update": (lambda t: efk.ef_update(m, g, idx, BETA, threads=t),
                      lambda: efk.ef_update_plain(m, g, idx, BETA)),
        "fused_reduce": (lambda t: frk.fused_reduce(m3, g3, BETA, 1, "clt_k", 3, threads=t),
                         lambda: frk.fused_reduce_plain(m3, g3, BETA, 1, "clt_k", 3)),
    }
    for op, (run, plain) in calls.items():
        b = tuned_bound(op, R, G)
        want, ref = plain(), run(default)
        check(bitwise(ref, want), f"[autotune] {op} at the tok_embed shapes: the default "
                                  f"geometry differs from plain")
        ms = {}
        for t in cands:
            check(bitwise(run(t), ref), f"[autotune] {op} at {t} threads, tok_embed shapes: "
                                        f"differs from the default geometry")
            ms[t] = device_ms(lambda t=t: run(t), (lambda t=t: tuned[op].threads[t], 1),
                              what=f"{op} at {t} threads")
        win = tok_winner[op]
        name = TUNED[op]
        results[name].update(tuned_threads=win, tuned_ms=ms[win], default_threads_ms=ms[default],
                             threads_ms=ms)
        print(f"[autotune] {name} at the tok_embed shapes, every block size bitwise the default "
              f"and plain; device ms " + ", ".join(f"{t}: {v:.4f}" for t, v in ms.items())
              + f"; the sweep's winner {win}: {ms[win]:.4f} ms, {b / ms[win]:.0%} of the bound, "
              f"against the default's {ms[default]:.4f} ms, {b / ms[default]:.0%} (bound {b:.4f} "
              f"ms) on {card_line}")
    del x, m, g, m3, g3, idx, calls

    n = 0
    for rows in AUTOTUNE_ODD_ROWS:
        for chunk in AUTOTUNE_ODD_CHUNKS:
            xs = tied_nan(rows, chunk, gen)
            ms_, gs_ = tied_nan(3 * rows, chunk, gen), tied_nan(3 * rows, chunk, gen)
            ids = torch.randint(0, chunk, (rows,), device="cuda", generator=gen, dtype=torch.int32)
            mg = tied_nan(2 * 8 * rows, chunk, gen).view(2, 8, rows, chunk)
            cases = [("select", lambda t: ct.chunk_argmax(xs, threads=t),
                      ct.chunk_argmax_plain(xs)),
                     ("ef_update", lambda t: efk.ef_update(ms_, gs_, ids, BETA, threads=t),
                      efk.ef_update_plain(ms_, gs_, ids, BETA))]
            for w in (1, 3, 8):
                cases.append(("fused_reduce", lambda t, w=w: frk.fused_reduce(
                    mg[0, :w], mg[1, :w], BETA, 1, "clt_k", w - 1, threads=t),
                    frk.fused_reduce_plain(mg[0, :w].contiguous(), mg[1, :w].contiguous(), BETA,
                                           1, "clt_k", w - 1)))
            for op, run, want in cases:
                for t in cands:
                    before = tuned[op].threads[t]
                    check(bitwise(run(t), want) and tuned[op].threads[t] == before + 1,
                          f"[autotune] {op} at {t} threads, ({rows}, {chunk}): differs from "
                          f"plain, or did not launch at that size")
                    n += 1
    # past the 2^20-block grid a small block size takes at the tok_embed shapes: the
    # select's grid-stride loop at 64 threads (16 rows a block), ef_update's up to 512
    rows = (1 << 20) * 16 + 1001
    free, _ = torch.cuda.mem_get_info()
    if free > 8 * rows * CHUNK * 4:
        xb = torch.randn(rows, CHUNK, device="cuda", generator=gen)
        want = ct.chunk_argmax_plain(xb)
        for t in cands:
            check(bitwise(ct.chunk_argmax(xb, threads=t), want),
                  f"[autotune] chunk_argmax at {t} threads over {rows:,} rows differs from plain")
        gb = torch.randn(rows, CHUNK, device="cuda", generator=gen)
        ib = want[0]
        del want
        want = efk.ef_update_plain(xb, gb, ib, BETA)
        for t in cands:
            check(bitwise(efk.ef_update(xb, gb, ib, BETA, threads=t), want),
                  f"[autotune] ef_update at {t} threads over {rows:,} rows differs from plain")
        n += 2 * len(cands)
        del xb, gb, ib, want
        big = f"and {rows:,} rows (select and ef_update)"
    else:
        big = f"({rows:,} rows not run: {free / 2**30:.1f} GiB free)"
    torch.cuda.synchronize()
    print(f"[autotune] {n} small and large cases, every block size {cands}: rows "
          f"{AUTOTUNE_ODD_ROWS}, chunk {AUTOTUNE_ODD_CHUNKS}, the fused reduce over 1, 3 and 8 "
          f"workers, ties, -0, inf, NaN payloads, {big}: bitwise equal to plain")



def autotune_phase(params, gpw, trained, base_cfg, plans, workers: int, card_line: str,
                   results: dict) -> None:
    """``[autotune]``: the launch-geometry autotuner on the main path at full
    width. The cache was pinned empty at the start of the run, so every
    phase before this one launched the default block size; this one removes
    the cache file when it ends.

    (a) ``autotune_params`` over the paper model's parameters at the run's
    worker count, as ``--autotune`` runs it (every op and launch-rows
    bucket; the only writer of the cache the rest of the phase reads): one
    line per op and bucket with each candidate's device ms, the winner and
    the bound. (b) Every candidate of each tuned kernel
    bitwise its default geometry and its plain version at the tok_embed
    shapes (device ms and share of the bound of each), at small odd row
    counts full of ties, -0, inf and NaN, and at a select / ef_update shape
    past the 2^20-block grid of the small sizes. (c) The compressed step's
    reduce (unfused and fused, from the trained state) with the tuned cache:
    ĝ and every residue bitwise the untuned reduce's, each tuned launch at
    the block size the cache gives its rows, ``count_launches`` 1 fused and 3
    unfused for one tensor, and the ``[path]`` device ms with and without the
    tuned cache. (d) ``python -m repro_torch.launch.train --autotune`` at
    SMOKE width, 3 steps: the cache holds entries keyed by the card's name."""
    import torch

    from repro_torch import kernels, obs
    from repro_torch.backends import autotune as at
    from repro_torch.backends.introspect import count_launches
    from repro_torch.core.scalecom import scalecom_reduce
    from repro_torch.core.state import ScaleComState
    from repro_torch.kernels import build, chunk_topk as ct, ef_update as efk, fused_reduce as frk
    from repro_torch.launch import train as train_cli

    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    cache = at.cache_path()
    check(not os.path.exists(cache), f"[autotune] the pinned cache {cache} exists before the phase")
    default, cands = build.DEFAULT_THREADS, build.CANDIDATE_THREADS
    tuned = tuned_wrappers()
    cfgs = {label: dataclasses.replace(base_cfg, fused=fused, backend="cuda")
            for label, fused in (("unfused", False), ("fused", True))}
    kernels.reset_launches()
    untuned = {label: scalecom_reduce(gpw, trained, c) for label, c in cfgs.items()}
    for op, k in tuned.items():
        check(all(n == 0 for t, n in k.threads.items() if t != default) and k.threads[default] > 0,
              f"[autotune] untuned {op} launches by block size {k.threads}, want {default} only")

    # -- (a) the sweep ---------------------------------------------------------------
    t0 = time.perf_counter()
    timings = {}
    wins = at.autotune_params(params, CHUNK, min_size=base_cfg.min_size, workers=workers,
                              iters=AUTOTUNE_ITERS, timings=timings)
    sweep_s = time.perf_counter() - t0
    check(len(timings) == len(wins), f"[autotune] {len(timings)} sweeps timed, {len(wins)} won")
    check(all(w in cands for w in wins.values()), f"[autotune] winners {wins}")
    tok_winner = {}
    for k, (key, times) in zip(wins, timings.items()):
        op, rows = k.split("|")[0], int(k.split("|n")[1]) // CHUNK  # rows a worker
        check(key == at._key(op, CHUNK, workers * rows, "cuda") and key.startswith(card + "|"),
              f"[autotune] cache key {key} for {op} over {workers} x {rows} rows")
        win = min(times, key=times.get)
        tok = key == at._key(op, CHUNK, G * R, "cuda")  # the bucket of the tok_embed launch
        if tok:
            tok_winner[op] = win
        b = tuned_bound(op, rows, workers)
        print(f"[autotune] {op}{' (tok_embed bucket)' if tok else ''} over {workers} x {rows:,} "
              f"rows (key {key.split('|', 1)[1]}): "
              + ", ".join(f"{t}: {ms:.4f}" for t, ms in times.items())
              + f" device ms; winner {win} ({times[win]:.4f} ms, {b / times[win]:.0%} of the "
              f"bound), default {default} ({times[default]:.4f} ms, {b / times[default]:.0%}); "
              f"bound {b:.4f} ms on {card_line}")
    check(set(tok_winner) == set(TUNED), f"[autotune] no sweep at the tok_embed launch's key: "
                                         f"{sorted(timings)}")
    print(f"[autotune] sweep: {len(wins)} (op, rows) sweeps, {AUTOTUNE_ITERS} queued calls a "
          f"candidate, {sweep_s:.1f} s; winners {sorted(set(wins.values()))}")

    # -- (b) every candidate bitwise, at the tok_embed shapes and small odd ones
    autotune_holds(tok_winner, results, card_line)

    # -- (c) the compressed step's reduce with the tuned cache ---------------------------
    entries = at._load()
    missed = [(op, p.path) for p in plans if not p.dense for op in TUNED
              if at._key(op, CHUNK, p.groups * p.n_chunks, "cuda") not in entries]
    check(not missed, f"[autotune] tuned launches the sweep wrote no entry for: {missed}")
    print(f"[autotune] every tuned launch of the compressed step ({len(TUNED)} ops x "
          f"{sum(not p.dense for p in plans)} tensors) reads an entry the sweep wrote")
    for label, c in cfgs.items():
        kernels.reset_launches()
        out = scalecom_reduce(gpw, trained, c)
        same_reduce(out, untuned[label], f"[autotune] {label} reduce with the tuned cache")
        want = {op: dict.fromkeys(cands, 0) for op in tuned}
        for p in plans:
            if not p.dense:
                for op in (("fused_reduce",) if c.fused else ("select", "ef_update")):
                    want[op][at.best_threads(op, workers * p.n_chunks, CHUNK)] += 1
        ops = ("fused_reduce",) if c.fused else ("select", "ef_update")
        for op in ops:
            check(tuned[op].threads == want[op], f"[autotune] {label} {op} launches by block "
                                                 f"size {tuned[op].threads}, want {want[op]}")
        print(f"[autotune] {label} reduce from the trained state with the tuned cache: ghat and "
              f"residues bitwise the untuned reduce's; launches by block size "
              + "; ".join(f"{TUNED[op]} {dict((t, v) for t, v in want[op].items() if v)}"
                          for op in ops)
              + ", each the cache's size for its rows")
    del out, untuned
    path = "['tok_embed']"
    one = ScaleComState(residues={path: trained.residues[path]}, t=trained.t)
    for label, c in cfgs.items():
        got = count_launches(scalecom_reduce, {"tok_embed": gpw["tok_embed"]}, one, c)
        want = ({"fused_reduce": 1} if c.fused
                else {"chunk_argmax": 1, "ef_update": 1, "chunk_scatter": 1})
        check({k: v for k, v in got.items() if v} == want,
              f"[autotune] count_launches of one tensor's {label} reduce: {got}")
    print("[autotune] count_launches of the tok_embed reduce: 1 launch fused (fused_reduce), 3 "
          "unfused (chunk_argmax, ef_update, chunk_scatter)")
    gen = torch.Generator(device="cuda").manual_seed(8)
    chosen = [p for p in plans if not p.dense]
    tensors = [(torch.randn(workers, p.n_chunks, CHUNK, device="cuda", generator=gen),
                torch.randn(workers, p.n_chunks, CHUNK, device="cuda", generator=gen))
               for p in chosen]

    def size(op, rows, cached):
        return at.best_threads(op, rows, CHUNK) if cached else default

    def unfused_step(cached):
        for mm, gg in tensors:
            rows = mm.shape[0] * mm.shape[1]
            i = ct.chunk_argmax(mm.view(-1, CHUNK),
                                threads=size("select", rows, cached))[0][:mm.shape[1]]
            efk.ef_update(mm.view(-1, CHUNK), gg.view(-1, CHUNK), i, BETA,
                          threads=size("ef_update", rows, cached))

    def fused_step(cached):
        for mm, gg in tensors:
            frk.fused_reduce(mm, gg, BETA, 1, "clt_k", 3,
                             threads=size("fused_reduce", mm.shape[0] * mm.shape[1], cached))

    for label, step, counted in (("chunk_argmax + ef_update", unfused_step, counter("ef_update")),
                                 ("fused_reduce", fused_step, counter("fused_reduce"))):
        with_cache = device_ms(lambda: step(True), (counted, len(chosen)), reps=10,
                               what=f"[autotune] {label} path, tuned")
        without = device_ms(lambda: step(False), (counted, len(chosen)), reps=10,
                            what=f"[autotune] {label} path, default")
        print(f"[path] {label} over the {len(chosen)} tensors one compressed step gives it: "
              f"device ms {with_cache:.4f} per step with the tuned cache, {without:.4f} at the "
              f"default {default} threads on {card_line}")
    del tensors
    for label, c in cfgs.items():
        tuned_ms = device_ms(lambda: scalecom_reduce(gpw, trained, c), reps=2,
                             what=f"{label} reduce, tuned")
        with autotune_cache(cache + ".empty"):
            plain_ms = device_ms(lambda: scalecom_reduce(gpw, trained, c), reps=2,
                                 what=f"{label} reduce, untuned")
        print(f"[path] {label} reduce from the trained state: {tuned_ms:.3f} device ms with the "
              f"tuned cache, {plain_ms:.3f} without on {card_line}")

    # -- (d) the CLI on the card, from an empty cache -----------------------------------------
    os.remove(cache)
    at.clear_cache()
    logger = obs.get_logger()
    handlers, level = list(logger.handlers), logger.level
    t0 = time.perf_counter()
    try:
        history = train_cli.main(["--autotune", "--workers", "8", "--steps", "3",
                                  "--warmup-steps", "1", "--log-every", "1"])
    finally:  # the CLI turns console logging on for the rest of the process
        logger.handlers[:] = handlers
        logger.setLevel(level)
    cli_s = time.perf_counter() - t0
    check(len(history) == 3 and all(math.isfinite(h["loss"]) for h in history),
          f"[autotune] --autotune CLI: history {history}")
    with open(cache) as f:
        entries = json.load(f)
    check(all(k.startswith(card + "|") and v in cands for k, v in entries.items())
          and {k.split("|")[1] for k in entries} == set(tuned),
          f"[autotune] the cache after --autotune: {entries}")
    print(f"[autotune] python -m repro_torch.launch.train --autotune (SMOKE width, 8 workers, 3 "
          f"steps): {cli_s:.1f} s, final loss {history[-1]['loss']:.4f}; the cache holds "
          f"{len(entries)} entries, every one keyed by '{card}': "
          + ", ".join(f"{k.split('|', 1)[1]}={v}" for k, v in sorted(entries.items())))
    os.remove(cache)
    at.clear_cache()
    check(at.best_threads("select", G * R, CHUNK) == default, "[autotune] the cache outlived its phase")
    print(f"[autotune] phase {time.perf_counter() - t_phase:.1f} s; the cache file removed, every "
          f"later phase launches the default {default} threads")


def print_ptxas(log: str) -> None:
    """Registers and spills per kernel from ptxas -v; a kernel template's
    instantiations (the vec4 select and scatter, one per lanes-per-row and
    top-m; the vec4 fused reduce, also per mode and design) summed into one
    line per template, mode and block size. The block size is the last
    template argument of the tuned kernels (``kThreads`` of the vec4 select
    and fused reduce, ``kRows`` warps of ef_update); the default size's lines
    read as they did when it was a constant, a build from before then
    included."""
    import re

    entries, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill" in ln and name:
            spills = sum(int(w) for w in ln.split() if w.isdigit()) - int(ln.split()[0])
            entries.append([name, 0, spills])
        elif "Used" in ln and "registers" in ln and entries and entries[-1][0] == name:
            entries[-1][1] = int(ln.split("Used")[1].split()[0])
            name = None
    default = 256
    modes = {("0", "0"): "clt_k", ("1", "1"): "true_topk staged", ("1", "0"): "true_topk L2 re-read"}
    labels = ["chunk_select_vec4_kernel", "chunk_scatter_vec4_kernel"]
    labels += [f"fused_reduce_vec4_kernel {m}" for m in modes.values()]
    keys = {"0": "m + g", "1": "key"}
    labels += [f"select_update_kernel ({k})" for k in keys.values()]
    groups = {}  # (label, threads) -> [(registers, spills)]
    for n, regs, spills in entries:
        found = re.search(r"kernelI((?:L[ib]\d+E)+)E", n)  # template arguments, mangled
        args = re.findall(r"L[ib](\d+)E", found.group(1)) if found else []
        if "chunk_select_vec4_kernel" in n or "chunk_scatter_vec4_kernel" in n:
            label = labels[0] if "select" in n else labels[1]
            threads = int(args[2]) if len(args) == 3 else default
        elif "fused_reduce_vec4_kernel" in n:
            label = f"fused_reduce_vec4_kernel {modes[args[2], args[3]]}"
            threads = int(args[4]) if len(args) == 5 else default
        elif "select_update_kernel" in n:  # fused_select_update: (L, M, kKey, kThreads)
            label = f"select_update_kernel ({keys[args[2]]})"
            threads = int(args[3])
        else:
            short = next((k for k in KERNELS if f"{k}_kernel" in n), n)
            threads = int(args[0]) * 32 if short == "ef_update" and args else default
            kind = " (scalar)" if short in VARIANTS else ""
            at = f" at {threads} threads" if threads != default else ""
            print(f"[build] {short}{kind}{at}: {regs} registers, {spills} bytes spilled")
            continue
        groups.setdefault((label, threads), []).append((regs, spills))
    for (label, threads), group in sorted(
            groups.items(), key=lambda kv: (labels.index(kv[0][0]), kv[0][1] != default,
                                            kv[0][1])):
        regs = [r for r, _ in group]
        at = f" at {threads} threads" if threads != default else ""
        print(f"[build] {label}{at}, {len(group)} instantiations: {min(regs)}-{max(regs)} "
              f"registers, {sum(s for _, s in group)} bytes spilled")


GRAD_TOL = dict(rtol=1e-5, atol=1e-7)  # one batched pass and the loop order a few sums differently


def grad_errors(a: dict, b: dict, what: str, tol: dict = GRAD_TOL) -> tuple:
    """Hold two {path: (n, *shape)} gradient trees to ``tol``, leaf by leaf
    (``atol_of_max``, if given, adds that share of the leaf's largest |b| to
    ``atol``); returns (the largest max|a-b| / max|b| of any leaf, that leaf)."""
    import torch

    from repro_torch import tree

    worst, worst_path = 0.0, None
    by_path = dict(tree.flatten_with_path(b))
    for path, x in tree.flatten_with_path(a):
        y = by_path[path]
        check(x.shape == y.shape and x.dtype == y.dtype, f"{what}: {path} shape or dtype")
        check(bool(torch.isfinite(x).all()), f"{what}: {path} is not finite")
        rel = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_path = rel, path
        atol = tol["atol"] + tol.get("atol_of_max", 0.0) * float(y.abs().max())
        if not torch.allclose(x, y, rtol=tol["rtol"], atol=atol):
            bad = int((~torch.isclose(x, y, rtol=tol["rtol"], atol=atol)).sum())
            fail(f"{what}: {path} differs beyond rtol {tol['rtol']} / atol {atol:.3e} at "
                 f"{bad} of {x.numel()} elements (max |a-b| {float((x - y).abs().max()):.3e}, "
                 f"max |b| {float(y.abs().max()):.3e})")
    return worst, worst_path


def grads_phase(model, params, batch, workers: int, t_dense, card_line: str, tag: str = "[grads]",
                tol: dict = GRAD_TOL):
    """[grads]: the batched per-worker pass (the main path's) against the
    loop of one autograd pass per worker, from the trained state: every
    gradient to ``tol``, the loss and each aux of the model (``nll``,
    the MoE losses) per worker to rtol 1e-6, the MoE drop shares exactly;
    two calls of the batched pass bit for bit; host ms of both beside
    dense_grads (``t_dense``, None: not timed). At most two gradient sets
    are alive at once. Returns the batched pass's gradients."""
    import torch

    from repro_torch import tree
    from repro_torch.training.train_step import per_worker_grads, per_worker_grads_loop

    (l_loop, a_loop, g_loop), t_loop = host_ms(
        lambda: per_worker_grads_loop(model, params, batch, workers))
    (l_b, a_b, g_b), t_b = host_ms(lambda: per_worker_grads(model, params, batch, workers))
    check(bool(torch.isclose(l_b, l_loop, rtol=1e-6, atol=0)) and list(a_b) == list(a_loop)
          and all(bool(torch.allclose(a_b[k], a_loop[k], rtol=1e-6, atol=0)) for k in a_b)
          and all(torch.equal(a_b[k], a_loop[k]) for k in a_b if k == "moe_dropped_frac"),
          f"{tag} loss {float(l_b)} / aux {dict((k, v.tolist()) for k, v in a_b.items())} "
          f"against the loop's {float(l_loop)} / {dict((k, v.tolist()) for k, v in a_loop.items())}")
    worst, worst_path = grad_errors(g_b, g_loop, f"{tag} batched pass vs loop", tol)
    del g_loop
    (l_b2, _, g_b2), t_b2 = host_ms(lambda: per_worker_grads(model, params, batch, workers))
    differ = [p for (p, x), (_, y) in zip(tree.flatten_with_path(g_b),
                                          tree.flatten_with_path(g_b2)) if not bitwise(x, y)]
    del g_b2
    # tok_embed's gradient accumulates rows by token index (index_put_ with
    # accumulate under vmap's batching rule): the first to differ if any does
    check(not differ and bool(torch.equal(l_b, l_b2)),
          f"{tag} two calls of the batched pass differ in {differ}")
    _, local_b, seq = batch["tokens"].shape
    print(f"{tag} per_worker_grads, one batched pass ({workers} workers x {local_b} x {seq} "
          f"tokens) against per_worker_grads_loop: every gradient within rtol {tol['rtol']} / "
          f"atol {tol['atol']}"
          + (f" + {tol['atol_of_max']} of its leaf's largest" if "atol_of_max" in tol else "")
          + f", largest max|a-b|/max|b| {worst:.3e} ({worst_path}); loss "
          f"{float(l_b):.6f} vs {float(l_loop):.6f}; aux {sorted(a_b)} per worker within rtol 1e-6"
          + (", drop shares equal" if "moe_dropped_frac" in a_b else ""))
    print(f"{tag} two calls of the batched pass: bitwise equal in every gradient, "
          "tok_embed's index-accumulate included")
    print(f"{tag} host ms: batched pass {t_b:.1f} and {t_b2:.1f}, loop {t_loop:.1f}"
          + (f", dense_grads {t_dense:.1f} (the same {workers * local_b} x {seq} tokens folded)"
             if t_dense is not None else "") + f" on {card_line}")
    return g_b


def microbatch_phase(model, opt, sched, sc_cfg, params, batch, batches_fn, plans, workers: int,
                     warmup: int, steps: int, card_line: str) -> dict:
    """[train:microbatches]: one step's per-worker gradients with
    microbatches=2 against one batched pass from the trained state (peak
    memory of each), then a full-width fused run of ``steps`` steps through
    ``build_train_step(microbatches=2)``. Returns the run's launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import fused_reduce as frk
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.training.train_step import per_worker_grads

    grads, peaks = {}, {}
    for M in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (_, _, grads[M]), ms = host_ms(lambda: per_worker_grads(model, params, batch, workers, M))
        peaks[M] = (torch.cuda.max_memory_allocated() - base, ms)
    worst, worst_path = grad_errors(grads[2], grads[1], "[train:microbatches] M=2 vs M=1")
    del grads
    print(f"[train:microbatches] one step's per-worker gradients, microbatches=2 against 1 from "
          f"the trained state: within rtol {GRAD_TOL['rtol']} / atol {GRAD_TOL['atol']}, largest "
          f"max|a-b|/max|b| {worst:.3e} ({worst_path}); peak memory above the state "
          + ", ".join(f"M={M} {peaks[M][0] / 2**30:.2f} GiB ({peaks[M][1]:.1f} ms)" for M in (1, 2))
          + f" on {card_line}")

    state = init_train_state(model, opt, sc_cfg, torch.Generator().manual_seed(0),
                             n_workers=workers, device="cuda")
    dense = build_train_step(model, opt, sched, sc_cfg, n_workers=workers, mode="dense",
                             microbatches=2)
    compressed = build_train_step(model, opt, sched, sc_cfg, n_workers=workers,
                                  mode="scalecom", microbatches=2)
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i, b in zip(range(steps), batches_fn()):
        kind = "compressed" if i >= warmup else "dense"
        (state, metrics), ms = host_ms(lambda: (compressed if i >= warmup else dense)(state, b))
        loss = float(metrics["loss"])
        check(math.isfinite(loss), f"[train:microbatches] non-finite loss at step {i}")
        print(f"[train:microbatches] step {i} {kind}: loss {loss:.4f} gnorm "
              f"{float(metrics['grad_norm']):.4f} {ms:.1f} ms on {card_line}")
    torch.cuda.synchronize()
    got = kernels.launches()
    want = expected_launches(plans, True, steps - warmup)
    check(got == want, f"[train:microbatches] launches {got}, want {want}")
    check(frk.fused_reduce.variants == {"vec4": got["fused_reduce"], "scalar": 0},
          f"[train:microbatches] fused_reduce variants {frk.fused_reduce.variants}")
    print(f"[train:microbatches] launches {got} (want {want}), all fused_reduce launches vec4")
    return got


def telemetry_run_phase(model, opt, sched, sc_cfg, batches_fn, plans, workers: int, warmup: int,
                        steps: int, plain_ms: list, card_line: str) -> dict:
    """[telemetry:run]: a full-width fused run with the recorder
    (``run_training(telemetry=TelemetryRun)``, taps on, metrics_every 1)
    into a temporary directory; its trace, event log and report. Returns the
    run's launches."""
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.obs import TelemetryRun, read_events
    from repro_torch.obs.report import summarize
    from repro_torch.training import TrainLoop, init_train_state, run_training

    cfg_t = dataclasses.replace(sc_cfg, telemetry=True, metrics_every=1)
    state = init_train_state(model, opt, cfg_t, torch.Generator().manual_seed(0),
                             n_workers=workers, device="cuda")
    loop = TrainLoop(model=model, optimizer=opt, schedule=sched, sc_cfg=cfg_t,
                     n_workers=workers, log_every=1)
    with tempfile.TemporaryDirectory() as d:
        run = TelemetryRun(d, backend_name="cuda",
                           extra_provenance={"arch": "paper-transformer-base",
                                             "compressor": "clt_k", "workers": workers})
        torch.cuda.synchronize()
        kernels.reset_launches()
        try:
            state, history = run_training(loop, state, batches_fn(), steps, log=None,
                                          telemetry=run)
        finally:
            paths = run.close()
        torch.cuda.synchronize()
        got = kernels.launches()
        with open(paths["trace"]) as f:
            trace = json.load(f)
        events = read_events(paths["events"])
        summary = summarize(paths["events"])
    types = [e["type"] for e in events]
    step_spans = [e for e in events if e["type"] == "span" and e["name"] == "step"]
    check(types[0] == "provenance" and types[-1] == "summary" and types.count("step") == steps
          and len(step_spans) == steps,
          f"[telemetry:run] event types {types}")
    check(len([e for e in trace["traceEvents"] if e["name"] == "step"]) == steps,
          "[telemetry:run] trace.json has no span per step")
    check(summary["steps"] == steps and not summary["violations"]
          and summary["bytes_plan_mismatches"] == 0,
          f"[telemetry:run] report: {summary['steps']} steps, violations "
          f"{summary['violations']}, {summary['bytes_plan_mismatches']} byte mismatches")
    check(all(math.isfinite(h["loss"]) for h in history), "[telemetry:run] non-finite loss")
    want = expected_launches(plans, True, steps - warmup)
    check(got == want, f"[telemetry:run] launches {got}, want {want}")
    prov = events[0]
    step_ms = [e["dur_us"] / 1e3 for e in step_spans]
    taps = sum(k.startswith("obs/") for k in events[steps]["metrics"])
    print(f"[telemetry:run] {steps} fused steps with the recorder: trace.json loads "
          f"({len(trace['traceEvents'])} spans), events.jsonl holds {len(events)} events "
          f"(provenance, {types.count('step')} steps with {taps} taps at the last, "
          f"{types.count('span')} spans, summary); launches {got}; provenance device_kind "
          f"{prov['device_kind']!r}, card {prov['card_name']!r} at {prov['power_limit']!r}, "
          f"backend {prov['backend']}")
    print(f"[telemetry:run] report: {summary['steps']} steps, compression ratio "
          f"{summary['compression_ratio']['mean']:.1f}x, build-up nnz/k "
          f"{list(summary['buildup_curve'].values())[-1]:.3f}, contraction gamma "
          f"{summary['contraction_gamma_mean']:.4f}, violations none")
    print(f"[telemetry:run] step host ms with the recorder (taps on, metrics_every 1): "
          + " / ".join(f"{ms:.1f}" for ms in step_ms)
          + "; the fused run without it: " + " / ".join(f"{ms:.1f}" for ms in plain_ms)
          + f" on {card_line}")
    return got


def checkpoint_phase(fp32_state, fp8_state, model, opt, sc_cfg, workers: int,
                     card_line: str) -> None:
    """[checkpoint]: save a trained full-width TrainState with
    ``repro_torch.checkpoint``, restore it into a fresh state on the card,
    every leaf bit for bit. The fp32 state is ~2.3 GB, which deflate may take
    minutes to write: a 64 MiB sample of its parameters (random weights, the
    least compressible part) is written first, and where the whole would take
    more than ~30 s at that rate the fp8 run's state goes instead."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import checkpoint
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.training import init_train_state

    def nbytes(state):
        return sum(v.numel() * v.element_size() for _, v in _flatten(state)
                   if isinstance(v, torch.Tensor))

    with tempfile.TemporaryDirectory() as d:
        sample = fp32_state.params["tok_embed"].reshape(-1)[: 16 << 20].cpu().numpy()
        t0 = time.perf_counter()
        np.savez_compressed(os.path.join(d, "sample.npz"), x=sample)
        rate = sample.nbytes / (time.perf_counter() - t0)
        estimate = nbytes(fp32_state) / rate * 1.5  # restore inflates in about half the time
        which, state, codec = ("fp32", fp32_state, "fp32") if estimate <= 30 else (
            "fp8 (the fp32 state would take ~%.0f s at %.0f MB/s)" % (estimate, rate / 1e6),
            fp8_state, "fp8")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(d, int(state.step), state)
        t_save = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        like = init_train_state(model, opt, dataclasses.replace(sc_cfg, residue_dtype=codec),
                                torch.Generator().manual_seed(1), n_workers=workers,
                                device="cuda")
        t0 = time.perf_counter()
        restored = checkpoint.restore(d, like)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    leaves, want = _flatten(restored), _flatten(state)
    check([k for k, _ in leaves] == [k for k, _ in want], "[checkpoint] leaf keys differ")
    for (key, a), (_, b) in zip(leaves, want):
        if isinstance(b, torch.Tensor):
            check(a.is_cuda and bitwise(a, b), f"[checkpoint] {key} differs after restore")
        else:
            check(a == b, f"[checkpoint] {key}: {a} restored, {b} saved")
    print(f"[checkpoint] trained full-width TrainState, {which} residues: {len(leaves)} leaves, "
          f"{nbytes(state):,} bytes in tensors, {file_bytes:,} bytes on disk; save "
          f"{t_save:.1f} s, restore onto the card {t_restore:.1f} s; every leaf bitwise after "
          f"the round trip (sample rate {rate / 1e6:.0f} MB/s) on {card_line}")
    del restored, like


# The harness CLI's sweeps on the card: (label, SCALECOM_TORCH_FUSED set,
# arguments), every scenario, flat and hierarchical, 12 steps, with the
# build-up sweep
HARNESS_SWEEPS = (
    ("clt_k unfused", False, ["--workers", "8,16,32,64"]),
    ("clt_k fused", True, ["--workers", "8,16,32,64"]),
    # true_topk's fused kernel past 12 workers re-reads its rows from L2
    ("true_topk fused", True, ["--compressor", "true_topk", "--workers", "16,64"]),
    ("clt_k top-2", False, ["--topm", "2", "--workers", "8"]),
    ("bf16", False, ["--residue-dtype", "bf16", "--workers", "8,64"]),
    ("fp8", False, ["--residue-dtype", "fp8", "--workers", "8,64"]),
    ("fp8_ec", False, ["--residue-dtype", "fp8_ec", "--workers", "8,64"]),
)
# record fields that must be equal on the card and the CPU
HARNESS_EQUAL = ("nnz", "k", "comm_bytes", "comm_planned", "buildup_ratio", "G", "n_active")
# trajectory distances (relative, O(1e-2)) on the card against the CPU: the
# worker means and norms are summed in other orders, and the fused kernel's
# ĝ holds the plain version's to rtol 1e-6
HARNESS_DIST_ATOL = 1e-6
# with a lossy residue codec: m' is rounded to the codec's grid, and where a
# group's fold (a worker mean, summed in another order on the CPU) moves m'
# by an ulp an element rounds to the neighbouring code, so the distances
# agree to this share of the run's own tolerance: the invariant's verdict
# cannot depend on the device
HARNESS_CODEC_DIST_SHARE = 0.01


class ReduceShadow:
    """Holds every ``scalecom_reduce`` the harness makes on the card against
    the plain PyTorch composition (the torch backend) on the card, from
    clones of the same inputs, as ``main``'s teacher-forced reduces do: the
    step counter and comm bytes equal; unfused, ĝ and every residue tensor
    bitwise; fused, the residues bitwise and ĝ to rtol 1e-6 / atol 1e-7 on
    the same lanes (the worker mean summed in another order), in every
    chunk row but those where the selection differs: none for clt_k, a
    counted few near ties for true_topk (``flips``)."""

    def __init__(self):
        self.reduces = self.bitwise = 0
        self.flips = self.rows = 0  # fused chunk rows selected differently, of all held

    def flip_limit(self) -> int:
        return max(8, self.rows // 10_000)

    @contextlib.contextmanager
    def on(self):
        import torch

        from repro_torch import kernels, tree
        from repro_torch.backends import FUSABLE_MODES, resolve_fused
        from repro_torch.harness import scenarios

        real = scenarios.scalecom_reduce

        def shadowed(grads_pw, state, cfg):
            args = (tree.tree_map(torch.clone, grads_pw),
                    dataclasses.replace(state, residues=tree.tree_map(torch.clone, state.residues)),
                    dataclasses.replace(cfg, backend="torch"))
            out = real(grads_pw, state, cfg)
            before = kernels.launches()
            plain = real(*args)
            check(kernels.launches() == before, "harness: the torch backend launched a kernel")
            comp = cfg.compressor
            self.hold(out, plain, resolve_fused(cfg.fused) and comp.name in FUSABLE_MODES,
                      comp.chunk, comp.name,
                      f"reduce at t={state.t}, {comp.name}, {tree.leaves(grads_pw)[0].shape[0]} "
                      f"workers, groups {cfg.groups}")
            return out

        scenarios.scalecom_reduce = shadowed
        try:
            yield self
        finally:
            scenarios.scalecom_reduce = real

    def hold(self, card, plain, fused: bool, chunk: int, mode: str, what: str) -> None:
        same, flipped, rows = hold_reduce(card, plain, fused, chunk, mode, f"harness {what}")
        self.reduces += 1
        self.bitwise += same
        self.flips += flipped
        self.rows += rows


def hold_reduce(card, plain, fused: bool, chunk: int, mode: str, what: str) -> tuple:
    """One card reduce (ĝ, state, stats) against the plain composition's from
    clones of the same inputs, with ``ReduceShadow``'s rules: the step counter
    and comm bytes equal, the trees alike and on the card; unfused, ĝ and
    every residue tensor bitwise; fused, the residues bitwise and ĝ to rtol
    1e-6 / atol 1e-7 on the same lanes in every chunk row but those selected
    differently (none for clt_k). Returns (bitwise, chunk rows selected
    differently, fused chunk rows held)."""
    import torch

    from repro_torch import tree

    (ghat, state, stats), (w_ghat, w_state, w_stats) = card, plain
    check(state.t == w_state.t, f"{what}: step counter {state.t} != {w_state.t}")
    check(float(stats["comm_bytes_per_worker"]) == float(w_stats["comm_bytes_per_worker"]),
          f"{what}: comm bytes differ from the plain composition's")
    for mine, want, part in ((ghat, w_ghat, "ĝ"), (state.residues, w_state.residues, "residues")):
        check([k for k, _ in tree.flatten_with_path(mine)]
              == [k for k, _ in tree.flatten_with_path(want)],
              f"{what}: the {part} tree differs from the plain composition's")
        for a in tree.leaves(mine):
            check(a.is_cuda, f"{what}: a {part} tensor is on {a.device}")
    res, w_res = state.residues, w_state.residues
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(ghat), tree.leaves(w_ghat)))
    same &= all(torch.equal(a, b) for a, b in zip(tree.leaves(res), tree.leaves(w_res)))
    if same:
        return True, 0, 0
    check(fused, f"{what}: the unfused reduce differs from the plain composition's")
    flipped = rows = 0
    for path, a in tree.flatten_with_path(ghat):
        b = dict(tree.flatten_with_path(w_ghat))[path]
        if path not in res:  # dense
            check(close(a, b), f"{what}: dense ĝ {path} differs beyond rtol 1e-6")
            continue
        check(res[path].keys() == {"q"} and a.dtype == torch.float32,
              f"{what}: a fused reduce with residues {sorted(res[path])}")
        pad = (-a.numel()) % chunk
        ca = torch.nn.functional.pad(a.reshape(-1), (0, pad)).view(-1, chunk)
        cb = torch.nn.functional.pad(b.reshape(-1), (0, pad)).view(-1, chunk)
        qa, qb = res[path]["q"], w_res[path]["q"]
        qa = torch.nn.functional.pad(qa.reshape(qa.shape[0], -1), (0, pad)).view(qa.shape[0], -1, chunk)
        qb = torch.nn.functional.pad(qb.reshape(qb.shape[0], -1), (0, pad)).view(qb.shape[0], -1, chunk)
        same_rows = ((ca != 0) == (cb != 0)).all(-1) & (qa == qb).all(-1).all(0)
        flipped += int((~same_rows).sum())
        rows += same_rows.numel()
        check(close(ca[same_rows], cb[same_rows]),
              f"{what}: ĝ {path} differs beyond rtol 1e-6 on the lanes both selected")
    check(mode == "true_topk" or flipped == 0,
          f"{what}: {flipped} chunk rows select differently from the plain composition")
    return False, flipped, rows


@contextlib.contextmanager
def fused_env(on: bool):
    """``SCALECOM_TORCH_FUSED`` set to 1 (or unset) inside the block, as a user
    would set it around a run; the previous value comes back after."""
    saved = os.environ.pop("SCALECOM_TORCH_FUSED", None)
    if on:
        os.environ["SCALECOM_TORCH_FUSED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("SCALECOM_TORCH_FUSED", None)
        if saved is not None:
            os.environ["SCALECOM_TORCH_FUSED"] = saved


def harness_cli(device: str, fused: bool, args: list, tmp: str) -> tuple:
    """One run of the harness CLI (every scenario, 12 steps, with the build-up
    sweep) on ``device``, from an empty clean-twin cache: (payload, wall s)."""
    from repro_torch.harness import cli, scenarios

    scenarios._CLEAN_CACHE.clear()
    out = os.path.join(tmp, f"scenarios_{device}.json")
    t0 = time.perf_counter()
    with fused_env(fused):
        rc = cli.run_cli(["--device", device, "--scenarios", "all", "--steps", "12",
                          "--out", out, "-q"] + args)
    wall = time.perf_counter() - t0
    with open(out) as f:
        payload = json.load(f)
    check(rc == 0 and payload["passed"],
          f"harness {device} {' '.join(args)}: rc {rc}, violations {payload['violations'][:5]}")
    return payload, wall


def harness_vs_cpu(label: str, card: dict, cpu: dict) -> tuple:
    """The card's harness payload against the CPU's at the same flags: per run
    the re-plans and the records' ``HARNESS_EQUAL`` fields equal, distances
    within ``HARNESS_DIST_ATOL`` (fp32 residues) or
    ``HARNESS_CODEC_DIST_SHARE`` of the run's tolerance (a lossy codec); the
    build-up rows equal. Returns the largest distance difference and its
    largest share of a run's tolerance."""
    worst = share = 0.0
    check(len(card["results"]) == len(cpu["results"]), f"harness {label}: run counts differ")
    for a, b in zip(card["results"], cpu["results"]):
        what = f"harness card vs cpu, {label} {a['name']} n={a['workers']} groups={a['groups']}"
        check((a["name"], a["workers"], a["groups"]) == (b["name"], b["workers"], b["groups"]),
              f"{what}: the CPU ran {b['name']} n={b['workers']} groups={b['groups']}")
        check(a["replans"] == b["replans"], f"{what}: re-plans differ")
        check(len(a["records"]) == len(b["records"]), f"{what}: step counts differ")
        limit = (HARNESS_DIST_ATOL if a["residue_dtype"] == "fp32"
                 else HARNESS_CODEC_DIST_SHARE * a["tolerance"])
        for ra, rb in zip(a["records"], b["records"]):
            check(all(ra[k] == rb[k] for k in HARNESS_EQUAL),
                  f"{what}: step {ra['t']} records differ: card {ra}, cpu {rb}")
            diff = abs(ra["distance"] - rb["distance"])
            check(diff <= limit, f"{what}: step {ra['t']} distance {ra['distance']:.6g} on the "
                                 f"card, {rb['distance']:.6g} on the CPU (limit {limit:.3g})")
            worst = max(worst, diff)
            share = max(share, diff / a["tolerance"])
    check(card["buildup"]["rows"] == cpu["buildup"]["rows"]
          and card["buildup"]["violations"] == cpu["buildup"]["violations"],
          f"harness {label}: build-up rows differ: card {card['buildup']['rows']}, "
          f"cpu {cpu['buildup']['rows']}")
    return worst, share


def harness_phase(card_line: str) -> tuple:
    """``[harness]``: the fault harness on the card. (a) the launch preflight
    at the paper cell's settings (8 workers, clt_k, chunk 64, fp32, every
    scenario), its wall time, then once more with every reduce held against
    the torch backend's (``ReduceShadow``); (b) the harness CLI's sweeps of
    ``HARNESS_SWEEPS`` on the card, each passing every invariant, with every
    reduce held against the torch backend's; (c) each sweep again through
    the CLI on the CPU: records, re-plans and build-up rows equal, distances
    as ``harness_vs_cpu`` says. Returns the kernel launches of the timed
    preflight and the sweeps, counted from 0, and fused_reduce's launches by
    route."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.kernels import fused_reduce as frk
    from repro_torch.launch.train import preflight

    t_phase = time.perf_counter()
    kernels.reset_launches()
    t0 = time.perf_counter()
    preflight("all", 8, "clt_k", 64, None, "fp32", "cuda")
    print(f"[harness] preflight (8 workers, clt_k, chunk 64, fp32, all 5 scenarios x 12 steps): "
          f"{time.perf_counter() - t0:.2f} s wall on {card_line}")
    timed = kernels.launches()
    shadow = ReduceShadow()
    with shadow.on():
        preflight("all", 8, "clt_k", 64, None, "fp32", "cuda")
    print(f"[harness] preflight again, each of its {shadow.reduces} reduces held against the "
          f"torch backend's on the same inputs: {shadow.bitwise} bitwise")
    kernels.reset_launches()  # the held run's launches are a comparison's

    cpu_s, worst_dist = 0.0, 0.0
    routes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fused, args in HARNESS_SWEEPS:
            before, routes_before = kernels.launches(), dict(frk.fused_reduce.routes)
            shadow = ReduceShadow()
            with shadow.on():
                card, wall = harness_cli("cuda", fused, args, tmp)
            check(shadow.flips <= shadow.flip_limit(),
                  f"harness {label}: {shadow.flips} of {shadow.rows} fused chunk rows select "
                  f"differently from the plain composition (limit {shadow.flip_limit()})")
            ran = {k: n - before[k] for k, n in kernels.launches().items() if n > before[k]}
            routes[label] = {k: n - routes_before[k] for k, n in frk.fused_reduce.routes.items()}
            before = kernels.launches()
            cpu, cpu_wall = harness_cli("cpu", fused, args, tmp)
            check(kernels.launches() == before, f"harness {label}: a CPU run launched a kernel")
            cpu_s += cpu_wall
            dist, share = harness_vs_cpu(label, card, cpu)
            worst_dist = max(worst_dist, dist)
            res = card["results"]
            worst = max(r["final_distance"] / r["tolerance"] for r in res)
            replans = sum(len(r["replans"]) for r in res)
            curve = " ".join(f"n={int(r['workers'])}: clt_k {r['clt_k']:.3f} local_topk "
                             f"{r['local_topk']:.3f} (model {r['local_topk_model']:.3f})"
                             for r in card["buildup"]["rows"])
            print(f"[harness] {label} ({' '.join(args)}): {len(res)} runs, every invariant held; "
                  f"largest distance/tolerance {worst:.3f}; {replans} re-plans; build-up "
                  f"{curve}; launches {ran}, fused_reduce by route {routes[label]}; "
                  f"{wall:.2f} s wall on {card_line} with each of {shadow.reduces} reduces held "
                  f"against the torch backend's ({shadow.bitwise} bitwise; fused: {shadow.flips} "
                  f"of {shadow.rows} chunk rows selected differently, limit "
                  f"{shadow.flip_limit() if shadow.rows else 0}); again on the CPU in "
                  f"{cpu_wall:.2f} s: records, re-plans and build-up rows equal, distances within "
                  f"{dist:.3g} ({share:.2g} of a run's tolerance)")
    swept = kernels.launches()
    got = {k: n + timed[k] for k, n in swept.items()}
    missing = [k for k, n in got.items() if n == 0 and k not in ("chunk_gather",) + RING_ONLY]
    check(not missing, f"harness: {missing} never launched")
    harness_routes = {k: sum(r[k] for r in routes.values()) for k in frk.ROUTES}
    check(frk.fused_reduce.variants["scalar"] == 0
          and sum(harness_routes.values()) == swept["fused_reduce"],
          f"harness: fused_reduce ran {frk.fused_reduce.variants} in {swept['fused_reduce']} "
          f"launches, routes {routes}")
    tt = routes["true_topk fused"]
    check(tt["staged"] > 0 and tt["l2_reread"] > 0,
          f"harness: the true_topk sweep's fused launches took the routes {tt}, want both the "
          f"staged one (G <= 12) and the L2 re-read (G > 12)")
    check(routes["clt_k fused"]["staged"] == routes["clt_k fused"]["l2_reread"] == 0,
          f"harness: clt_k fused launches took the routes {routes['clt_k fused']}")
    print(f"[harness] launches in the timed preflight and the sweeps: {got}; fused_reduce "
          f"variants {frk.fused_reduce.variants}, routes {harness_routes} (true_topk sweep: "
          f"{tt['staged']} staged, {tt['l2_reread']} L2 re-read)")
    print(f"[harness] card vs cpu: every sweep again on the CPU ({cpu_s:.2f} s wall), "
          f"distances within {worst_dist:.3g} (limit {HARNESS_DIST_ATOL} with fp32 residues, "
          f"{HARNESS_CODEC_DIST_SHARE} of a run's tolerance with a lossy codec)")
    print(f"[harness] phase {time.perf_counter() - t_phase:.2f} s wall on {card_line}")
    return got, harness_routes


def expected_launches(plans, fused: bool, steps: int) -> dict:
    """Kernel launches the reduce plan implies for ``steps`` reduces on the cuda backend."""
    from repro_torch.backends import FUSABLE_MODES
    from repro_torch.kernels import launches

    want = dict.fromkeys(launches(), 0)
    for p in plans:
        if p.dense or p.comp.exact:
            continue
        if fused and p.comp.name in FUSABLE_MODES:
            want["fused_reduce"] += steps
            continue
        if p.comp.name != "random_k":
            want["chunk_argmax" if p.comp.topm == 1 else "chunk_topm"] += steps
        want["ef_update"] += steps
        want["chunk_scatter"] += steps
    return want


@dataclasses.dataclass(frozen=True)
class ArchRun:
    """One [arch] run: an id of the registry at full width, its depth cut to
    fit one card (``cut``: the config fields replaced), trained once per
    fused setting of ``fused_runs`` on ``local_batch`` x ``seq`` tokens a
    worker (and the model's stub inputs); from the trained state one reduce
    held per fused setting of ``holds``; with ``grads`` the batched
    per-worker pass held against the loop."""

    name: str
    cut: dict
    workers: int
    fused_runs: tuple
    holds: tuple = (True, False)
    grads: bool = False
    grad_tol: dict = dataclasses.field(default_factory=lambda: GRAD_TOL)
    local_batch: int = 4
    seq: int = 128
    before: str = ""  # the peak of the un-rematerialised port at its cut, for comparison


# The [arch] phase: the registry's model families at full width, each cut in
# depth to the deepest that trains on one card with remat (Model.remat, the
# reference's memory strategy) after the main path's phases, which leave
# 2.50 GiB allocated. With remat a pass keeps each layer's inputs and one
# layer's recompute, so the state sets most cuts: parameters, momentum, the
# workers' gradients and residues, and the reduce's new residues beside the
# old, ~28 copies of the parameters at 8 workers and ~9 at 2. starcoder2-3b
# at 3 layers is 703,091,712 parameters (2.62 GiB a copy): the unfused run
# peaks at 75.4 GiB in the reduce, with or without remat; a 4th layer (0.50
# GiB a copy more) ran out of memory. phi3.5-moe at 1 layer is 1,562,980,352
# (5.82 GiB a copy) at 2 workers; a 2nd layer (10.67 GiB a copy) ran out.
# rwkv6-3b at 4 layers is 684,321,280 (8 workers: 2.55 GiB a copy), peaking
# at 74.1 GiB unfused; at 5 it ran out: state, not its time loop's per-step
# states, which remat keeps for one layer at a time; it also trains
# unfused, so that the three unfused kernels meet its 64-wide adapters.
# recurrentgemma-2b at 10 layers (3 rec, rec, attn units and one un-stacked
# tail rec) is 2,173,335,040 (8.10 GiB a copy) at 2 workers of 1 x 2304
# positions, past its 2048-position window: 72.9 GiB alone. whisper-medium
# at 20 + 20 layers (694,020,096, 2.59 GiB a copy) keeps its 1500 frames at
# 8 workers x 4: 70.1 GiB alone; full depth, 24 + 24, ran out (without
# remat 3 + 3 ran out). internvl2-26b at 2 layers is 1,917,462,528 at 2
# workers of 256 vision + 128 text positions. The next cut of these three
# trained alone (tools/arch_cuts.py) at 76.0, 76.0 and 77.6 GiB: with the
# 2.50 GiB the main path leaves, 78.5, 78.5 and 80.1 of the card's 79.18.
ARCH_RUNS = (
    ArchRun("starcoder2-3b", dict(n_layers=3), 8, (False, True),
            before="64.42 GiB unfused, 59.85 GiB fused at 2 layers"),
    ArchRun("phi3.5-moe-42b-a6.6b", dict(n_layers=1), 2, (True,), grads=True,
            before="54.93 GiB at 1 layer"),
    # RWKV's per-head group norm divides by sqrt(mean(y^2) + 1e-6): where a
    # head's y_t nearly cancels (r_1·k_0 of 64 terms of ~1 summing to ~1e-4;
    # y_0 = 0 from the bonus's zero init) it multiplies the gradient by up
    # to 1000 and the rounding of the two passes' GEMMs by as much, and those
    # few head-tokens set every time-mix leaf's largest gradient. On the card
    # the batched pass and the loop stood up to 5.4e-3 of a leaf's largest
    # value apart from the trained state, 1.3e-2 from the initial one (CPU,
    # d 1024: 2.7e-5; ROADMAP Queue 3). A batching fault would be O(1).
    ArchRun("rwkv6-3b", dict(n_layers=4), 8, (False, True), grads=True,
            grad_tol=dict(rtol=1e-5, atol=1e-7, atol_of_max=2e-2),
            before="62.02 GiB at 2 layers"),
    ArchRun("recurrentgemma-2b", dict(n_layers=10), 2, (True,), holds=(True,), local_batch=1,
            seq=2304, before="75.25 GiB at 4 layers"),
    ArchRun("whisper-medium", dict(n_layers=20, encoder_layers=20), 8, (True,), holds=(True,),
            before="66.73 GiB at 2 + 2 layers"),
    ArchRun("internvl2-26b", dict(n_layers=2), 2, (True,), holds=(True,),
            before="53.86 GiB at 1 layer"),
)
# every training run: dense warm-up steps, then compressed ones up to STEPS
WARMUP, STEPS = 2, 5
# the kernels a CLT-k reduce launches, unfused and fused: the arch path's
ARCH_KERNELS = ("chunk_argmax", "chunk_scatter", "ef_update", "fused_reduce")


def observed(opt, paths):
    """``opt`` with the ĝ of each update counted first: per call one device
    tensor of nnz(ĝ) per tensor of ``paths`` (the compressed ones), appended
    to the returned list. The update itself is ``opt``'s."""
    import torch

    from repro_torch import tree
    from repro_torch.optim.optimizer import Optimizer

    counts = []

    def update(grads, state, params, lr):
        flat = dict(tree.flatten_with_path(grads))
        counts.append(torch.stack([torch.count_nonzero(flat[p]) for p in paths]))
        return opt.update(grads, state, params, lr)

    return Optimizer(opt.init, update), counts


def leaf_trees(t, keys: tuple = ()) -> list:
    """[(keystr path, a nested dict holding that one leaf)] of tree ``t``.
    (A module-level recursion: a recursive closure would be a reference
    cycle keeping every leaf alive until the garbage collector runs.)"""
    from repro_torch import tree

    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaf_trees(t[k], keys + (k,))]
    for k in reversed(keys):
        t = {k: t}
    return [(tree.keystr(keys), t)]


@dataclasses.dataclass
class TrainRun:
    state: object
    loop: object
    batches: object  # the batch iterator, past the run's steps
    plans: tuple
    launches: dict
    step_ms: list
    nnz: object  # (steps, compressed tensors) nnz(ĝ) as the optimizer received ĝ, on the host


def train_run(cfg, model, opt, sched, sc_cfg, workers: int, steps: int, label: str,
              card_line: str, prefix: str, local_batch: int = 4, seq: int = 128,
              generator=None) -> TrainRun:
    """``run_training`` of ``model`` from random weights (``generator``,
    default a CPU one seeded 0) on synthetic Markov tokens (seed 0,
    ``local_batch`` x ``seq`` a worker, and the model's stub vision or frame
    embeddings) for ``steps`` steps, the first
    ``sc_cfg.warmup_steps`` dense. Its launches are counted from 0 and held
    to the plan, every select, scatter and fused launch vec4; every
    compressed step passes the harness's comm-bytes and build-up invariants
    (nnz(ĝ) counted as the optimizer receives ĝ) with a finite loss. Prints
    a line per step, each beginning with ``prefix``."""
    import torch

    from repro_torch import kernels, tree
    from repro_torch.core.plan import plan_tensors
    from repro_torch.core.state import residue_signature
    from repro_torch.data import make_batches, model_inputs
    from repro_torch.harness.invariants import check_buildup, check_comm_accounting
    from repro_torch.kernels import build, chunk_topk as ct, ef_update as efk, fused_reduce as frk
    from repro_torch.training import TrainLoop, init_train_state, run_training

    t0 = time.perf_counter()
    # held in a list that run_training empties: a name bound to the first
    # state would keep its zero residues (17 GiB at starcoder2's 8 workers)
    # alive through the run
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    first = [init_train_state(model, opt, sc_cfg, generator, n_workers=workers, device="cuda")]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    plans = plan_tensors(
        tuple((p, tuple(v.shape), workers) for p, v in tree.flatten_with_path(first[0].params)),
        sc_cfg, residue_signature(first[0].sc_state.residues))
    compressed = [p for p in plans if not p.dense]
    print(f"{prefix} {cfg.name}: {cfg.param_count():,} parameters, {len(compressed)} of "
          f"{len(plans)} tensors compressed; init {t_init:.1f} s")
    watched, counts = observed(opt, [p.path for p in compressed])
    loop = TrainLoop(model=model, optimizer=watched, schedule=sched, sc_cfg=sc_cfg,
                     n_workers=workers, log_every=1)
    batches = make_batches(cfg.vocab, workers, local_batch, seq, seed=0, **model_inputs(cfg))
    torch.cuda.synchronize()
    kernels.reset_launches()
    state, history = run_training(loop, first.pop(), batches, steps, log=None)
    torch.cuda.synchronize()
    got = kernels.launches()
    nnz = torch.stack(counts).cpu()
    k_total = sum(p.k for p in compressed)
    planned = sum(p.bytes_payload for p in plans)
    n_compressed_steps = steps - sc_cfg.warmup_steps
    per_step = [history[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                         for a, b in zip(history, history[1:])]
    ratios = []
    for h, dt in zip(history, per_step):
        i = h["step"]
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"{label}: non-finite loss or grad norm at step {i}")
        kind = "compressed" if loop.compressed_at(i) else "dense"
        line = (f"{prefix} step {i} {kind}: loss {h['loss']:.4f} nll {h['nll']:.4f} gnorm "
                f"{h['grad_norm']:.4f} lr {h['lr']:.3f} {dt * 1e3:.1f} ms")
        if "moe_dropped_frac" in h:
            line += (f"; moe_dropped_frac {h['moe_dropped_frac']:.6f} moe_lb_loss "
                     f"{h['moe_lb_loss']:.6f} moe_z_loss {h['moe_z_loss']:.4f}")
        if kind == "compressed":
            v = check_comm_accounting(h["comm_bytes_per_worker"], planned)
            check(v is None, f"{label}: step {i}: {v}")
            ratios.append(int(nnz[i].sum()) / k_total)
            v = check_buildup(ratios[-1], sc_cfg.compressor.name, workers, sc_cfg.compressor.chunk)
            check(v is None, f"{label}: step {i}: {v}")
            line += f"; nnz(ĝ)/k {ratios[-1]:.6f}"
        print(f"{line} on {card_line}")
    print(f"[harness:full-width] {label}: comm_bytes_per_worker == core.plan's {planned:,.1f} B "
          f"and nnz(ĝ)/k (" + " / ".join(f"{r:.6f}" for r in ratios) + ") within check_buildup "
          f"on all {n_compressed_steps} compressed steps")
    want = expected_launches(plans, sc_cfg.fused, n_compressed_steps)
    print(f"{prefix} launches {got} (want {want}: {len(compressed)} tensors x "
          f"{n_compressed_steps} compressed steps)")
    check(got == want, f"{label}: launches {got}, want {want}")
    for wrapper in (ct.chunk_argmax, ct.chunk_scatter, frk.fused_reduce):
        check(wrapper.variants == {"vec4": got[wrapper.__name__], "scalar": 0},
              f"{label}: {wrapper.__name__} variants {wrapper.variants}, want vec4 only")
    # the autotuner's cache is empty outside [autotune]: the default block size
    for wrapper in (ct.chunk_argmax, efk.ef_update, frk.fused_reduce):
        check(wrapper.threads[build.DEFAULT_THREADS] == sum(wrapper.threads.values()),
              f"{label}: {wrapper.__name__} launches by block size {wrapper.threads}")
    print(f"{prefix} every chunk_argmax, chunk_scatter and fused_reduce launch ran the vec4 "
          f"variant ({got['chunk_argmax']}, {got['chunk_scatter']} and {got['fused_reduce']}), "
          f"every tuned launch the default {build.DEFAULT_THREADS} threads")
    return TrainRun(state, loop, batches, plans, got, [dt * 1e3 for dt in per_step], nnz)


def reduce_bound(plans, workers: int) -> tuple:
    """(bound ms, bytes) of one reduce: each worker's m and g read once and
    m' and ĝ written once for a compressed tensor, the gradients read and
    the mean written for a dense one."""
    nbytes = 0
    for p in plans:
        n = math.prod(p.shape)
        nbytes += 4 * ((workers + 1) * n if p.dense else (3 * workers + 1) * n)
    return bound(nbytes, 0)[0], nbytes


def arch_hold(label: str, gpw, sc_state, sc_cfg, plans, fused: bool, workers: int,
              card_line: str, tag: str = "[arch]") -> dict:
    """A teacher-forced reduce on the card from the trained state (cuda
    backend, ``fused`` or not), timed, and held tensor by tensor against the
    torch backend's composition from the same inputs (``hold_reduce``; one
    tensor's composition alive at a time); the comm bytes of the whole equal
    the tensors' sum and nnz(ĝ)/k passes ``check_buildup``. The card's new
    residues are parked in host memory meanwhile. Returns {path: nnz(ĝ)/k}
    of the compressed tensors."""
    import torch

    from repro_torch import tree
    from repro_torch.core.scalecom import scalecom_reduce
    from repro_torch.core.state import ScaleComState
    from repro_torch.harness.invariants import check_buildup

    cfg_c = dataclasses.replace(sc_cfg, fused=fused, backend="cuda")
    cfg_t = dataclasses.replace(cfg_c, backend="torch")
    n_compressed = sum(not p.dense for p in plans)
    torch.cuda.reset_peak_memory_stats()
    dev_ms = device_ms(lambda: scalecom_reduce(gpw, sc_state, cfg_c),
                       (counter("fused_reduce" if fused else "ef_update"), n_compressed),
                       reps=5, warmup=1, what=f"[arch] {label} reduce")
    (ghat, new_state, stats), ms = host_ms(lambda: scalecom_reduce(gpw, sc_state, cfg_c))
    # the card's new residues wait in host memory while the compositions run
    # (starcoder2's are 17 GiB), and come back one tensor at a time
    parked = {p: {k: v.cpu() for k, v in enc.items()} for p, enc in new_state.residues.items()}
    t_new, gpw_device = new_state.t, tree.leaves(ghat)[0].device
    del new_state
    bound_ms, nbytes = reduce_bound(plans, workers)
    by_plan = {p.path: p for p in plans}
    card_ghat = dict(tree.flatten_with_path(ghat))
    bitwise_n = flipped = rows = 0
    comm = 0.0
    ratios = {}
    for path, one in leaf_trees(gpw):
        res = {path: sc_state.residues[path]} if path in sc_state.residues else {}
        plain = scalecom_reduce(one, ScaleComState(residues=res, t=sc_state.t), cfg_t)
        comm += plain[2]["comm_bytes_per_worker"]
        card = (tree.unflatten(one, [card_ghat[path]]),
                ScaleComState(residues={p: {k: v.to(gpw_device) for k, v in parked.pop(p).items()}
                                        for p in res}, t=t_new),
                {"comm_bytes_per_worker": by_plan[path].bytes_payload})
        same, f, r = hold_reduce(card, plain, fused, CHUNK, "clt_k", f"[arch] {label} {path}")
        bitwise_n, flipped, rows = bitwise_n + same, flipped + f, rows + r
        if not by_plan[path].dense:
            ratios[path] = int(torch.count_nonzero(card_ghat[path])) / by_plan[path].k
        del plain, card
    check(comm == stats["comm_bytes_per_worker"],
          f"[arch] {label}: comm bytes {stats['comm_bytes_per_worker']} against the tensors' "
          f"{comm}")
    nnz = sum(r * by_plan[p].k for p, r in ratios.items())
    k = sum(by_plan[p].k for p in ratios)
    v = check_buildup(nnz / k, "clt_k", workers, CHUNK)
    check(v is None, f"[arch] {label} reduce from the trained state: {v}")
    print(f"{tag} {label} reduce from the trained state, cuda backend: {dev_ms:.2f} device ms "
          f"(5 calls back to back), {ms:.2f} ms host clock (the held call), against a bound of "
          f"{bound_ms:.2f} ms ({nbytes / 1e9:.2f} GB over {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"{bound_ms / dev_ms:.0%} of it; held tensor by tensor against the torch "
          f"backend's composition: {bitwise_n} of {len(by_plan)} bitwise"
          + (f", the rest residues bitwise and ĝ within rtol 1e-6, {flipped} of {rows} chunk "
             f"rows selected differently" if bitwise_n < len(by_plan) else "")
          + f"; comm bytes {comm:,.1f} B; nnz(ĝ)/k {nnz / k:.6f}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card_line}")
    del ghat, card_ghat
    return ratios


def describe(cfg) -> str:
    """The shape of ``cfg`` that an [arch] line states, by family."""
    if cfg.arch_type == "ssm":
        return (f"d {cfg.d_model}, {cfg.d_model // cfg.ssm_head_dim} heads of "
                f"{cfg.ssm_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.norm}")
    text = (f"d {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, hd {cfg.hd}, "
            f"d_ff {cfg.d_ff}")
    if cfg.n_experts:
        text += (f", {cfg.n_experts} experts top-{cfg.moe_topk} capacity factor "
                 f"{cfg.capacity_factor}")
    if cfg.arch_type == "hybrid":
        text += (f", layers {'/'.join(cfg._layer_kinds())} (pattern "
                 f"{'/'.join(cfg.hybrid_pattern)}), local window {cfg.local_window}, conv "
                 f"{cfg.conv_width}")
    if cfg.is_encdec:
        text += f", {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} stub frames"
    if cfg.arch_type == "vlm":
        text += f", {cfg.vision_tokens} stub vision tokens"
    return text + f", vocab {cfg.vocab}, {cfg.norm}"


def arch_phase(card_line: str) -> dict:
    """[arch]: the archs of ``ARCH_RUNS`` at full width, depth cut, trained
    by ``train_run`` (once per fused setting, the main path's settings;
    initial weights drawn on the card), then from the last run's trained
    state the reduces of ``holds`` held against the torch backend's
    composition (``arch_hold``); with ``grads`` also the batched per-worker
    pass against the loop (``grads_phase``, the residues parked in host
    memory meanwhile), and for an MoE arch nnz(ĝ)/k of the expert tensors.
    Returns the training runs' kernel launches, summed, and each run's peak
    allocated bytes by label."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.scalecom import ScaleComConfig
    from repro_torch.core.state import ScaleComState
    from repro_torch.data import make_batches, model_inputs
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule
    from repro_torch.training.train_step import per_worker_grads

    t_phase = time.perf_counter()
    launched = dict.fromkeys(KERNELS, 0)
    peaks = {}
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(0.05), WARMUP)
    base_cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                              min_size=1024, warmup_steps=WARMUP)
    for spec in ARCH_RUNS:
        name, workers = spec.name, spec.workers
        full = registry.arch(name)
        cfg = dataclasses.replace(full, **spec.cut)
        model = build_model(cfg, compute_dtype="float32", loss_chunk=64)
        kept = " + ".join(f"{getattr(cfg, k)} of {getattr(full, k)}" for k in spec.cut)
        print(f"[arch] {name}: {kept} layers ({describe(cfg)}); {workers} workers x "
              f"{spec.local_batch} x {spec.seq} tokens, CLT-k chunk {CHUNK} top-1, beta {BETA}, "
              f"fp32 residues")
        print(f"[arch] {name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before "
              f"the run")
        run = None
        for fused in spec.fused_runs:
            del run
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            label = f"{name} {'fused' if fused else 'unfused'}"
            run = train_run(cfg, model, opt, sched, dataclasses.replace(base_cfg, fused=fused),
                            workers, STEPS, label, card_line, f"[arch] {label}",
                            spec.local_batch, spec.seq,
                            torch.Generator(device="cuda").manual_seed(0))
            peaks[label] = torch.cuda.max_memory_allocated()
            print(f"[arch] {label}: peak allocated {peaks[label] / 2**30:.2f} "
                  f"GiB (without remat: {spec.before}) on {card_line}")
            launched = {k: n + run.launches[k] for k, n in launched.items()}
            compressed = [p for p in run.plans if not p.dense]
            for i, p in enumerate(compressed):
                if "expert_" in p.path:
                    print(f"[arch] {label} {p.path}: nnz(ĝ)/k per compressed step "
                          + " / ".join(f"{int(run.nnz[s][i]) / p.k:.6f}"
                                       for s in range(WARMUP, STEPS)))
        params, sc_state, plans = run.state.params, run.state.sc_state, run.plans
        del run  # the momentum
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(make_batches(
            cfg.vocab, workers, spec.local_batch, spec.seq, seed=1, **model_inputs(cfg))).items()}
        if spec.grads:
            # the residues wait in host memory while two gradient sets and
            # the batched pass's saved activations are alive
            parked = {p: {k: v.cpu() for k, v in enc.items()}
                      for p, enc in sc_state.residues.items()}
            t = sc_state.t
            del sc_state
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gpw = grads_phase(model, params, batch, workers, None, card_line,
                              tag=f"[arch] {name} [grads]", tol=spec.grad_tol)
            print(f"[arch] {name} [grads] peak allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (residues parked) on "
                  f"{card_line}")
            sc_state = ScaleComState(residues={p: {k: v.cuda() for k, v in enc.items()}
                                               for p, enc in parked.items()}, t=t)
            del parked
        else:
            (_, _, gpw), t_pw = host_ms(lambda: per_worker_grads(model, params, batch, workers))
            print(f"[arch] {name} per_worker_grads from the trained state: {t_pw:.1f} ms host "
                  f"clock on {card_line}")
        del params, batch
        torch.cuda.empty_cache()
        for fused in spec.holds:
            ratios = arch_hold(f"{name} {'fused' if fused else 'unfused'}", gpw, sc_state,
                               base_cfg, plans, fused, workers, card_line)
            if fused and cfg.n_experts:
                print(f"[arch] {name} fused reduce from the trained state, expert tensors: "
                      + "; ".join(f"{p} nnz(ĝ)/k {r:.6f}" for p, r in ratios.items()
                                  if "expert_" in p or "router" in p))
        del gpw, sc_state
        torch.cuda.empty_cache()
    missing = [k for k in ARCH_KERNELS if launched[k] == 0]
    check(not missing, f"[arch] {missing} never launched on the arch path")
    print(f"[arch] launches of the training runs: {launched}; phase "
          f"{time.perf_counter() - t_phase:.1f} s wall on {card_line}")
    return launched, peaks


@dataclasses.dataclass(frozen=True)
class RematRun:
    """One [remat] A/B: an id of the registry at full width, depth cut
    (``cut``), its batched per-worker pass with ``remat=False`` and with
    ``remat=True`` on the same weights and batch; with ``max_share`` the
    rematerialised peak may be at most that share of the other."""

    name: str
    cut: dict
    workers: int
    local_batch: int = 4
    seq: int = 128
    max_share: float = 1.0


# The [remat] phase: the two archs whose activations, not their state, set
# the depth of their [arch] run: whisper-medium's encoder keeps a (16, 1500,
# 1500) softmax a layer and sequence, recurrentgemma-2b's cross-entropy
# (vocab 256,000) keeps 2 x 2304 x 256,000 fp32 logits without remat.
REMAT_RUNS = (
    RematRun("whisper-medium", dict(n_layers=2, encoder_layers=2), 8, max_share=0.5),
    RematRun("recurrentgemma-2b", dict(n_layers=4), 2, local_batch=1, seq=2304),
)


def remat_phase(card_line: str) -> None:
    """[remat]: for each of ``REMAT_RUNS``, ``per_worker_grads`` without and
    with remat from one set of weights (drawn on the card) and one batch:
    peak allocated memory of each pass (the other's gradients parked in
    host memory, so both start from the same allocation), host ms of a
    second call, and the two gradient sets, losses and aux held to
    ``GRAD_TOL`` (the same ops on the same inputs: zero is expected)."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data import make_batches, model_inputs
    from repro_torch.models import build_model
    from repro_torch.training.train_step import per_worker_grads

    for spec in REMAT_RUNS:
        full = registry.arch(spec.name)
        cfg = dataclasses.replace(full, **spec.cut)
        kept = " + ".join(f"{getattr(cfg, k)} of {getattr(full, k)}" for k in spec.cut)
        params = build_model(cfg, compute_dtype="float32").init(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(make_batches(
            cfg.vocab, spec.workers, spec.local_batch, spec.seq, seed=1,
            **model_inputs(cfg))).items()}
        out, peak, ms = {}, {}, {}
        for remat in (False, True):
            model = build_model(cfg, compute_dtype="float32", loss_chunk=64, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, aux, grads = per_worker_grads(model, params, batch, spec.workers)
            torch.cuda.synchronize()
            peak[remat] = (base, torch.cuda.max_memory_allocated())
            # the second call's gradients are dropped at once: kept, they would
            # sit under the next pass's peak
            ms[remat] = host_ms(lambda: per_worker_grads(model, params, batch, spec.workers))[1]
            if not remat:  # parked: the next pass starts from the same allocation
                grads = tree.tree_map(lambda g: g.cpu(), grads)
            out[remat] = (loss, aux, grads)
            del loss, aux, grads
        (l0, a0, g0), (l1, a1, g1) = out[False], out[True]
        g0 = tree.tree_map(lambda g: g.cuda(), g0)
        worst, worst_path = grad_errors(g1, g0, f"[remat] {spec.name} remat vs no remat")
        same = all(bitwise(x, y) for x, y in zip(tree.leaves(g1), tree.leaves(g0)))
        check(bool(torch.isclose(l1, l0, rtol=GRAD_TOL["rtol"], atol=0)) and sorted(a1) ==
              sorted(a0) and all(bool(torch.allclose(a1[k], a0[k], rtol=GRAD_TOL["rtol"], atol=0))
                                 for k in a0),
              f"[remat] {spec.name}: loss {float(l1)} / aux {sorted(a1)} against {float(l0)} / "
              f"{sorted(a0)} without remat")
        share = (peak[True][1] - peak[True][0]) / (peak[False][1] - peak[False][0])
        print(f"[remat] {spec.name}: {kept} layers, {spec.workers} workers x {spec.local_batch} "
              f"x {spec.seq} tokens ({describe(cfg)}); per_worker_grads without remat: peak "
              f"{peak[False][1] / 2**30:.2f} GiB, {ms[False]:.1f} ms host; with remat: peak "
              f"{peak[True][1] / 2**30:.2f} GiB, {ms[True]:.1f} ms host ({peak[False][0] / 2**30:.2f} "
              f"and {peak[True][0] / 2**30:.2f} GiB allocated before the passes; the pass's own "
              f"growth with remat {share:.3f} of the one without) on {card_line}")
        print(f"[remat] {spec.name}: gradients with remat against without: "
              + ("bitwise equal" if same else
                 f"within rtol {GRAD_TOL['rtol']} / atol {GRAD_TOL['atol']}")
              + f", largest max|a-b|/max|b| {worst:.3e} ({worst_path}); loss {float(l1):.6f} vs "
              f"{float(l0):.6f}")
        check(peak[True][1] < peak[False][1] and
              peak[True][1] <= spec.max_share * peak[False][1],
              f"[remat] {spec.name}: peak {peak[True][1] / 2**30:.2f} GiB with remat, "
              f"{peak[False][1] / 2**30:.2f} without (at most {spec.max_share} of it)")
        del params, batch, out, g0, g1, a0, a1, l0, l1
        torch.cuda.empty_cache()


@dataclasses.dataclass(frozen=True)
class ServeRun:
    """One [serve] run: an id of the registry at full width, its depth cut
    only where one card cannot hold its weights (``cut``, with ``why``),
    serving ``batch`` prompts of ``prompt`` tokens and ``gen`` greedy tokens
    with parameters and compute in ``dtype``. An fp32 run is held against
    the CPU at the depth ``cpu_cut``. A bf16 run's prefill/decode
    consistency is held at ``rel_tol``; ``sweep`` lists the depths at
    which its consistency and bf16 gap are printed."""

    name: str
    cpu_cut: dict = dataclasses.field(default_factory=dict)
    cut: dict = dataclasses.field(default_factory=dict)
    why: str = ""
    prompt: int = 64
    batch: int = 4
    gen: int = 32
    dtype: str = "float32"
    rel_tol: float = 0.0
    sweep: tuple = ()


# The [serve] phase: serving needs no gradients, worker copies or residues,
# so the four archs whose fp32 weights fit run at full depth. phi3.5-moe
# (1.30 G parameters a layer, 167 GB in all) and internvl2-26b (0.39 G a
# layer, 79 GB) do not fit one card: they keep ~43 GB of layers.
SERVE_RUNS = (
    ServeRun("paper-transformer-base", dict(n_layers=2)),
    ServeRun("starcoder2-3b", dict(n_layers=2)),
    ServeRun("rwkv6-3b", dict(n_layers=2)),
    # 2304 prompt positions, past the 2048-position local window: the
    # attention layers' caches wrap as rings
    ServeRun("recurrentgemma-2b", dict(n_layers=3), prompt=2304),
    ServeRun("whisper-medium", dict(n_layers=2, encoder_layers=2)),
    ServeRun("phi3.5-moe-42b-a6.6b", dict(n_layers=1), dict(n_layers=8),
             "1.30 G parameters a layer: 32 layers are 167 GB of fp32 weights, 8 are ~43 GB"),
    ServeRun("internvl2-26b", dict(n_layers=1), dict(n_layers=24),
             "0.39 G parameters a layer: 48 layers are 79 GB of fp32 weights, 24 are ~42 GB"),
)
# the reference's prefill/decode consistency tolerance (tests/test_models_smoke.py)
SERVE_CONSISTENCY_TOL = dict(rtol=2e-3, atol=2e-3)
# card against CPU: the largest logit difference over the largest |logit|
# (fp32 both, GEMM sums in other orders)
SERVE_CPU_REL_TOL = 1e-3
SERVE_CPU_BATCH, SERVE_CPU_PROMPT, SERVE_CPU_STEPS = 2, 64, 4

# The [serve:bf16] phase: the reference's production serving configuration
# (repro/launch/dryrun.py:299-300, bf16 parameters and compute) at full
# depth: the paper model, rwkv6-3b (the most fp32 islands: its decay,
# recurrence and state) and internvl2-26b at all 48 layers (19.9 G
# parameters: 40 GB in bf16, 79 GB in fp32).
# bf16 prefill then decode against the prefill of one more token: the
# largest logit difference over the largest |logit|. 3e-2 is the CPU test's
# bound for the port against the reference in bf16 at SMOKE width
# (tests/test_torch_mixed_precision.py; measured up to 1.64e-2, the
# reference's own bf16-fp32 gap up to 1.08e-2). rwkv6-3b's 0.25 at 32 layers:
# PyTorch's GEMMs round a row differently at another M (the prefill of T + 1
# positions, of T, a decode step of 1; XLA's CPU dot does not, so the
# reference's consistency is 0 there), and RWKV-6 magnifies a rounding with
# depth as it magnifies bf16 against fp32. tools/rwkv6_bf16_witness.py at
# full width on the CPU, one draw of the reference's weights: its own
# bf16-fp32 gap 7.3e-3, 1.38e-2, 3.38e-2, 5.51e-2 and 1.44e-1 at 1, 2, 4, 8
# and 16 layers, the port's 8.3e-3 to 1.49e-1, the port's consistency 0,
# 7.0e-3, 1.56e-2, 2.63e-2 and 8.58e-2. 0.25 lies below the reference's own
# gap carried on to 32 layers (x2.6 from 8 to 16). The sweep's depths up to
# BF16_SWEEP_HELD are held at BF16_SERVE_REL.
BF16_SERVE_REL = 3e-2
BF16_SWEEP_HELD = 4
BF16_SERVE_RUNS = (
    ServeRun("paper-transformer-base", dtype="bfloat16", rel_tol=BF16_SERVE_REL),
    ServeRun("rwkv6-3b", dtype="bfloat16", rel_tol=0.25, sweep=(1, 2, 4, 8, 16)),
    ServeRun("internvl2-26b", dtype="bfloat16", rel_tol=BF16_SERVE_REL),
)


def cut_params(params, small) -> dict:
    """The parameters of ``small`` (a config at a cut depth) out of the
    full-depth ``params``: each stack's first layers (views), the rest as is."""
    from repro_torch import tree

    out = dict(params)
    for key in ("blocks", "decoder"):
        if key in params:
            out[key] = tree.tree_map(lambda t: t[:small.n_layers], params[key])
    if "encoder" in params:
        out["encoder"] = {k: t if k.startswith("ln_enc_final") else t[:small.encoder_layers]
                          for k, t in params["encoder"].items()}
    if "units" in params:
        n_units = small.n_layers // len(small.hybrid_pattern)
        out["units"] = tree.tree_map(lambda t: t[:n_units], params["units"])
        tail = small._layer_kinds()[n_units * len(small.hybrid_pattern):]
        out["tail"] = {f"layer_{i}_{k}": params["tail"][f"layer_{i}_{k}"]
                       for i, k in enumerate(tail)}
    return out


def decode_read_bytes(params, state, batch: int) -> tuple:
    """(weight bytes, state bytes) one decode step must move: every weight it
    applies read once (not the encoder's; of an untied embedding table only
    the batch's rows), the decode state read once and its recurrent leaves
    (all but the caches, of which a step writes one slot) written once."""
    from repro_torch import tree

    w = 0
    for path, t in tree.flatten_with_path(params):
        if path.startswith("['encoder']"):
            continue
        if path == "['tok_embed']" and "lm_head" in params:
            w += batch * t.shape[1] * t.element_size()
        else:
            w += t.numel() * t.element_size()
    s = 0
    for path, t in tree.flatten_with_path(state):
        n = t.numel() * t.element_size()
        s += n if path.endswith(("['k']", "['v']", "['slot_pos']")) else 2 * n
    return w, s


def serve_phase(card_line: str, runs=SERVE_RUNS, tag: str = "[serve]") -> None:
    """[serve] (``SERVE_RUNS``) or [serve:bf16] (``BF16_SERVE_RUNS``): each
    run at full width, its weights drawn on the card (a bf16 run's each
    stacked leaf in fp32 a layer at a time, stored in bf16) and freed before
    the next: greedy serving through ``build_serve_fns`` and
    ``launch.serve.generate`` twice (cold, then warm: prefill ms and decode
    ms a token, tokens/s against the decode step's weight-read bound at the
    parameters' bytes, equal tokens both times), peak memory; one decode
    step under ``torch.profiler`` (device busy time, idle share, device
    operations). An fp32 run: the prefill/decode consistency check (MoE at
    the no-drop capacity factor), the card against the CPU at ``cpu_cut``
    (prefill and ``SERVE_CPU_STEPS`` teacher-forced decode steps), for the
    SSM and the hybrid a decode state that does not grow with the context.
    A bf16 run: the logits bf16, every matrix product of a decode step on
    bf16 operands but RWKV-6's fp32 ones (``gemm_dtypes``), prefill/decode
    consistency within the run's ``rel_tol``, at the ``sweep`` depths its
    consistency and bf16 gap; where fp32 weights fit, the weights the fp32
    draw rounded, bit for bit, and the greedy tokens of fp32 weights and
    compute against the bf16 ones. No ScaleCom kernel may launch."""
    import numpy as np
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels, tree
    from repro_torch.configs import registry
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.training.serve import build_serve_fns

    t_phase = time.perf_counter()
    launched = kernels.launches()
    for spec in runs:
        name, B, T = spec.name, spec.batch, spec.prompt
        full = registry.arch(name)
        cfg = dataclasses.replace(full, **spec.cut)
        model = build_model(cfg, compute_dtype=spec.dtype, param_dtype=spec.dtype)
        width = model.param_dtype.itemsize
        depth = (f"{cfg.n_layers} of {full.n_layers}" if not cfg.is_encdec else
                 f"{cfg.encoder_layers} + {cfg.n_layers} of {full.encoder_layers} + "
                 f"{full.n_layers}")
        gc.collect()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        print(f"{tag} {name}: {depth} layers{' (cut: ' + spec.why + ')' if spec.why else ''}; "
              f"{describe(cfg)}; {cfg.param_count():,} parameters "
              f"({cfg.param_count() * width / 2**30:.2f} GiB {spec.dtype}); compute "
              f"{model.compute_dtype}; batch {B}, prompt {T}, gen {spec.gen}; "
              f"{free / 2**30:.2f} GiB free before the run")
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = model.init(gen, "cuda")
        torch.cuda.synchronize()
        t_init, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        check(all(t.dtype == model.param_dtype for t in tree.leaves(params)),
              f"{tag} {name}: a parameter is not {spec.dtype}")
        toks = SyntheticLM(cfg.vocab, seed=0).sample(np.random.default_rng(0), B, T)
        toks = torch.from_numpy(toks).cuda()  # (B, T + 1)
        extra = {}
        if cfg.arch_type == "vlm":
            extra["vision"] = torch.randn((B, cfg.vision_tokens, cfg.d_model), generator=gen,
                                          device="cuda")
        if cfg.is_encdec:
            extra["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                                          device="cuda")
        ctx = T + (cfg.vision_tokens if cfg.arch_type == "vlm" else 0)
        prefill_fn, decode_fn = build_serve_fns(model, seq_len=ctx + spec.gen)
        batch = dict(extra, tokens=toks[:, :T])
        runs_ = [generate(prefill_fn, decode_fn, params, batch, ctx, spec.gen,
                          torch.cuda.synchronize) for _ in range(2)]
        check(torch.equal(runs_[0][0], runs_[1][0]), f"{tag} {name}: two greedy runs differ")
        (_, pre_cold, dec_cold), (tokens, pre_warm, dec_warm) = runs_
        check(tokens.shape == (B, spec.gen) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()), f"{tag} {name}: tokens {tokens}")
        peak = torch.cuda.max_memory_allocated()
        logits, state = prefill_fn(params, batch)
        check(logits.dtype == model.compute_dtype and bool(torch.isfinite(logits).all()),
              f"{tag} {name}: prefill logits {logits.dtype}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        w_bytes, s_bytes = decode_read_bytes(params, state, B)
        # one decode step under the profiler: device busy time, kernels launched
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, step_ms = host_ms(lambda: decode_fn(params, state, tokens[:, 0], ctx))
        on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        n_kernels = sum(e.count for e in on_card)
        del prof, on_card, logits
        ms_tok = dec_warm / (spec.gen - 1) * 1e3
        bound_ms = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
        print(f"{tag} {name}: init {t_init:.1f} s (peak {init_peak / 2**30:.2f} GiB); prefill "
              f"{pre_cold * 1e3:.1f} ms first call, {pre_warm * 1e3:.1f} ms warm ({B} x {ctx} "
              f"positions); decode {ms_tok:.3f} ms a token warm "
              f"({dec_cold / (spec.gen - 1) * 1e3:.3f} cold), {B / ms_tok * 1e3:.1f} tokens/s; "
              f"weight-read bound {bound_ms:.3f} ms ({w_bytes / 1e9:.3f} GB of weights at "
              f"{width} B a weight + {s_bytes / 1e9:.4f} GB of state a step over "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {bound_ms / ms_tok:.1%} of it; peak "
              f"allocated {peak / 2**30:.2f} GiB on {card_line}")
        print(f"{tag} {name}: one decode step under torch.profiler: {step_ms:.3f} ms host clock, "
              + (f"{busy_ms:.3f} ms device busy (idle share {1 - busy_ms / step_ms:.3f}) in "
                 f"{n_kernels} device operations" if busy_ms > 0 else
                 "device time not measured (no device events recorded)") + f" on {card_line}")
        print(f"{tag} {name}: greedy tokens of the first sequence {tokens[0, :16].tolist()}")
        if spec.dtype != "float32":
            with gemm_dtypes() as gemms:
                decode_fn(params, state, tokens[:, 0], ctx)
            fp32_gemms = cfg.n_layers * 3 if cfg.arch_type == "ssm" else 0
            ok = (gemms.get(torch.float32, 0) == fp32_gemms and gemms.get(torch.bfloat16, 0) > 0
                  and set(gemms) <= {torch.float32, torch.bfloat16})
            print(f"{tag} {name}: one decode step's matrix products by operand dtype "
                  f"{ {str(k).removeprefix('torch.'): v for k, v in gemms.items()} } (want every "
                  f"one bf16 but {fp32_gemms} fp32: RWKV-6's decay adapters and state product, "
                  f"3 a layer) {'ok' if ok else 'FAILED'}")
            check(ok, f"{tag} {name}: a decode step's matrix products {gemms}")
        del state
        if spec.dtype == "float32":
            serve_fp32_holds(spec, full, cfg, model, params, toks, extra, ctx, tag)
        else:
            serve_bf16_holds(spec, cfg, model, params, toks, extra, ctx, batch, tokens, tag,
                             card_line, fp32_fits=cfg.param_count() * (4 + width) < 0.8 * free)
        del params, tokens, runs_, batch, extra, toks, model
        gc.collect()
        torch.cuda.empty_cache()
    check(kernels.launches() == launched,
          f"{tag} ScaleCom kernels launched while serving: {kernels.launches()} after "
          f"{launched}")
    print(f"{tag} no ScaleCom kernel launched in the phase ({launched} before and after); "
          f"phase {time.perf_counter() - t_phase:.1f} s wall on {card_line}")


def serve_fp32_holds(spec, full, cfg, model, params, toks, extra, ctx: int, tag: str) -> None:
    """An fp32 [serve] run's holds: prefill/decode consistency at
    ``SERVE_CONSISTENCY_TOL``, an SSM's or hybrid's decode state against
    the context, and the card against the CPU at ``spec.cpu_cut``."""
    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model

    name, B, T = spec.name, spec.batch, spec.prompt
    batch = dict(extra, tokens=toks[:, :T])
    # prefill/decode consistency: decode of token T after prefill(tokens[:T])
    # equals prefill(tokens[:T+1])'s last logits
    cmodel = model if not cfg.n_experts else build_model(
        dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)),
        compute_dtype="float32")
    want, _ = cmodel.prefill(params, dict(extra, tokens=toks), ctx + 8)
    _, state = cmodel.prefill(params, batch, ctx + 8)
    got, state = cmodel.decode_step(params, state, toks[:, T], ctx)
    err = max_abs_err(got, want)
    ok = bool(torch.allclose(got, want, **SERVE_CONSISTENCY_TOL))
    print(f"{tag} {name}: decode of token {T} after prefill of {T} against the prefill of "
          f"{T + 1}{' (no-drop capacity factor ' + str(float(cfg.n_experts)) + ')' if cfg.n_experts else ''}: "
          f"max abs err {err:.3e}, largest |logit| {float(want.abs().max()):.3f} (rtol = atol "
          f"= 2e-3) {'ok' if ok else 'FAILED'}")
    check(ok, f"{tag} {name}: prefill/decode consistency off by {err:.3e}")
    del want, got, state

    if cfg.arch_type in ("ssm", "hybrid"):
        n = [sum(x.numel() for x in tree.leaves(model.init_decode_state(B, seq, "cuda")))
             for seq in (ctx, 16 * ctx)]
        ok = n[0] == n[1] if cfg.arch_type == "ssm" else n[1] <= n[0] * 40
        print(f"{tag} {name}: decode state {n[0]:,} elements at a {ctx}-position context, "
              f"{n[1]:,} at {16 * ctx} {'ok' if ok else 'FAILED'}")
        check(ok, f"{tag} {name}: the decode state grows with the context")

    # the card against the CPU, the same weights cut to cpu_cut
    small = dataclasses.replace(full, **spec.cpu_cut)
    smodel = build_model(small, compute_dtype="float32")
    card_p = cut_params(params, small)
    cpu_p = tree.tree_map(lambda t: t.cpu(), card_p)
    b2, n2 = SERVE_CPU_BATCH, SERVE_CPU_PROMPT
    t2 = torch.from_numpy(SyntheticLM(cfg.vocab, seed=1).sample(
        np.random.default_rng(1), b2, n2 + SERVE_CPU_STEPS - 1))  # (b2, n2 + steps)
    ctx2 = n2 + (cfg.vision_tokens if cfg.arch_type == "vlm" else 0)
    outs, secs = {}, {}
    for dev, p in (("cuda", card_p), ("cpu", cpu_p)):
        t0 = time.perf_counter()
        b = {k: v[:b2].to(dev) for k, v in extra.items()}
        tk = t2.to(dev)  # teacher-forced: the prompt, then the next tokens
        logits, st = smodel.prefill(p, dict(b, tokens=tk[:, :n2]), ctx2 + SERVE_CPU_STEPS)
        outs[dev] = [logits.cpu()]
        for i in range(SERVE_CPU_STEPS):
            logits, st = smodel.decode_step(p, st, tk[:, n2 + i], ctx2 + i)
            outs[dev].append(logits.cpu())
        secs[dev] = time.perf_counter() - t0
    worst = max(max_abs_err(a, c) / float(c.abs().max())
                for a, c in zip(outs["cuda"], outs["cpu"]))
    ok = worst <= SERVE_CPU_REL_TOL
    cut_depth = ", ".join(f"{k} {v}" for k, v in spec.cpu_cut.items())
    print(f"{tag} {name}: card against the CPU at {cut_depth}, {b2} x {n2} prompt "
          f"positions + {SERVE_CPU_STEPS} decode steps: largest logit difference "
          f"{worst:.3e} of the largest |logit| (tolerance {SERVE_CPU_REL_TOL:g}) "
          f"{'ok' if ok else 'FAILED'}; CPU {secs['cpu']:.1f} s")
    check(ok, f"{tag} {name}: card and CPU logits differ by {worst:.3e} of the largest")


def bf16_consistency(model, model32, params, toks, extra, ctx: int) -> tuple:
    """(decode of token T after a prefill of T against the prefill of T + 1,
    the same weights computed in fp32 against bf16 at that prefill): each the
    largest logit difference over the largest |logit| of the bf16 prefill."""
    T = toks.shape[1] - 1
    want, _ = model.prefill(params, dict(extra, tokens=toks), ctx + 8)
    _, state = model.prefill(params, dict(extra, tokens=toks[:, :T]), ctx + 8)
    got, _ = model.decode_step(params, state, toks[:, T], ctx)
    in_fp32, _ = model32.prefill(params, dict(extra, tokens=toks), ctx + 8)
    scale = float(want.float().abs().max())
    return (max_abs_err(got.float(), want.float()) / scale,
            max_abs_err(in_fp32.float(), want.float()) / scale)


def serve_bf16_holds(spec, cfg, model, params, toks, extra, ctx: int, batch, tokens, tag: str,
                     card_line: str, fp32_fits: bool) -> None:
    """A bf16 [serve:bf16] run's holds: prefill/decode consistency within
    ``spec.rel_tol`` (and at the ``spec.sweep`` depths, those up to
    ``BF16_SWEEP_HELD`` within ``BF16_SERVE_REL``); where ``fp32_fits``
    (fp32 weights beside the bf16 ones in 80 % of the free memory), the
    weights the fp32 draw rounded and the greedy tokens' agreement with
    fp32 weights and compute."""
    import torch

    from repro_torch import tree
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.training.serve import build_serve_fns

    name, T, n_gen = spec.name, spec.prompt, spec.gen
    for depth in spec.sweep:
        small = dataclasses.replace(cfg, n_layers=depth)
        rel, gap = bf16_consistency(
            build_model(small, compute_dtype="bfloat16", param_dtype="bfloat16"),
            build_model(small, compute_dtype="float32", param_dtype="bfloat16"),
            cut_params(params, small), toks, extra, ctx)
        held = depth <= BF16_SWEEP_HELD
        print(f"{tag} {name} at {depth} of {cfg.n_layers} layers: prefill/decode consistency "
              f"{rel:.3e} of the largest |logit|, bf16 compute against fp32 on the same weights "
              f"{gap:.3e}" + (f" (tolerance {BF16_SERVE_REL:g}) {'ok' if rel <= BF16_SERVE_REL else 'FAILED'}"
                              if held else ""))
        check(not held or rel <= BF16_SERVE_REL,
              f"{tag} {name} at {depth} layers: prefill/decode consistency off by {rel:.3e}")
    rel, gap = bf16_consistency(
        model, build_model(cfg, compute_dtype="float32", param_dtype="bfloat16"), params, toks,
        extra, ctx)
    ok = rel <= spec.rel_tol
    print(f"{tag} {name}: decode of token {T} after prefill of {T} against the prefill of "
          f"{T + 1}: largest difference {rel:.3e} of the largest |logit| (tolerance "
          f"{spec.rel_tol:g}); the same bf16 weights computed in fp32 stand {gap:.3e} from the "
          f"bf16 prefill {'ok' if ok else 'FAILED'}")
    check(ok, f"{tag} {name}: prefill/decode consistency off by {rel:.3e}")
    if not fp32_fits:
        print(f"{tag} {name}: no fp32 run to compare the greedy tokens with: its "
              f"{cfg.param_count() * 4 / 2**30:.2f} GiB of fp32 weights do not fit beside the "
              f"bf16 ones")
        return
    model32 = build_model(cfg, compute_dtype="float32", param_dtype="float32")
    p32 = model32.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    same = all(torch.equal(a.to(torch.bfloat16).view(torch.int16), b.view(torch.int16))
               for a, b in zip(tree.leaves(p32), tree.leaves(params)))
    check(same, f"{tag} {name}: the bf16 weights are not the fp32 draw rounded")
    p_fn, d_fn = build_serve_fns(model32, seq_len=ctx + n_gen)
    tok32, _, dec32 = generate(p_fn, d_fn, p32, batch, ctx, n_gen, torch.cuda.synchronize)
    equal = (tok32 == tokens)
    first = [int(row.logical_not().nonzero()[0]) if not bool(row.all()) else n_gen
             for row in equal]
    print(f"{tag} {name}: bf16 weights are the fp32 draw rounded (bitwise, every leaf); greedy "
          f"tokens of fp32 weights and compute against bf16: {int(equal.sum())} of "
          f"{equal.numel()} equal, the first difference at positions {first} of {n_gen}; fp32 "
          f"decode {dec32 / (n_gen - 1) * 1e3:.3f} ms a token on {card_line}")


def profiled_step(loop, state, batch, step: int, tag: str, card_line: str) -> tuple:
    """One training step of ``loop`` under ``torch.profiler``: its host ms,
    device busy ms and idle share, and the kernels that take the most
    device time. Returns (the new state, (host ms, busy ms))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = loop.step(state, batch, step)
        check(math.isfinite(float(metrics["loss"])), f"{tag} non-finite loss in the profiled step")
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if busy_ms > 0:
        print(f"{tag} one fused compressed step under torch.profiler: {wall_ms:.1f} ms host "
              f"clock, {busy_ms:.1f} ms device busy, idle share {1 - busy_ms / wall_ms:.3f} "
              f"on {card_line}")
        for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"{tag} {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:100]}")
    else:
        print(f"{tag} device time not measured: torch.profiler recorded no device events "
              f"({wall_ms:.1f} ms host clock)")
    return state, (wall_ms, busy_ms)


@contextlib.contextmanager
def launch_dtypes():
    """{(kernel, its tensors' dtypes): launches} of the kernels launched on
    the card while the block runs (each wrapper asks ``build.on_card`` once
    a launch, with its tensor inputs)."""
    from repro_torch.kernels import build

    seen, real = {}, build.on_card

    def spy(kernel, *tensors):
        on = real(kernel, *tensors)
        if on:
            key = (kernel, tuple(str(t.dtype).removeprefix("torch.") for t in tensors))
            seen[key] = seen.get(key, 0) + 1
        return on

    build.on_card = spy
    try:
        yield seen
    finally:
        build.on_card = real


# under inference_mode (prefill, decode_step) the composite products reach
# the dispatch mode before they decompose
GEMM_OPS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "einsum", "linear")


@contextlib.contextmanager
def gemm_dtypes():
    """{operand dtype: count} of the matrix products (``GEMM_OPS``, each
    counted once by its last tensor operand) dispatched while the block
    runs, under ``no_grad``: a path that quietly computes in fp32 shows
    here, where a loss or logit tolerance cannot see it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in GEMM_OPS:
                flat = [a for x in args for a in (x if isinstance(x, (list, tuple)) else [x])]
                dt = [a for a in flat if isinstance(a, torch.Tensor)][-1].dtype
                seen[dt] = seen.get(dt, 0) + 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Count():
        yield seen


def fp32_inputs(seen: dict, tag: str) -> int:
    """Check that every launch of ``seen`` (``launch_dtypes``) took fp32
    values (int32 offsets beside them); returns the launches."""
    bad = {k: n for k, n in seen.items() if set(k[1]) - {"float32", "int32"}}
    check(not bad, f"{tag} kernel launches on other than fp32 values: {bad}")
    return sum(seen.values())


# bf16 compute against fp32 compute on the card, from the CPU measurements
# (tests/test_torch_mixed_precision.py, the paper model at SMOKE width): the
# reference's own bf16-fp32 gap there is 3.0e-4 of the loss and at most
# 1.7e-2 of a gradient leaf's norm (relative norm of the difference); the
# port's bf16 stood as far from the reference's. Held on the card at 4x each.
BF16_LOSS_REL = 1.2e-3
BF16_GRAD_REL = 7e-2
BF16_GRAD_FLOOR = 1e-3  # a leaf's norm floor: this share of the largest leaf's


def rel_norm_errors(a: dict, b: dict) -> tuple:
    """Per leaf of two {path: (n, *shape)} gradient trees, |a - b| / |b| (L2
    norms, |b| at least ``BF16_GRAD_FLOOR`` of the largest leaf's); returns
    (the largest, its leaf)."""
    import torch

    from repro_torch import tree

    by_path = dict(tree.flatten_with_path(b))
    norms = {p: float(torch.linalg.vector_norm(y.float())) for p, y in by_path.items()}
    floor = BF16_GRAD_FLOOR * max(norms.values())
    worst, worst_path = 0.0, None
    for path, x in tree.flatten_with_path(a):
        check(bool(torch.isfinite(x).all()), f"{path} is not finite")
        err = float(torch.linalg.vector_norm((x - by_path[path]).float())) / max(norms[path], floor)
        if err > worst:
            worst, worst_path = err, path
    return worst, worst_path


def bf16_phase(card_line: str, fp32_step_ms: dict, fp32_profile: tuple) -> dict:
    """[bf16]: the main path in the reference's mixed precision, bf16 compute
    over fp32 parameters (``build_model``'s default): ``train_run`` unfused
    and then fused (launches as planned, vec4, bytes, build-up, a finite
    loss), every launch's inputs recorded and held to fp32 (the gradients of
    fp32 parameters are fp32 whatever the compute dtype). On the fused run's
    weights and one batch: the bf16 batched pass against the fp32 one
    (``BF16_LOSS_REL``, ``BF16_GRAD_REL``) and against the bf16 loop, each
    pass's peak memory, every matrix product of one forward pass on bf16
    operands (``gemm_dtypes``); from the trained state the teacher-forced reduces,
    unfused and fused, held against the torch backend (``arch_hold``); one
    profiled fused step. Prints host ms a step, device busy ms, idle share
    and the pass's peak beside the fp32 run's (``fp32_step_ms``,
    ``fp32_profile``). Returns the two runs' launches, summed."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.scalecom import ScaleComConfig
    from repro_torch.data import make_batches
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule
    from repro_torch.training.train_step import per_worker_grads, per_worker_grads_loop

    t_phase = time.perf_counter()
    cfg = registry.arch("paper-transformer-base")
    workers = 8
    model = build_model(cfg, loss_chunk=64)  # bf16 compute over fp32 parameters
    model32 = build_model(cfg, compute_dtype="float32", loss_chunk=64)
    check(model.compute_dtype == torch.bfloat16 and model.param_dtype == torch.float32,
          f"[bf16] build_model's defaults: {model.compute_dtype} / {model.param_dtype}")
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(0.05), WARMUP)
    base_cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                              min_size=1024, warmup_steps=WARMUP, fused=False)
    print(f"[bf16] paper-transformer-base at full width ({describe(cfg)}), compute "
          f"{model.compute_dtype}, parameters {model.param_dtype}; {workers} workers x 4 x 128 "
          f"tokens, CLT-k chunk {CHUNK} top-1, beta {BETA}, fp32 residues")
    launched = dict.fromkeys(KERNELS, 0)
    step_ms, run = {}, None
    for fused in (False, True):
        del run
        torch.cuda.empty_cache()
        label = "fused" if fused else "unfused"
        with launch_dtypes() as seen:
            run = train_run(cfg, model, opt, sched, dataclasses.replace(base_cfg, fused=fused),
                            workers, STEPS, f"bf16 {label}", card_line, f"[bf16:{label}]")
        n = fp32_inputs(seen, f"[bf16:{label}]")
        check(n == sum(run.launches.values()), f"[bf16:{label}] {n} launches seen, "
              f"{sum(run.launches.values())} counted")
        print(f"[bf16:{label}] every one of the {n} kernel launches took fp32 values: "
              + ", ".join(f"{k} {list(d)} x{c}" for (k, d), c in sorted(seen.items())))
        launched = {k: c + run.launches[k] for k, c in launched.items()}
        step_ms[label] = run.step_ms
    state, loop, batches, plans = run.state, run.loop, run.batches, run.plans
    del run

    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(make_batches(cfg.vocab, workers, 4, 128, seed=1)).items()}
    passes, peaks = {}, {}
    for name, m, fn in (("fp32", model32, per_worker_grads), ("bf16", model, per_worker_grads),
                        ("bf16 loop", model, per_worker_grads_loop)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        passes[name], ms = host_ms(lambda: fn(m, state.params, batch, workers))
        peaks[name] = (torch.cuda.max_memory_allocated() - base, ms)
    for other, what in (("fp32", "the fp32 batched pass"), ("bf16 loop", "the bf16 loop")):
        (la, _, ga), (lb, _, gb) = passes["bf16"], passes[other]
        loss_rel = abs(float(la) - float(lb)) / abs(float(lb))
        worst, worst_path = rel_norm_errors(ga, gb)
        ok = loss_rel <= BF16_LOSS_REL and worst <= BF16_GRAD_REL
        print(f"[bf16] the bf16 batched pass against {what}, same weights and batch: loss "
              f"{float(la):.6f} vs {float(lb):.6f} (rel {loss_rel:.3e}, tolerance "
              f"{BF16_LOSS_REL:g}); largest leaf |a-b|/|b| {worst:.3e} ({worst_path}; tolerance "
              f"{BF16_GRAD_REL:g}) {'ok' if ok else 'FAILED'}")
        check(ok, f"[bf16] bf16 batched pass against {what}: loss rel {loss_rel:.3e}, "
                  f"gradient {worst:.3e} at {worst_path}")
    check(all(g.dtype == torch.float32 for g in tree.leaves(passes["bf16"][2])),
          "[bf16] gradients of fp32 parameters are not fp32")
    with gemm_dtypes() as gemms:
        model.loss(state.params, {k: v[0] for k, v in batch.items()})
    ok = set(gemms) == {torch.bfloat16}
    print(f"[bf16] one forward pass of the loss (one worker's 4 x 128 tokens): matrix products "
          f"by operand dtype { {str(k).removeprefix('torch.'): v for k, v in gemms.items()} } "
          f"(want every one bf16) {'ok' if ok else 'FAILED'}")
    check(ok, f"[bf16] the forward pass's matrix products {gemms}")
    gpw = passes.pop("bf16")[2]
    del passes
    print(f"[bf16] batched pass peak above the state: bf16 {peaks['bf16'][0] / 2**30:.2f} GiB "
          f"({peaks['bf16'][1]:.1f} ms host), fp32 {peaks['fp32'][0] / 2**30:.2f} GiB "
          f"({peaks['fp32'][1]:.1f} ms); the bf16 loop {peaks['bf16 loop'][0] / 2**30:.2f} GiB "
          f"({peaks['bf16 loop'][1]:.1f} ms) on {card_line}")

    # the teacher-forced reduces from the bf16-trained state; the momentum waits
    sc_state = state.sc_state
    for fused in (False, True):
        arch_hold(f"bf16 {'fused' if fused else 'unfused'}", gpw, sc_state, base_cfg, plans,
                  fused, workers, card_line, tag="[bf16]")
    del gpw, sc_state
    torch.cuda.empty_cache()
    state, (wall_ms, busy_ms) = profiled_step(loop, state, next(batches), STEPS, "[bf16:profile]",
                                              card_line)
    fp32_wall, fp32_busy = fp32_profile
    share = lambda w, b: f"{1 - b / w:.3f}" if b > 0 else "not measured"  # noqa: E731
    print(f"[bf16] host ms a step (dense, then compressed), bf16 compute against fp32: unfused "
          + " / ".join(f"{a:.1f}" for a in step_ms["unfused"]) + " against "
          + " / ".join(f"{a:.1f}" for a in fp32_step_ms["unfused"]) + "; fused "
          + " / ".join(f"{a:.1f}" for a in step_ms["fused"]) + " against "
          + " / ".join(f"{a:.1f}" for a in fp32_step_ms["fused"])
          + f"; a profiled fused step {wall_ms:.1f} ms host, {busy_ms:.1f} device busy, idle "
          f"share {share(wall_ms, busy_ms)} against {fp32_wall:.1f} / {fp32_busy:.1f} / "
          f"{share(fp32_wall, fp32_busy)}; phase {time.perf_counter() - t_phase:.1f} s on "
          f"{card_line}")
    del state, loop, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def arch_bf16_phase(card_line: str, fp32_peaks: dict) -> dict:
    """[arch:bf16]: each ``ARCH_RUNS`` cut in bf16 compute over fp32
    parameters, fused, 1 dense + 1 compressed step through ``train_run``
    (launches and bytes as planned, build-up, a finite loss), every launch
    on fp32 values; the peak beside the fp32 run's (``fp32_peaks``, by
    ``arch_phase``'s labels). Returns the runs' launches, summed."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.scalecom import ScaleComConfig
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule

    t_phase = time.perf_counter()
    launched = dict.fromkeys(KERNELS, 0)
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(0.05), 1)
    sc_cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                            min_size=1024, warmup_steps=1, fused=True)
    for spec in ARCH_RUNS:
        cfg = dataclasses.replace(registry.arch(spec.name), **spec.cut)
        model = build_model(cfg, loss_chunk=64)  # bf16 compute over fp32 parameters
        label = f"{spec.name} fused"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with launch_dtypes() as seen:
            run = train_run(cfg, model, opt, sched, sc_cfg, spec.workers, 2, f"bf16 {label}",
                            card_line, f"[arch:bf16] {label}", spec.local_batch, spec.seq,
                            torch.Generator(device="cuda").manual_seed(0))
        fp32_inputs(seen, f"[arch:bf16] {label}")
        peak = torch.cuda.max_memory_allocated()
        print(f"[arch:bf16] {label}: {', '.join(f'{k} {v}' for k, v in spec.cut.items())}, "
              f"compute {model.compute_dtype}; every launch on fp32 values; peak allocated "
              f"{peak / 2**30:.2f} GiB against {fp32_peaks[label] / 2**30:.2f} GiB in fp32 "
              f"compute (2 dense + 3 compressed steps there) on {card_line}")
        launched = {k: n + run.launches[k] for k, n in launched.items()}
        del run, model
    check(launched["fused_reduce"] > 0, "[arch:bf16] fused_reduce never launched")
    print(f"[arch:bf16] launches {launched}; phase {time.perf_counter() - t_phase:.1f} s wall on "
          f"{card_line}")
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# The [ring] phase: real collectives. NCCL puts one rank on a card and the
# machine has one, so the ranks share it over gloo, whose all_reduce and
# broadcast take CUDA tensors (staged through host memory).
RING_BACKEND = "gloo"
RING_WORLD = 8  # (b): one rank per worker of the main path
RING_REDUCE_RANKS = 4  # (a): the tok_embed reduce, each rank leading once
RING_TIMEOUT_S = 300  # every collective's (init_process_group)
RING_PHASE_S = 600  # the whole phase's, the spawn to the last rank's result
RING_COLLECTIVE_REPS = 5
GAMMA_RTOL = 1e-5  # contraction gamma over the ranks against the stacked reduce's


@dataclasses.dataclass(frozen=True)
class RingRun:
    """One training run of ``[ring]`` over ``RING_WORLD`` ranks: the main
    path's model and batch, ``warmup`` dense steps and then compressed ones
    up to ``steps``, with this compressor (``exact``: its dense top-k
    path), residue codec, ``groups`` (G groups of ``RING_WORLD / G``
    ranks), ``compute_stats``, bucket byte target (None: unbucketed) and
    side-stream ``overlap``, ``fused`` reduce and ``telemetry`` (the taps,
    the similarity ones every ``metrics_every`` steps)."""

    label: str
    compressor: str = "clt_k"
    codec: str = "fp32"
    groups: int | None = None
    stats: bool = False
    warmup: int = 1
    steps: int = 3
    buckets: int | None = None
    overlap: bool = True
    fused: bool = False
    exact: bool = False
    telemetry: bool = False
    metrics_every: int = 0

    @property
    def name(self) -> str:
        return (f"{self.compressor}{' exact' if self.exact else ''}, {self.codec} residues"
                + (f", groups={self.groups}" if self.groups else "")
                + (f", {self.buckets >> 20} MB buckets, overlap "
                   f"{'on' if self.overlap else 'off'}" if self.buckets else "")
                + (", fused" if self.fused else "")
                + (f", telemetry (metrics_every {self.metrics_every})" if self.telemetry else "")
                + (", compute_stats" if self.stats else ""))


# (b), the main path's settings, and the runs of the other configurations the
# group step runs (the reference's pod2 setting: fp8, 2 groups of 4; its CI's
# 8 MB buckets and fused legs, here at the port's 25 MB default and 4 MB)
RING_TRAIN = RingRun("train", warmup=2, steps=5)
RING_RUNS = (
    RingRun("compressors", "true_topk"),
    RingRun("compressors", "local_topk"),
    RingRun("compressors", "random_k"),
    RingRun("codecs", codec="bf16"),
    RingRun("codecs", codec="fp8"),
    RingRun("codecs", codec="fp8_ec"),
    RingRun("pod2", codec="fp8", groups=2, stats=True),
    RingRun("buckets", buckets=25 << 20),
    RingRun("buckets", buckets=4 << 20),
    RingRun("buckets", buckets=25 << 20, overlap=False),
    RingRun("telemetry", telemetry=True, metrics_every=1, stats=True),
    RingRun("fused", fused=True),
    RingRun("fused", "true_topk", fused=True),
    RingRun("exact", exact=True),
)
# the byte counts a rank sends along in ``exchange``, after its digests
SENT_KEYS = ("payload", "oracle", "intra", "stats", "telemetry")
_BITS = {4: "int32", 2: "int16", 1: "uint8"}


def digest(x) -> list:
    """Two 64-bit sums of the bit patterns of a tensor (its elements' bits
    as integers) under fixed odd weights, one per element position (int64
    arithmetic wraps): equal tensors give equal digests, and a difference
    anywhere changes them except with a chance of about 2^-64. How ranks
    compare tensors bit for bit without sending them."""
    import torch

    bits = x.contiguous().view(getattr(torch, _BITS[x.element_size()])).reshape(-1)
    bits = bits.to(torch.int64)
    i = torch.arange(bits.numel(), dtype=torch.int64, device=x.device)
    return [int(torch.sum(bits * ((i * a + b) | 1))) for a, b in
            ((0x5851F42D4C957F2D, 0x14057B7EF767814F), (0x2545F4914F6CDD1D, 0x1B03738712FAD5C9))]


def exchange(row: list, rank: int, world: int) -> list:
    """Every rank's ``row`` of ints, on every rank: one all_reduce of a CPU
    int64 table in which each rank fills its own row."""
    import torch
    import torch.distributed as dist

    table = torch.zeros((world, len(row)), dtype=torch.int64)
    table[rank] = torch.tensor(row, dtype=torch.int64)
    dist.all_reduce(table)
    return table.tolist()


class CollectiveClock:
    """Host ms of every ``torch.distributed`` broadcast, all_reduce and
    all_gather this process makes inside ``with clock:``, and the number of
    calls, by kind: "offsets" (a broadcast of int32; the taps' float32
    broadcast is "telemetry"), else the ``ring.sent`` key the ring counted
    for it just before ("values", "dense", "indices",
    "oracle", "intra", "stats", "telemetry"), else "metrics" (the loss and
    aux all_reduce). A blocking call is timed between two device syncs (it
    blocks the host anyway); an async one (a bucketed step's) by the host
    time of its issue and of its ``wait()``, with no sync, so that the
    overlap it buys stays in the step."""

    KINDS = ("offsets", "values", "dense", "indices", "oracle", "intra", "stats", "telemetry",
             "metrics")

    def __init__(self):
        self.ms = dict.fromkeys(self.KINDS, 0.0)
        self.calls = dict.fromkeys(self.KINDS, 0)

    def _kind(self, default):
        from repro_torch.distributed import ring

        moved = [k for k, v in ring.sent.items() if v != self._seen[k]]
        self._seen = dict(ring.sent)
        return default or (moved[-1] if moved else "metrics")

    def _timed(self, fn, default=None):
        import torch

        clock = self
        broadcast = default == "offsets"

        class Waited:
            def __init__(self, work, kind):
                self.work, self.kind = work, kind

            def wait(self):
                t0 = time.perf_counter()
                out = self.work.wait()
                clock.ms[self.kind] += (time.perf_counter() - t0) * 1e3
                return out

        def call(*args, **kwargs):
            kind = self._kind(default)
            if broadcast and args[0].dtype != torch.int32:
                kind = "telemetry"  # rank 0's similarity taps, float32
            self.calls[kind] += 1
            if kwargs.get("async_op"):
                t0 = time.perf_counter()
                work = fn(*args, **kwargs)
                self.ms[kind] += (time.perf_counter() - t0) * 1e3
                return Waited(work, kind)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[kind] += (time.perf_counter() - t0) * 1e3
            return out

        return call

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.distributed import ring

        self._seen = dict(ring.sent)
        self._real = dist.broadcast, dist.all_reduce, dist.all_gather
        dist.broadcast = self._timed(dist.broadcast, "offsets")
        dist.all_reduce = self._timed(dist.all_reduce)
        dist.all_gather = self._timed(dist.all_gather)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.broadcast, dist.all_reduce, dist.all_gather = self._real
        return False


class OffsetSpy:
    """Inside ``with spy:``, a clone of the offsets of every ``ef_update``
    and ``fused_select_update`` of the CUDA backend in this process, in call
    order (the ring's: this rank's offsets; the stacked reduce's: shared, or
    one row per worker)."""

    def __enter__(self):
        from repro_torch.backends.cuda_backend import CudaBackend

        self.offsets = []
        self._real = CudaBackend.ef_update, CudaBackend.fused_select_update
        real_update, real_fused = self._real
        offsets = self.offsets

        def ef_update(backend, m, g, idx, *args, **kwargs):
            offsets.append(idx.clone())
            return real_update(backend, m, g, idx, *args, **kwargs)

        def fused_select_update(backend, *args, **kwargs):
            out = real_fused(backend, *args, **kwargs)
            offsets.append(out[0].clone())
            return out

        CudaBackend.ef_update = ef_update
        CudaBackend.fused_select_update = fused_select_update
        return self

    def __exit__(self, *exc):
        from repro_torch.backends.cuda_backend import CudaBackend

        CudaBackend.ef_update, CudaBackend.fused_select_update = self._real
        return False


def reorder_bound(vals, idx, backend):
    """Elementwise bound on how far two worker means of ``vals`` ((n,
    rows) per-chunk values) may differ when their sums are taken in two
    orders, scattered as ĝ is: each recursive fp32 sum of n terms lies
    within gamma_{n-1} * sum |v| of the exact one (gamma_k = k u / (1 - k u),
    u = 2^-24), and each division by n rounds once more. Unit-scale values
    that cancel break rtol 1e-6 / atol 1e-7, which worker means of gradients
    (a few 1e-3) keep."""
    n = vals.shape[0]
    u = 2.0 ** -24
    gamma = (n - 1) * u / (1 - (n - 1) * u)
    slack = (2 * gamma * vals.abs().sum(0) + 2 * u * vals.sum(0).abs()) / n
    return backend.scatter(slack, idx, CHUNK, P)


def ring_reduce_rank(rank: int, group) -> dict:
    """(a) on one of ``RING_REDUCE_RANKS`` ranks: the tok_embed tensor's ring
    reduce at t = 0..3 on the card, the CUDA backend against the torch
    backend (offsets, m' and ĝ bitwise) and against the single-process
    stacked CUDA reduce of the same rows (``scalecom_reduce``: offsets and
    m' bitwise, ĝ within ``TOL``); then, one rank after another, the
    device ms of the three kernels on this rank's row and, all together,
    the host ms of each collective."""
    import torch
    import torch.distributed as dist

    from repro_torch.backends import resolve_backend
    from repro_torch.core.compressors import CompressorConfig, select_indices
    from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
    from repro_torch.core.state import ScaleComState
    from repro_torch.distributed import clt_ring_reduce

    n = group.size()
    comp = CompressorConfig("clt_k", chunk=CHUNK)
    # every rank draws all n rows on the card from the same seeds
    rows = []
    for r in range(n):
        gen = torch.Generator(device="cuda").manual_seed(1000 + r)
        rows.append((torch.randn(P, generator=gen, device="cuda"),
                     torch.randn(P, generator=gen, device="cuda")))
    g4 = torch.stack([g for g, _ in rows])
    m4 = torch.stack([m for _, m in rows])
    del rows
    g, m = g4[rank].clone(), m4[rank].clone()
    cuda_be = resolve_backend("cuda")
    stacked_cfg = ScaleComConfig(compressor=comp, beta=BETA, min_size=1, backend="cuda",
                                 fused=False, layout="flat")
    captured = []
    real_broadcast = dist.broadcast

    def spy(tensor, *args, **kwargs):
        out = real_broadcast(tensor, *args, **kwargs)
        captured.append(tensor)
        return out

    err, outside_tol = 0.0, 0
    dist.broadcast = spy
    for t in range(n):
        got = {}
        for backend in ("cuda", "torch"):
            captured.clear()
            ghat, m_new = clt_ring_reduce(g, m, t, comp, BETA, group, backend)
            got[backend] = (captured[0], ghat, m_new)
        check(all(bitwise(a, b) for a, b in zip(got["cuda"], got["torch"])),
              f"[ring] rank {rank} t={t}: the cuda ring differs from the torch ring")
        ghat_s, st, _ = scalecom_reduce({"w": g4}, ScaleComState({"['w']": {"q": m4}}, t),
                                        stacked_cfg)
        idx_s = select_indices(m4 + g4, t, comp, cuda_be)
        idx, ghat, m_new = got["cuda"]
        check(bitwise(idx, idx_s) and bitwise(m_new, st.residues["['w']"]["q"][rank]),
              f"[ring] rank {rank} t={t}: offsets or m' differ from the stacked cuda reduce")
        slack = reorder_bound(cuda_be.ef_update(m4, g4, idx_s, BETA, CHUNK)[1], idx_s, cuda_be)
        diff = (ghat - ghat_s["w"]).abs()
        check(bool((diff <= slack).all()),
              f"[ring] rank {rank} t={t}: ghat differs from the stacked reduce beyond the "
              f"rounding of a {n}-term sum in another order")
        err = max(err, float(diff.max()))
        outside_tol += int((~torch.isclose(ghat, ghat_s["w"], **TOL)).sum())
        del got, ghat_s, st, idx_s, slack, diff
    dist.broadcast = real_broadcast

    # device ms of the kernels on this rank's row, one rank after another
    ef = m + g
    idx = cuda_be.select_indices(ef, CHUNK)
    _, vals = cuda_be.ef_update(m, g, idx, BETA, CHUNK)
    times = {}
    for r in range(n):
        if r == rank:
            times = {
                "select": device_ms(lambda: cuda_be.select_indices(ef, CHUNK),
                                    (counter("chunk_argmax", "vec4"), 1), what="[ring] select"),
                "ef_update": device_ms(lambda: cuda_be.ef_update(m, g, idx, BETA, CHUNK),
                                       (counter("ef_update"), 1), what="[ring] ef_update"),
                "scatter": device_ms(lambda: cuda_be.scatter(vals, idx, CHUNK, P),
                                     (counter("chunk_scatter", "vec4"), 1),
                                     what="[ring] scatter"),
            }
        dist.barrier(group=group)
    # host ms of each collective, all ranks together
    coll = {"offsets": [], "values": []}
    leader_rank = dist.get_process_group_ranks(group)[0]
    for _ in range(RING_COLLECTIVE_REPS):
        buf = idx.clone()
        _, ms = host_ms(lambda: dist.broadcast(buf, src=leader_rank, group=group))
        coll["offsets"].append(ms)
        buf = vals.clone()
        _, ms = host_ms(lambda: dist.all_reduce(buf, group=group))
        coll["values"].append(ms)
    return {"max_abs_err": err, "outside_tol": outside_tol, "device_ms": times,
            "collective_ms": {k: statistics.median(v) for k, v in coll.items()},
            "payload": (idx.numel() * 4, vals.numel() * 4)}


def ring_leaders(run: RingRun, world: int) -> list:
    """Per compressed step of ``run``, the ranks that select: the leader
    (clt_k, true_topk), the leader group's ranks (with ``groups``), every
    rank (local_topk) or none (random_k)."""
    out = []
    for t in range(run.warmup, run.steps):
        if run.compressor == "local_topk":
            out.append(list(range(world)))
        elif run.compressor == "random_k":
            out.append([])
        elif run.groups:
            size = world // run.groups
            out.append(list(range(t % run.groups * size, (t % run.groups + 1) * size)))
        else:
            out.append([t % world])
    return out


def ring_train_rank(rank: int, world: int, run: RingRun = RING_TRAIN) -> dict:
    """A ``RingRun`` on one of ``RING_WORLD`` ranks: paper-transformer-base at
    full width through ``build_train_step(group=...)``, one worker per rank,
    4 x 128 tokens a rank, chunk 64, beta 0.1. Each step is timed (host
    clock; the gradient pass and each kind of collective inside it between
    device syncs) with the kernels' launches counted; then rank 0 runs the
    single-process stacked step from the same state and the same gradients
    (each worker's pass again, which must give the rank's bits) and holds
    it (``ring_stacked_hold``): ĝ, the params and the loss within ``TOL``,
    its offsets bitwise rank 0's, every rank's params bitwise identical,
    every rank's residue row (every field; its group's row) bitwise the
    stacked step's, the counted payload the plan's, contraction gamma
    within ``GAMMA_RTOL``. Rank 0 then times the reduce's kernels of one
    step at its shapes and, for a stochastically rounding codec, the
    dither draw."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels, tree
    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.scalecom import ScaleComConfig
    from repro_torch.data import make_batches
    from repro_torch.distributed import ring
    from repro_torch.kernels import chunk_topk as ct, fused_reduce as frk
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.training import build_train_step, init_train_state, shard_train_state
    from repro_torch.training import train_step as ts

    group = dist.group.WORLD
    cfg = registry.arch("paper-transformer-base")
    model = build_model(cfg, compute_dtype="float32", loss_chunk=64)
    sc_cfg = ScaleComConfig(compressor=CompressorConfig(run.compressor, chunk=CHUNK,
                                                        exact=run.exact),
                            beta=BETA, min_size=1024, residue_dtype=run.codec, groups=run.groups,
                            warmup_steps=run.warmup, fused=run.fused, overlap=run.overlap,
                            telemetry=run.telemetry, metrics_every=run.metrics_every)
    base_opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(0.05), run.warmup)
    ghats = []  # the ĝ each update receives (rank 0 holds it against the stacked step)

    def update(grads, state, params, lr):
        if rank == 0:
            ghats.append(grads)
        return base_opt.update(grads, state, params, lr)

    opt = Optimizer(base_opt.init, update)
    full = init_train_state(model, opt, sc_cfg, torch.Generator().manual_seed(0),
                            n_workers=world, device="cuda")
    state = shard_train_state(full, rank, world, run.groups)
    ref_residues = full.sc_state.residues if rank == 0 else None
    del full
    fns = {mode: build_train_step(model, opt, sched, sc_cfg, n_workers=world, mode=mode,
                                  group=group, compute_stats=run.stats,
                                  buckets=run.buckets or False)
           for mode in ("dense", "scalecom")}
    # the gradient pass inside the step, timed between device syncs; its
    # result kept for the digests
    grads_ms, own_grads = [0.0], []

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            grads_ms[0] += (time.perf_counter() - t0) * 1e3
            own_grads.append(out[2])
            return out
        return call

    plain_grads = ts.per_worker_grads, ts.dense_grads
    ts.per_worker_grads, ts.dense_grads = timed(ts.per_worker_grads), timed(ts.dense_grads)
    batches = make_batches(cfg.vocab, world, 4, 128, seed=0)
    launches = dict.fromkeys(kernels.launches(), 0)
    variants = {"chunk_argmax": 0, "chunk_scatter": 0}
    routes0 = dict(frk.fused_select_update.routes)
    steps, checks = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(run.steps):
        mode = "scalecom" if i >= run.warmup else "dense"
        batch_np = next(batches)
        before = (tree.tree_map(torch.clone, state.params),
                  tree.tree_map(torch.clone, state.opt_state)) if rank == 0 else None
        t_sc = state.sc_state.t
        ghats.clear()
        own_grads.clear()
        grads_ms[0] = 0.0
        ring.reset_sent()
        c0, v0 = kernels.launches(), (ct.chunk_argmax.variants["vec4"],
                                      ct.chunk_scatter.variants["vec4"])
        dist.barrier()
        with CollectiveClock() as clock, OffsetSpy() as spy:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fns[mode](state, batch_np)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        c1 = kernels.launches()
        for k in launches:
            launches[k] += c1[k] - c0[k]
        variants["chunk_argmax"] += ct.chunk_argmax.variants["vec4"] - v0[0]
        variants["chunk_scatter"] += ct.chunk_scatter.variants["vec4"] - v0[1]
        check(math.isfinite(loss), f"[ring:{run.label}] {run.name}: rank {rank} step {i}: "
                                   f"loss {loss}")
        sent = [ring.payload_sent()] + [ring.sent[k] for k in SENT_KEYS[1:]]
        steps.append({"mode": mode, "step_ms": step_ms, "grads_ms": grads_ms[0],
                      "collective_ms": dict(clock.ms), "collective_calls": dict(clock.calls),
                      "loss": loss, "sent": sent,
                      "comm_bytes_per_worker": metrics.get("comm_bytes_per_worker"),
                      "comm_bytes_dense": metrics.get("comm_bytes_dense")})
        # digests: params (identical on every rank), every field of this
        # rank's residue row and its own gradients (in leaf order)
        paths = sorted(state.sc_state.residues)
        row = ([d for p in tree.leaves(state.params) for d in digest(p)]
               + [d for p in paths for f in sorted(state.sc_state.residues[p])
                  for d in digest(state.sc_state.residues[p][f][0])]
               + [d for x in tree.leaves(own_grads[0]) for d in digest(x)] + sent)
        table = exchange(row, rank, world)
        taps = sorted(k for k in metrics if k.startswith("obs/"))
        if taps:  # every rank's tap values, bit for bit
            tap_rows = exchange(digest(torch.stack([torch.as_tensor(metrics[k], device="cuda")
                                                    .float().reshape(()) for k in taps])),
                                rank, world)
            check(all(x == tap_rows[0] for x in tap_rows),
                  f"[ring:{run.label}] {run.name}: step {i}: the ranks' tap values differ")
        if rank == 0:
            checks.append(ring_stacked_hold(i, mode, run, model, base_opt, sched, sc_cfg, before,
                                            batch_np, state, metrics, ghats[0], ref_residues,
                                            t_sc, table, paths, plain_grads, spy.offsets))
            ref_residues = checks[-1].pop("residues")
        last_grads = own_grads[0]
        del before, spy
    ts.per_worker_grads, ts.dense_grads = plain_grads
    peak = torch.cuda.max_memory_allocated()
    routes = {k: v - routes0[k] for k, v in frk.fused_select_update.routes.items()}
    # the reduce's kernels of one compressed step at this rank's shapes, on
    # rank 0 alone while the others wait
    kernel_ms = dither = None
    if rank == 0:
        kernel_ms = ring_kernel_times(state.sc_state.residues, last_grads, run, world)
        dither = ring_dither_times(state.sc_state.residues, sc_cfg, run, world)
    dist.barrier()
    return {"steps": steps, "launches": launches, "variants": variants, "peak": peak,
            "checks": checks, "kernel_ms": kernel_ms, "dither": dither,
            "n_compressed": len(paths), "leaders": ring_leaders(run, world),
            "select_update_routes": routes}


@contextlib.contextmanager
def offsets_held(ring_offsets: list, near: list, n: int):
    """Inside, the stacked reduce's true_topk selection is held against the
    ring's offsets (``ring_offsets``, one per compressed tensor in leaf
    order, popped) and then replaced by them: a chunk may differ only where
    the stacked worker-mean EF's magnitudes at the two offsets lie within
    the rounding of an n-term fp32 sum in two orders (counted into
    ``near``); any other difference fails."""
    import torch

    from repro_torch.core import scalecom as sc_mod

    real = sc_mod.select_indices

    def select(ef, t, comp, backend):
        idx = real(ef, t, comp, backend)
        got = ring_offsets.pop(0)
        check(comp.topm == 1 and got.shape == idx.shape,
              f"[ring] true_topk held at top-1 only: offsets {tuple(got.shape)} against "
              f"{tuple(idx.shape)}")
        diff = torch.nonzero(idx != got).reshape(-1)
        if diff.numel():
            u = 2.0 ** -24
            gamma = (n - 1) * u / (1 - (n - 1) * u)
            a = torch.mean(ef, dim=0).abs().reshape(-1)
            slack = ((2 * gamma * ef.abs().sum(0) + 2 * u * ef.sum(0).abs()) / n).reshape(-1)
            pos_s = diff * comp.chunk + idx[diff].long()
            pos_r = diff * comp.chunk + got[diff].long()
            far = int(((a[pos_s] - a[pos_r]).abs() > slack[pos_s] + slack[pos_r]).sum())
            check(far == 0, f"[ring] true_topk: {far} of {diff.numel()} chunks whose offsets "
                            f"differ from the stacked reduce's are no near tie")
        near.append(int(diff.numel()))
        return got

    sc_mod.select_indices = select
    try:
        yield
    finally:
        sc_mod.select_indices = real


def ring_stacked_hold(i: int, mode: str, run: RingRun, model, opt, sched, sc_cfg, before,
                      batch_np, state, metrics, ghat, ref_residues, t: int, table: list,
                      paths: list, grads_fns, ring_offsets: list) -> dict:
    """Rank 0 after step ``i`` of ``run``: the single-process stacked step
    from the state before it (``before``: params and optimizer state;
    ``ref_residues``: every worker's, or group's, residue rows; ``t``) and
    the ranks' own gradients, recomputed here worker by worker (each rank's
    digests must match); then rank 0's ĝ and params within ``TOL`` of the
    stacked step's, the loss within it, the offsets rank 0's ring used
    (``ring_offsets``) bitwise the stacked reduce's (for true_topk up to
    counted near ties, whose chunks the stacked reduce then takes from the
    ring), the params bitwise identical on every rank, every rank's
    residue row bitwise the stacked step's row (its group's: the replicas
    of a group's row bitwise each other), contraction gamma within
    ``GAMMA_RTOL`` and the mean counted payload the plan's (all by the
    digests and counts in ``table``). Returns the errors, and the stacked
    step's residues for the next step under "residues"."""
    import torch

    from repro_torch import tree
    from repro_torch.core.scalecom import scalecom_reduce
    from repro_torch.core.state import ScaleComState

    world = len(table)
    params0, opt0 = before
    per_worker_grads, dense_grads = grads_fns
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch_np.items()}
    leaves, losses = [], []
    n_par = 2 * len(tree.leaves(params0))
    n_res = 2 * sum(len(ref_residues[p]) for p in paths)
    tag = f"[ring:{run.label}] {run.name}: step {i}"
    for w in range(world):
        one = {k: v[w:w + 1] for k, v in batch.items()}
        if mode == "scalecom":
            loss, _, g = per_worker_grads(model, params0, one, 1)
        else:
            loss, _, g = dense_grads(model, params0, one)
        check(table[w][n_par + n_res:-len(SENT_KEYS)] == [d for x in tree.leaves(g)
                                                           for d in digest(x)],
              f"{tag}: rank {w}'s gradients differ from the same pass on rank 0")
        leaves.append(tree.leaves(g))
        losses.append(loss)
        del g
    near, gamma_err, taps = [], None, None
    if mode == "scalecom":
        gpw = tree.unflatten(params0, [torch.cat(xs) for xs in zip(*leaves)])
        del leaves
        held = (offsets_held(list(ring_offsets), near, world)
                if run.compressor == "true_topk" and not run.exact else contextlib.nullcontext())
        # unfused (its ef_update runs at the offsets, as on a non-leader rank;
        # the fused stacked reduce's are bitwise the same), with the run's
        # buckets, so that the stacked reduce visits the tensors in the ring's order
        with held, OffsetSpy() as spy:
            ghat_ref, ref_state, stats = scalecom_reduce(
                gpw, ScaleComState(ref_residues, t), dataclasses.replace(sc_cfg, fused=False),
                compute_stats=run.stats, buckets=run.buckets or False)
        del gpw
        if run.exact:
            # the exact path runs no ef_update: its offsets are ĝ's support
            sup = [bitwise(a != 0, b != 0) for a, b in zip(tree.leaves(ghat),
                                                            tree.leaves(ghat_ref))]
            check(all(sup), f"{tag}: rank 0's ghat support (the exact offsets) differs from "
                            f"the stacked exact path's in {sup.count(False)} tensors")
        else:
            check(len(spy.offsets) == len(ring_offsets) == len(paths),
                  f"{tag}: {len(ring_offsets)} ring and {len(spy.offsets)} stacked ef_updates, "
                  f"want {len(paths)}")
        for j, (mine, theirs) in enumerate(zip(ring_offsets, spy.offsets)):
            want = theirs[0] if run.compressor == "local_topk" else theirs
            check(bitwise(mine, want), f"{tag}: rank 0's offsets of compressed tensor {j} "
                                       f"differ from the stacked reduce's")
        if run.telemetry:
            taps = taps_held(metrics, stats, tag)
        residues = ref_state.residues
        planned = stats["comm_bytes_per_worker"]
        check(metrics["comm_bytes_per_worker"] == planned,
              f"{tag}: comm_bytes_per_worker {metrics['comm_bytes_per_worker']} "
              f"against the stacked reduce's {planned}")
        if run.stats:
            got, want = metrics["contraction_gamma"], stats["contraction_gamma"]
            gamma_err = abs(float(got) - float(want)) / abs(float(want))
            check(gamma_err <= GAMMA_RTOL, f"{tag}: contraction_gamma {float(got)} against "
                                           f"the stacked {float(want)}")
    else:
        ghat_ref = tree.unflatten(params0, [torch.mean(torch.stack(xs), 0) for xs in zip(*leaves)])
        del leaves
        residues = ref_residues
        planned = sum(4.0 * p.numel() for p in tree.leaves(params0))
    loss_ref = torch.stack(losses).sum() / world
    ghat_err = max(max_abs_err(a, b) for a, b in zip(tree.leaves(ghat), tree.leaves(ghat_ref)))
    check(all(close(a, b) for a, b in zip(tree.leaves(ghat), tree.leaves(ghat_ref))),
          f"{tag}: rank 0's ghat differs from the stacked step's beyond rtol 1e-6")
    opt.update(ghat_ref, opt0, params0, sched(i))  # params0 is now the stacked step's
    params_err = max(max_abs_err(a, b) for a, b in
                     zip(tree.leaves(state.params), tree.leaves(params0)))
    check(all(close(a, b) for a, b in zip(tree.leaves(state.params), tree.leaves(params0))),
          f"{tag}: rank 0's params differ from the stacked step's beyond rtol 1e-6")
    loss_err = abs(float(metrics["loss"]) - float(loss_ref))
    check(close(torch.as_tensor(metrics["loss"]), loss_ref),
          f"{tag}: loss {float(metrics['loss'])} against the stacked {float(loss_ref)}")
    check(all(row[:n_par] == table[0][:n_par] for row in table),
          f"{tag}: the params differ between ranks")
    size = world // (run.groups or world)
    for w in range(world):
        want = [d for p in paths for f in sorted(residues[p])
                for d in digest(residues[p][f][w // size])]
        check(table[w][n_par:n_par + n_res] == want,
              f"{tag}: rank {w}'s residues differ from the stacked step's row {w // size}")
    sent = [row[-len(SENT_KEYS):] for row in table]
    sent_mean = sum(x[0] for x in sent) / world
    check(sent_mean == planned, f"{tag}: the ranks counted {sent_mean} B a rank on average, "
                                f"the plan bills {planned}")
    return {"step": i, "mode": mode, "ghat_err": ghat_err, "params_err": params_err,
            "loss_err": loss_err, "sent_mean": sent_mean, "planned": planned,
            "sent": [x[0] for x in sent],
            "extra": {k: sum(x[j] for x in sent) / world
                      for j, k in enumerate(SENT_KEYS) if j},
            "near_ties": near, "gamma_err": gamma_err, "taps": taps, "residues": residues}


# the similarity taps that rank offsets: where the worker mean's rounding moves
# a near tie, they move
RANK_TAPS = ("hamming_d_over_k", "topk_energy_overlap", "spearman_rho")
TAP_TOL = dict(rtol=1e-5, atol=1e-6)


def taps_held(metrics: dict, stats: dict, tag: str) -> dict:
    """The group step's taps (rank 0's ``metrics``) against the stacked
    reduce's (``stats``) from the same state: the same ``obs/`` keys, every
    value within ``TAP_TOL`` but the rank-based similarity taps, which are
    counted where they move beyond it (and fail beyond 0.01)."""
    import torch

    got = {k: float(v) for k, v in metrics.items() if k.startswith("obs/")}
    want = {k: float(v) for k, v in stats.items() if k.startswith("obs/")}
    check(sorted(got) == sorted(want), f"{tag}: tap keys {sorted(set(got) ^ set(want))} differ "
                                       f"from the stacked reduce's")
    moved = ranked = 0
    worst = 0.0
    for key in got:
        a, b = torch.tensor(got[key]), torch.tensor(want[key])
        if any(f"obs/{name}{{" in key for name in RANK_TAPS):
            ranked += 1
            moved += not bool(torch.isclose(a, b, **TAP_TOL))
            check(abs(got[key] - want[key]) <= 0.01, f"{tag}: tap {key} {got[key]} against the "
                                                     f"stacked {want[key]}")
        else:
            check(bool(torch.isclose(a, b, **TAP_TOL)), f"{tag}: tap {key} {got[key]} against "
                                                        f"the stacked {want[key]}")
            worst = max(worst, abs(got[key] - want[key]) / max(abs(want[key]), 1e-30))
    return {"keys": len(got), "moved": moved, "ranked": ranked, "worst_rel": worst}


def ring_kernel_times(residues: dict, grads, run: RingRun, world: int) -> dict:
    """Device ms of one compressed step's ring kernels at one rank's shapes
    (the 17 compressed tensors of ``residues``, decoded, and their gradients
    ``grads``): the select (the leader's, or every rank's for local_topk;
    none for random_k), and every rank's ef_update and scatter (local_topk
    scatters the ``world`` gathered rows), each summed over the tensors,
    beside their byte bounds; with ``fused`` the leader's
    ``fused_select_update`` beside them. None for the exact path, which
    runs no kernel."""
    from repro_torch import tree
    from repro_torch.backends import resolve_backend
    from repro_torch.core.chunked import num_chunks
    from repro_torch.core.state import require_codec

    if run.exact:
        return None
    be = resolve_backend("cuda")
    codec = require_codec(run.codec)
    by_path = dict(tree.flatten_with_path(grads))
    lanes = world if run.compressor == "local_topk" else 1
    items = []
    for path, enc in sorted(residues.items()):
        g = by_path[path].reshape(-1)
        m = codec.decode(enc, (g.numel(),))[0]
        ef = m + g
        idx = be.select_indices(ef, CHUNK)
        _, vals = be.ef_update(m, g, idx, BETA, CHUNK)
        if lanes > 1:
            idx, vals = idx.expand(lanes, -1).contiguous(), vals.expand(lanes, -1).contiguous()
        items.append((m, g, ef, idx, vals))
    n = len(items)
    size = sum(m.numel() for m, *_ in items)
    rows = sum(num_chunks(m.numel(), CHUNK) for m, *_ in items)
    ms = {}
    if run.compressor != "random_k":
        ms["select"] = device_ms(lambda: [be.select_indices(ef, CHUNK) for _, _, ef, _, _ in items],
                                 (counter("chunk_argmax"), n), what="[ring] select x17")
    ms["ef_update"] = device_ms(lambda: [be.ef_update(m, g, idx[0] if lanes > 1 else idx, BETA,
                                                      CHUNK) for m, g, _, idx, _ in items],
                                (counter("ef_update"), n), what="[ring] ef_update x17")
    ms["scatter"] = device_ms(lambda: [be.scatter(vals, idx, CHUNK, m.numel())
                                       for m, _, _, idx, vals in items],
                              (counter("chunk_scatter"), n), what="[ring] scatter x17")
    if run.fused:
        ms["fused_select_update"] = device_ms(
            lambda: [be.fused_select_update(m, g, BETA, CHUNK) for m, g, *_ in items],
            (counter("fused_select_update"), n), what="[ring] fused_select_update x17")
    nbytes = {"select": 4 * size + 8 * rows, "ef_update": 12 * size + 8 * rows,
              "scatter": lanes * (4 * rows * CHUNK + 8 * rows),
              "fused_select_update": 12 * size + 8 * rows}
    return {"ms": ms, "bound": {k: bound(nbytes[k], 0)[0] for k in ms},
            "tensors": n, "elements": size}


def ring_dither_times(residues: dict, sc_cfg, run: RingRun, world: int):
    """Device ms and bytes of one step's stochastic-rounding draws on one
    rank (``train_step._row_dither`` for each compressed tensor: the whole
    (G, ...) stack drawn, this rank's row kept); None for a codec that
    rounds to nearest."""
    from repro_torch.core.state import require_codec
    from repro_torch.training import train_step as ts

    codec = require_codec(run.codec)
    G = run.groups or world
    storages = [(p, (int(enc["q"].shape[-1]),)) for p, enc in sorted(residues.items())]
    # the stored trailing size (padded for fp8_ec) draws the same shape
    draws = [ts._row_dither(codec, p, 0, G, 0, st, device="cuda") for p, st in storages]
    if draws[0] is None:
        return None
    sizes = [d.numel() for d in draws]
    ms = device_ms(lambda: [ts._row_dither(codec, p, 0, G, 0, st, device="cuda")
                            for p, st in storages], what="[ring] dither draws")
    nbytes = 4 * G * sum(sizes)
    return {"ms": ms, "bytes": nbytes, "row_bytes": 4 * sum(sizes), "bound": bound(nbytes, 0)[0]}


def ring_rank(rank: int, world: int, store: str, conn) -> None:
    """One spawned rank of ``ring_phase``: joins the gloo group through the
    ``file://`` store, runs (a) on the first ``RING_REDUCE_RANKS`` ranks,
    then (b) and every run of ``RING_RUNS`` on all, and sends its results to
    the parent. Any failure exits non-zero."""
    sys.path.insert(0, SRC)
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(RING_BACKEND, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RING_TIMEOUT_S))
    ready = time.time()
    reduce_group = dist.new_group(list(range(RING_REDUCE_RANKS)))
    out = {"ready": ready}
    if rank < RING_REDUCE_RANKS:
        out["reduce"] = ring_reduce_rank(rank, reduce_group)
    dist.barrier()
    torch.cuda.empty_cache()
    out["train"] = ring_train_rank(rank, world)
    out["runs"], out["run_s"] = [], []
    for run in RING_RUNS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["runs"].append(ring_train_rank(rank, world, run))
        out["run_s"].append(time.perf_counter() - t0)
    conn.send(out)
    conn.close()
    dist.destroy_process_group()


def ring_launches_held(run: RingRun, tr: list) -> dict:
    """Each rank's launches of ``run`` against its part: the select where it
    selects (``ring_leaders``), ef_update and chunk_scatter on every rank,
    once per compressed tensor and step, every select and scatter vec4;
    fused, the leader's select and ef_update one ``fused_select_update``
    (true_topk's on the key route); the exact path no kernel. Returns the
    launches summed over the ranks."""
    n_c, leaders = tr[0]["n_compressed"], tr[0]["leaders"]
    total = dict.fromkeys(KERNELS, 0)
    for r, x in enumerate(tr):
        want = dict.fromkeys(x["launches"], 0)
        selects = n_c * sum(r in ranks for ranks in leaders)
        if run.fused:
            want.update(fused_select_update=selects, ef_update=n_c * len(leaders) - selects,
                        chunk_scatter=n_c * len(leaders))
            route = "key" if run.compressor == "true_topk" else "sum"
            check(x["select_update_routes"] == {"sum": 0, "key": 0, route: selects},
                  f"[ring:{run.label}] {run.name}: rank {r}: fused_select_update routes "
                  f"{x['select_update_routes']}, want {route} on all {selects}")
        elif not run.exact:
            want.update(chunk_argmax=selects, ef_update=n_c * len(leaders),
                        chunk_scatter=n_c * len(leaders))
        check(x["launches"] == want, f"[ring:{run.label}] {run.name}: rank {r}: launches "
                                     f"{x['launches']}, want {want}")
        check(x["variants"] == {"chunk_argmax": want["chunk_argmax"],
                                "chunk_scatter": want["chunk_scatter"]},
              f"[ring:{run.label}] {run.name}: rank {r}: vec4 launches {x['variants']}, want "
              f"every one")
        for k in total:
            total[k] += x["launches"][k]
    return total


def ring_run_report(run: RingRun, tr: list, seconds: float, card_line: str) -> dict:
    """Prints what the ranks measured in one of ``RING_RUNS`` and returns its
    launches summed over the ranks."""
    import statistics as st

    tag = f"[ring:{run.label}] {run.name}"
    checks = tr[0]["checks"]
    for i in range(run.steps):
        rows = [x["steps"][i] for x in tr]
        c = checks[i]
        step = [x["step_ms"] for x in rows]
        kinds = {k: st.median(x["collective_ms"][k] for x in rows)
                 for k in CollectiveClock.KINDS}
        calls = rows[0]["collective_calls"]
        held = (f"ghat max abs err {c['ghat_err']:.3e}, params {c['params_err']:.3e}, loss "
                f"{c['loss_err']:.3e}")
        if c["mode"] == "scalecom":
            held += (", offsets (ghat's support) bitwise the stacked exact path's" if run.exact
                     else ", offsets bitwise rank 0's")
            if run.compressor == "true_topk" and not run.exact:
                held += f" but {sum(c['near_ties'])} near-tie chunks"
            if c["gamma_err"] is not None:
                held += f", contraction_gamma rel err {c['gamma_err']:.3e}"
            if c["taps"]:
                tp = c["taps"]
                held += (f", {tp['keys']} taps the stacked reduce's keys, the same on every "
                         f"rank, within rtol 1e-5 (worst rel err {tp['worst_rel']:.2e}) but "
                         f"{tp['moved']} of the {tp['ranked']} rank-based ones")
        print(f"{tag}: step {i} {c['mode']}: loss {rows[0]['loss']:.4f}; step ms max "
              f"{max(step):.1f} median {st.median(step):.1f} over {len(tr)} ranks; the gradient "
              f"pass {st.median(x['grads_ms'] for x in rows):.1f} ms; {sum(calls.values())} gloo "
              f"calls ({', '.join(f'{k} {v}' for k, v in calls.items() if v)}); collectives "
              f"host ms (median over ranks) "
              + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items() if v)
              + f" = {st.median(sum(x['collective_ms'].values()) for x in rows):.1f}"
              + f"; against the stacked step: {held}; residues bitwise on every rank"
              + (", group replicas bitwise" if run.groups else "")
              + f", params bitwise across ranks; on {card_line}")
    comp = [c for c in checks if c["mode"] == "scalecom"]
    extra = comp[0]["extra"]
    print(f"{tag}: payload a rank on average {comp[0]['sent_mean']:,.1f} B == the plan's "
          f"comm_bytes_per_worker {comp[0]['planned']:,.1f} B on all {len(comp)} compressed "
          f"steps (by rank " + " / ".join(f"{b:,}" for b in comp[0]["sent"]) + "); beside it, "
          f"outside the payload, a rank on average: oracle {extra['oracle']:,.0f} B, intra-group "
          f"{extra['intra']:,.0f} B, stats {extra['stats']:,.0f} B, telemetry "
          f"{extra['telemetry']:,.0f} B")
    launches = ring_launches_held(run, tr)
    km = tr[0]["kernel_ms"]
    kernel_line = ("no kernel (the exact path's dense top-k is torch.sort)" if km is None else
                   f"the reduce's kernels of one compressed step on rank 0 ({km['tensors']} "
                   f"tensors), device ms: " + ", ".join(
                       f"{k} {v:.4f} (bound {km['bound'][k]:.4f})" for k, v in km["ms"].items()))
    print(f"{tag}: launches per rank: " + "; ".join(
        f"rank {r} " + (", ".join(f"{k} {v}" for k, v in x["launches"].items() if v) or "none")
        for r, x in enumerate(tr)) + f"{'; all vec4' if km else ''}; {kernel_line}; on "
        f"{card_line}")
    dither = tr[0]["dither"]
    if dither:
        print(f"{tag}: the dither draw of one step on one rank, device ms {dither['ms']:.4f} for "
              f"{dither['bytes'] / 1e6:.1f} MB of int32 (the whole {run.groups or len(tr)}-row "
              f"stack; the rank keeps {dither['row_bytes'] / 1e6:.1f} MB), bound "
              f"{dither['bound']:.4f} ms; on {card_line}")
    print(f"{tag}: peak allocated GiB by rank " + " / ".join(f"{x['peak'] / 2**30:.2f}"
                                                            for x in tr)
          + f"; {seconds:.1f} s on rank 0 on {card_line}")
    return launches


def ring_phase(card_line: str) -> dict:
    """[ring]: ``RING_WORLD`` spawned ranks, each a process on the card,
    joined by gloo through a ``file://`` store in a temporary directory (the
    kernel library is built before they start, so no rank runs nvcc): (a)
    on ``RING_REDUCE_RANKS`` of them the tok_embed ring reduce
    (``ring_reduce_rank``), (b) on all of them the main path's training, one
    worker per rank (``ring_train_rank``), then each of ``RING_RUNS``. Each
    rank checks its part and exits non-zero on a failure; a rank that fails,
    or a phase that outlasts ``RING_PHASE_S``, fails the script. Prints what
    the ranks measured and returns the kernels' launches summed over the
    ranks in (b) and the runs."""
    import multiprocessing
    import statistics as st
    import tempfile
    from multiprocessing import connection

    import torch

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    build.library()
    print(f"[ring] backend {RING_BACKEND}: the machine has one card and NCCL puts one rank on a "
          f"card, so {RING_WORLD} ranks share it through gloo, whose broadcast, all_reduce and "
          f"all_gather take CUDA tensors and stage them through host memory; the collective "
          f"times below are that staging and loopback TCP between processes on one host, not "
          f"a network's")
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        pipes = [ctx.Pipe(duplex=False) for _ in range(RING_WORLD)]
        procs = [ctx.Process(target=ring_rank,
                             args=(r, RING_WORLD, os.path.join(tmp, "store"), pipes[r][1]))
                 for r in range(RING_WORLD)]
        t_spawn = time.time()
        deadline = time.monotonic() + RING_PHASE_S
        try:
            for p in procs:
                p.start()
            for _, send_end in pipes:
                send_end.close()
            while len(results) < RING_WORLD:
                left = deadline - time.monotonic()
                pending = [r for r in range(RING_WORLD) if r not in results]
                check(left > 0, f"[ring] ranks {pending} did not finish within "
                                f"{RING_PHASE_S} s")
                connection.wait([pipes[r][0] for r in pending] + [procs[r].sentinel
                                                                  for r in pending], left)
                for r in pending:
                    if pipes[r][0].poll():  # a result, or the end of a rank that died
                        procs[r].join(10)
                    check(procs[r].exitcode in (None, 0),
                          f"[ring] rank {r} failed (exit code {procs[r].exitcode})")
                    if pipes[r][0].poll():
                        results[r] = pipes[r][0].recv()
            for r, p in enumerate(procs):
                p.join(max(1.0, deadline - time.monotonic()))
                check(p.exitcode == 0, f"[ring] rank {r} exit code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    ready = max(res["ready"] for res in results.values()) - t_spawn

    # (a) the tok_embed ring reduce
    red = [results[r]["reduce"] for r in range(RING_REDUCE_RANKS)]
    nbytes = {"select": 4 * P + 8 * R, "ef_update": 12 * P + 8 * R, "scatter": 4 * P + 8 * R}
    print(f"[ring:reduce] {RING_REDUCE_RANKS} ranks ready {ready:.1f} s after the spawn; the "
          f"tok_embed tensor ({P:,} elements a rank, chunk {CHUNK}, beta {BETA}) at t = 0.."
          f"{RING_REDUCE_RANKS - 1}, each rank leading once: on every rank the cuda ring == the "
          f"torch ring (offsets, ghat, m'), bitwise; offsets and m' == the single-process "
          f"stacked cuda reduce of the same {RING_REDUCE_RANKS} rows, bitwise; ghat within the "
          f"rounding of a {RING_REDUCE_RANKS}-term fp32 sum in another order (max abs err "
          f"{max(x['max_abs_err'] for x in red):.3e}; {sum(x['outside_tol'] for x in red):,} of "
          f"{RING_REDUCE_RANKS * RING_REDUCE_RANKS * R:,} selected values outside rtol 1e-6 / "
          f"atol 1e-7, where the unit-scale values cancel)")
    for part, name in (("select", "chunk_argmax (the leader only)"), ("ef_update", "ef_update"),
                       ("scatter", "chunk_scatter")):
        ms = [x["device_ms"][part] for x in red]
        b = bound(nbytes[part], 0)[0]
        print(f"[ring:reduce] {name}, one rank's row, device ms by rank "
              + " / ".join(f"{v:.4f}" for v in ms) + f"; bound {b:.4f} ms "
              f"({nbytes[part] / 1e6:.1f} MB), {b / st.median(ms):.0%} of it at the median, "
              f"one rank at a time on {card_line}")
    off, val = red[0]["payload"]
    for kind, what in (("offsets", f"broadcast of the {off:,} B of offsets"),
                       ("values", f"all_reduce of the {val:,} B of values")):
        ms = [x["collective_ms"][kind] for x in red]
        print(f"[ring:reduce] {what}, host ms by rank (median of {RING_COLLECTIVE_REPS}, "
              f"between device syncs) " + " / ".join(f"{v:.3f}" for v in ms)
              + f" ({RING_BACKEND}, {RING_REDUCE_RANKS} ranks on one card) on {card_line}")

    # (b) training, one worker per rank
    tr = [results[r]["train"] for r in range(RING_WORLD)]
    checks = tr[0]["checks"]
    for i in range(STEPS):
        rows = [x["steps"][i] for x in tr]
        c = checks[i]
        step = [x["step_ms"] for x in rows]
        coll = [sum(x["collective_ms"].values()) for x in rows]
        calls = rows[0]["collective_calls"]
        grad_calls = calls["values"] + calls["dense"]
        print(f"[ring:train] step {i} {rows[0]['mode']}: loss {rows[0]['loss']:.4f}; step ms "
              f"max {max(step):.1f} median {st.median(step):.1f} over {RING_WORLD} ranks; "
              f"inside it (median over ranks) the gradient pass {st.median(x['grads_ms'] for x in rows):.1f} "
              f"ms, collectives {st.median(coll):.1f} ms host clock ({calls['offsets']} broadcasts, "
              f"{grad_calls} gradient all_reduces, {calls['metrics']} metric all_reduce); "
              f"held against the single-process stacked step from the same state and gradients: "
              f"ghat max abs err {c['ghat_err']:.3e}, params {c['params_err']:.3e}, loss "
              f"{c['loss_err']:.3e} (rtol 1e-6 / atol 1e-7), offsets bitwise rank 0's, residues "
              f"bitwise on every rank, "
              f"params bitwise identical across ranks; on {card_line}")
    dense = [c for c in checks if c["mode"] == "dense"]
    comp = [c for c in checks if c["mode"] == "scalecom"]
    per_rank = comp[0]["sent"]
    print(f"[ring:train] payload per compressed step: the ranks counted "
          + " / ".join(f"{b:,}" for b in per_rank) + f" B (the leader's with its offsets), "
          f"{comp[0]['sent_mean']:,.1f} B a rank on average == the plan's comm_bytes_per_worker "
          f"{comp[0]['planned']:,.1f} B on all {len(comp)} compressed steps; dense steps "
          f"{dense[0]['planned']:,.0f} B a rank; compressed / dense = 1 / "
          f"{dense[0]['planned'] / comp[0]['planned']:.1f}")
    d_coll = [st.median(x["steps"][c["step"]]["collective_ms"]["dense"] for x in tr)
              for c in dense]
    print(f"[ring:train] dense warm-up all-reduce ({dense[0]['planned'] / 1e6:.1f} MB a rank in "
          f"{tr[0]['steps'][0]['collective_calls']['dense']} all_reduces), host ms median over "
          f"ranks by step " + " / ".join(f"{v:.1f}" for v in d_coll) + f" on {card_line}")
    # launches per rank: the leader selects, every rank updates and scatters
    leaders = [t % RING_WORLD for t in range(RING_TRAIN.warmup, RING_TRAIN.steps)]
    ring_launches = ring_launches_held(RING_TRAIN, tr)
    print(f"[ring:train] launches per rank over the {len(leaders)} compressed steps (leaders "
          f"ranks {leaders}): " + "; ".join(
              f"rank {r} " + ", ".join(f"{k} {v}" for k, v in x["launches"].items() if v)
              for r, x in enumerate(tr)) + f"; all vec4; summed {ring_launches}")
    km = tr[0]["kernel_ms"]
    print(f"[ring:train] the reduce's kernels of one compressed step at one rank's shapes "
          f"({km['tensors']} tensors, {km['elements']:,} elements), device ms: "
          + ", ".join(f"{k} {v:.4f} (bound {km['bound'][k]:.4f})" for k, v in km["ms"].items())
          + f"; the leader {sum(km['ms'].values()):.4f}, any other rank "
          f"{km['ms']['ef_update'] + km['ms']['scatter']:.4f}; on rank 0 alone on {card_line}")
    print(f"[ring:train] peak allocated GiB by rank "
          + " / ".join(f"{x['peak'] / 2**30:.2f}" for x in tr)
          + f" (rank 0 also holds the stacked step) on {card_line}")

    # the other configurations of the group step
    for j, run in enumerate(RING_RUNS):
        launches = ring_run_report(run, [results[r]["runs"][j] for r in range(RING_WORLD)],
                                   results[0]["run_s"][j], card_line)
        for k in ring_launches:
            ring_launches[k] += launches[k]
    print(f"[ring] launches summed over the ranks and runs {ring_launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s wall on {card_line}")
    return ring_launches


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)  # a cut run still shows how far it got
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of the repository")
    # [arch]'s recurrentgemma-2b run takes most of the card's 79 GiB: the
    # caching allocator's fixed segments left 5.5 GiB reserved but unusable
    # beside 71.6 GiB allocated when it ran out; growable segments do not
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # the autotuner's launch cache, empty until [autotune] (which removes what it
    # writes): no cache in the home directory or from an earlier run decides a
    # block size; the directory goes when the script exits
    cache_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    os.environ["SCALECOM_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache_dir.name, "autotune.json")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on a CUDA card")
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name: str) -> None:
        """Seconds since the last mark, under ``name`` (the [time] line)."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    sys.path.insert(0, SRC)
    from repro_torch import kernels, tree
    from repro_torch.backends import resolve_backend
    from repro_torch.configs import registry
    from repro_torch.core.compressors import CompressorConfig, compress
    from repro_torch.core.plan import plan_tensors
    from repro_torch.core.rates import RateRule
    from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
    from repro_torch.core.state import ScaleComState, residue_bytes, residue_signature
    from repro_torch.data import make_batches
    from repro_torch.harness.invariants import check_buildup
    from repro_torch.kernels import build, chunk_topk as ct
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule
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
    print(f"[build] nvcc {build.build_info['seconds']:.1f} s -> {build.build_info['path']}")
    print_ptxas(build.build_info["ptxas"])
    mark("card and build")

    # -- 2. kernels against their plain versions -----------------------------
    results = kernel_phase(card_line)
    mark("[kernel]")

    # -- 2b. the fault harness: the preflight, the CLI's sweeps, card against CPU --
    harness_launches, harness_routes = harness_phase(card_line)
    mark("[harness]")

    # -- 3. the main path at full width, unfused then fused ---------------------
    cfg = registry.arch("paper-transformer-base")
    warmup, steps, workers = WARMUP, STEPS, 8
    model = build_model(cfg, compute_dtype="float32", loss_chunk=64)
    base_cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                              min_size=1024, warmup_steps=warmup, fused=False)
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(0.05), warmup)
    path_launches, step_ms = {}, {}

    def batches_fn():
        return make_batches(cfg.vocab, workers, 4, 128, seed=0)

    def train(sc_cfg, label):
        run = train_run(cfg, model, opt, sched, sc_cfg, workers, steps, label, card_line,
                        f"[train:{label}]")
        path_launches.update({k: n for k, n in run.launches.items() if n})
        step_ms[label] = run.step_ms
        return run

    train(base_cfg, "unfused")
    torch.cuda.empty_cache()
    sc_cfg = dataclasses.replace(base_cfg, fused=True)
    fused_run = train(sc_cfg, "fused")
    state, loop, batches = fused_run.state, fused_run.loop, fused_run.batches
    del fused_run

    # -- 4. teacher-forced reduce from the trained state -------------------------
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(batches).items()}
    (_, _, gpw), t_pw = host_ms(lambda: per_worker_grads(model, state.params, batch, workers))
    _, t_dense = host_ms(lambda: dense_grads(model, state.params, batch))
    print(f"[time] per_worker_grads ({workers} workers x 4 x 128 tokens): {t_pw:.1f} ms; "
          f"dense_grads (the same {workers * 4} x 128 tokens folded): {t_dense:.1f} ms "
          f"(host clock) on {card_line}")
    grads_phase(model, state.params, batch, workers, t_dense, card_line)
    trained = state.sc_state
    before = ScaleComState(
        residues={k: {"q": torch.zeros_like(v["q"])} for k, v in trained.residues.items()},
        t=warmup)
    flat_plans = plan_tensors(tuple((p, tuple(g.shape[1:]), workers)
                                    for p, g in tree.flatten_with_path(gpw)),
                              base_cfg, residue_signature(trained.residues))

    def reduce(cfg_r, sc_state=trained, label=None):
        out, ms = host_ms(lambda: scalecom_reduce(gpw, sc_state, cfg_r))
        if label:
            print(f"[reduce] {label}: {ms:.2f} ms (host clock) on {card_line}")
        return out

    def agree(a, b, label, near_ties=False):
        """ĝ and residues of two reduces: residues bitwise and ĝ to TOL on the
        chunks where both selected the same lanes; with ``near_ties`` a few
        chunks may select differently (counted), else none may."""
        flipped = total = 0
        by_path = dict(tree.flatten_with_path(a[0]))
        for path, gb in tree.flatten_with_path(b[0]):
            ga = by_path[path]
            check(bool(torch.isfinite(ga).all()), f"{label}: ghat {path} is not finite")
            if path not in b[1].residues:  # dense
                check(close(ga, gb), f"{label}: dense ghat {path} differs")
                continue
            pad = (-ga.numel()) % CHUNK
            ca = torch.nn.functional.pad(ga.reshape(-1), (0, pad)).view(-1, CHUNK)
            cb = torch.nn.functional.pad(gb.reshape(-1), (0, pad)).view(-1, CHUNK)
            qa = torch.nn.functional.pad(a[1].residues[path]["q"], (0, pad)).view(workers, -1, CHUNK)
            qb = torch.nn.functional.pad(b[1].residues[path]["q"], (0, pad)).view(workers, -1, CHUNK)
            same = ((ca != 0) == (cb != 0)).all(-1) & (qa == qb).all(-1).all(0)
            flipped += int((~same).sum())
            total += same.numel()
            check(close(ca[same], cb[same]), f"{label}: ghat {path} differs beyond rtol 1e-6")
        check(a[1].t == b[1].t, f"{label}: step counter")
        limit = max(8, total // 10_000) if near_ties else 0
        check(flipped <= limit, f"{label}: {flipped} of {total} chunks select differently")
        print(f"[reduce] {label}: residues bitwise, ghat within rtol 1e-6 / atol 1e-7; "
              f"{flipped} of {total} chunks select differently")

    # the unfused backends agree bit for bit, from the trained and a fresh state
    for label, sc_state in (("trained", trained), ("before-first-compressed", before)):
        out_c = reduce(dataclasses.replace(base_cfg, backend="cuda"), sc_state)
        out_t = reduce(dataclasses.replace(base_cfg, backend="torch"), sc_state)
        for (path, x), (_, y) in zip(tree.flatten_with_path(out_c[0]),
                                     tree.flatten_with_path(out_t[0])):
            check(torch.equal(x, y), f"{label}: ghat {path} differs between backends")
        for path, enc in out_t[1].residues.items():
            check(torch.equal(out_c[1].residues[path]["q"], enc["q"]),
                  f"{label}: residue {path} differs between backends")
        print(f"[reduce] unfused, {label} state (t={sc_state.t}): cuda backend == torch backend, "
              f"bitwise")
        del out_c, out_t

    # (a) fused against unfused on the cuda backend; (b) fused cuda against fused torch
    def cfg_of(name, fused, backend, rules=()):
        return dataclasses.replace(base_cfg, compressor=CompressorConfig(name, chunk=CHUNK),
                                   fused=fused, backend=backend, rate_rules=rules)

    for name in ("clt_k", "true_topk"):
        kernels.reset_launches()
        fused_c = reduce(cfg_of(name, True, "cuda"), label=f"{name} fused, cuda backend")
        check(kernels.launches()["fused_reduce"] == sum(not p.dense for p in flat_plans),
              f"{name}: fused reduce launches {kernels.launches()}")
        # the harness's build-up invariant over the compressed tensors of one reduce
        nnz = sum(int(torch.count_nonzero(g)) for p, g in zip(flat_plans, tree.leaves(fused_c[0]))
                  if not p.dense)
        k = sum(p.k for p in flat_plans if not p.dense)
        v = check_buildup(nnz / k, name, workers, CHUNK)
        check(v is None, f"{name} fused reduce from the trained state: {v}")
        print(f"[harness:full-width] {name} fused reduce from the trained state: nnz(ghat)/k = "
              f"{nnz:,}/{k:,} = {nnz / k:.6f} over {sum(not p.dense for p in flat_plans)} "
              f"compressed tensors, within check_buildup")
        unfused_c = reduce(cfg_of(name, False, "cuda"), label=f"{name} unfused, cuda backend")
        if name == "clt_k":
            agree(fused_c, unfused_c, "clt_k fused cuda vs unfused cuda")
        del unfused_c
        fused_t = reduce(cfg_of(name, True, "torch"), label=f"{name} fused, torch backend")
        agree(fused_c, fused_t, f"{name} fused cuda vs fused torch", near_ties=name == "true_topk")
        del fused_c, fused_t

    # the tok_embed tensor from the trained state: fused clt_k idx/vals == unfused, bitwise
    cuda_be, torch_be = resolve_backend("cuda"), resolve_backend("torch")
    path = "['tok_embed']"
    m_t, g_t = trained.residues[path]["q"], gpw["tok_embed"].reshape(workers, -1)
    lead = trained.t % workers
    idx, vals, m_new, ghat = cuda_be.fused_reduce(m_t, g_t, BETA, CHUNK, 1, "clt_k", lead)
    want_idx = cuda_be.select_indices(m_t + g_t, CHUNK)[lead]
    want_m, want_vals = cuda_be.ef_update(m_t, g_t, want_idx, BETA, CHUNK)
    check(equal(idx, want_idx) and equal(vals, want_vals) and equal(m_new, want_m),
          "tok_embed: fused clt_k idx/vals/m' differ from the unfused cuda path")
    check(close(ghat, cuda_be.scatter(torch.mean(vals, 0), idx, CHUNK, m_t.shape[-1])),
          "tok_embed: fused clt_k ghat differs from the unfused cuda path")
    # true_topk against the torch backend's composition: count the near ties
    fi = cuda_be.fused_reduce(m_t, g_t, BETA, CHUNK, 1, "true_topk")
    ti = torch_be.fused_reduce(m_t, g_t, BETA, CHUNK, 1, "true_topk")
    diff = fi[0] != ti[0]
    mean_mag = torch.mean(m_t + g_t, 0).abs().view(-1, CHUNK)
    a = mean_mag.gather(1, fi[0][:, None].long())[:, 0][diff]
    b = mean_mag.gather(1, ti[0][:, None].long())[:, 0][diff]
    check(bool(torch.allclose(a, b, rtol=1e-5, atol=0)),
          "tok_embed true_topk: an index differs without a near tie")
    print(f"[reduce] tok_embed: fused clt_k idx/vals/m' == unfused cuda, bitwise; true_topk "
          f"fused cuda vs torch composition: {int(diff.sum())} of {diff.numel()} indices "
          f"differ, all at near ties (|mean| within rtol 1e-5)")
    del fi, ti, mean_mag

    # (c) a rate rule putting the blocks' tensors at top-2: chunk_topm on the path
    rules = (RateRule(r"\['blocks'\]", CHUNK, 2),)
    rr_plans = plan_tensors(tuple((p, tuple(g.shape[1:]), workers)
                                  for p, g in tree.flatten_with_path(gpw)),
                            cfg_of("clt_k", False, "cuda", rules),
                            residue_signature(trained.residues))
    for fused in (False, True):
        kernels.reset_launches()
        rr_c = reduce(cfg_of("clt_k", fused, "cuda", rules),
                      label=f"rate rule blocks top-2, {'fused' if fused else 'unfused'}, cuda")
        got, want = kernels.launches(), expected_launches(rr_plans, fused, 1)
        check(got == want, f"rate rule: launches {got}, want {want}")
        if not fused:
            path_launches["chunk_topm"] = got["chunk_topm"]
            check(ct.chunk_topm.variants == {"vec4": got["chunk_topm"], "scalar": 0}
                  and ct.chunk_scatter.variants == {"vec4": got["chunk_scatter"], "scalar": 0},
                  f"rate rule: chunk_topm variants {ct.chunk_topm.variants}, chunk_scatter "
                  f"variants {ct.chunk_scatter.variants}, want vec4 only")
            print(f"[reduce] rate rule unfused: chunk_topm and chunk_scatter ran the vec4 variant "
                  f"on all {got['chunk_topm']} and {got['chunk_scatter']} launches")
        rr_t = reduce(cfg_of("clt_k", fused, "torch", rules))
        if fused:
            agree(rr_c, rr_t, "rate rule fused cuda vs fused torch")
        else:
            check(all(torch.equal(x, y) for (_, x), (_, y) in
                      zip(tree.flatten_with_path(rr_c[0]), tree.flatten_with_path(rr_t[0])))
                  and all(torch.equal(rr_c[1].residues[p]["q"], e["q"])
                          for p, e in rr_t[1].residues.items()),
                  "rate rule unfused: cuda backend differs from torch backend")
            print("[reduce] rate rule unfused: cuda backend == torch backend, bitwise")
        del rr_c, rr_t

    # the two selects and the scatter at the shapes of their path, summed per compressed step
    path_selects(flat_plans, rr_plans, workers, card_line)
    path_scatter(flat_plans, card_line)

    # -- 4b. compress() on the tok_embed EF gradient ------------------------------
    ef = m_t + g_t
    gathers = 0
    for name in ("clt_k", "true_topk", "local_topk", "random_k"):
        for topm in (1, 2):
            ccfg = CompressorConfig(name, chunk=CHUNK, topm=topm)
            kernels.reset_launches()
            out_c, ms_c = host_ms(lambda: compress(ef, trained.t, ccfg, cuda_be))
            n_gather = kernels.launches()["chunk_gather"]
            out_t, ms_t = host_ms(lambda: compress(ef, trained.t, ccfg, torch_be))
            check(n_gather == 1, f"compress {name} top-{topm}: {n_gather} chunk_gather launches")
            check(equal(out_c, out_t), f"compress {name} top-{topm}: cuda backend differs from torch")
            gathers += n_gather
            print(f"[compress] {name} top-{topm}: cuda == torch backend, bitwise; one chunk_gather; "
                  f"{ms_c:.2f} ms cuda, {ms_t:.2f} ms torch (host clock)")
            del out_c, out_t
    path_launches["chunk_gather"] = gathers
    vals_x, idx_x, dense_x = compress(ef, trained.t, CompressorConfig("clt_k", CHUNK, 1, exact=True))
    check(idx_x.shape == (P // CHUNK,) and vals_x.shape == (workers, P // CHUNK)
          and bool(torch.isfinite(dense_x).all()), "compress exact clt_k: shapes or values")
    print(f"[compress] exact clt_k: k = {idx_x.numel()}, finite")

    mark("main path, reduces, compress")

    # -- 6. the lossy residue codecs, remap, buckets, telemetry -------------------
    states = {"fp32": trained}
    for name in ("fp32",) + LOSSY:
        if name != "fp32":
            run = train(dataclasses.replace(sc_cfg, residue_dtype=name), f"fused {name}").state
            states[name], params = run.sc_state, run.params
            if name == "fp8":
                fp8_state = run  # for [checkpoint]
            del run
        else:
            params = state.params
        held = sum(enc_bytes(e) for e in states[name].residues.values())
        want = residue_bytes(params, workers, name, sc_cfg.min_size, sc_cfg.layout)
        check(held == want, f"{name}: the residues hold {held} bytes, residue_bytes says {want}")
        print(f"[train:fused {name}] the residues hold {held:,} bytes, as residue_bytes says")
        del params
        if name != "fp32":
            codec_reduces(gpw, states[name], dataclasses.replace(base_cfg, residue_dtype=name),
                          name, card_line)
            codec_times(states[name], flat_plans, name, card_line)
    codec_card_vs_cpu(m_t, trained.t)
    codec_table_card()
    remap_checks(states, workers)
    del states
    bucket_phase(gpw, trained, base_cfg, workers, card_line)
    telemetry_phase(gpw, trained, base_cfg, card_line)
    path_update(flat_plans, workers, card_line, results)

    mark("codecs, buckets, telemetry, [path]")

    # -- 6b. the launch-geometry autotuner on the main path -----------------------------
    autotune_phase(state.params, gpw, trained, base_cfg, flat_plans, workers, card_line, results)
    mark("[autotune]")
    print(f"[memory] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del gpw, ef, vals_x, idx_x, dense_x, m_new, vals, want_m, want_vals
    torch.cuda.empty_cache()

    # -- 7. microbatches, the telemetry recorder and checkpoints at full width ------
    microbatch_phase(model, opt, sched, sc_cfg, state.params, batch, batches_fn, flat_plans,
                     workers, warmup, steps, card_line)
    telemetry_run_phase(model, opt, sched, sc_cfg, batches_fn, flat_plans, workers, warmup,
                        steps, step_ms["fused"], card_line)
    checkpoint_phase(state, fp8_state, model, opt, sc_cfg, workers, card_line)
    del fp8_state
    torch.cuda.empty_cache()
    mark("microbatches, recorder, checkpoint")

    # -- 8. where a fused compressed step's time goes ------------------------------
    state, fp32_profile = profiled_step(loop, state, next(batches), steps, "[profile]", card_line)

    # -- 8b. the main path in the reference's mixed precision -------------------------
    del state, loop, batches, batch, trained, before
    del m_t, g_t, idx, ghat
    del reduce, agree  # reduce's default argument holds the trained residues
    gc.collect()
    torch.cuda.empty_cache()
    mark("[profile]")
    bf16_launches = bf16_phase(card_line, step_ms, fp32_profile)
    mark("[bf16]")

    # -- 9. remat against no remat (REMAT_RUNS), the model families at full width
    # (ARCH_RUNS), then in bf16 compute ------------------------------------------------
    remat_phase(card_line)
    mark("[remat]")
    arch_launches, arch_peaks = arch_phase(card_line)
    mark("[arch]")
    arch_bf16 = arch_bf16_phase(card_line, arch_peaks)
    arch_launches = {k: n + arch_bf16[k] for k, n in arch_launches.items()}
    mark("[arch:bf16]")

    # -- 10. serving every family at full width (SERVE_RUNS), then bf16 weights ----------
    serve_phase(card_line)
    mark("[serve]")
    serve_phase(card_line, BF16_SERVE_RUNS, "[serve:bf16]")
    mark("[serve:bf16]")

    # -- 11. real collectives: the ring reduce and one worker per rank -----------------
    ring_launches = ring_phase(card_line)
    mark("[ring]")
    print("[time] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {sum(phase_s.values()):.1f} (the interpreter's start and imports "
          f"before it not counted) on {card_line}")

    for name in ("chunk_argmax", "ef_update", "chunk_scatter", "fused_select_update"):
        check(ring_launches[name] > 0, f"{name} was never launched on the ring path")
    for name in KERNELS:
        if name in RING_ONLY:
            # its path is a process group's leader: launched in [ring:fused] alone
            check(path_launches.get(name, 0) == harness_launches[name] == arch_launches[name] == 0,
                  f"{name} launched outside the ring")
            results[name]["launches"] = ring_launches[name]
        else:
            check(path_launches.get(name, 0) > 0, f"{name} was never launched on the main path")
            results[name]["launches"] = (path_launches[name] + harness_launches[name]
                                         + bf16_launches[name])
        results[name]["bf16_launches"] = bf16_launches[name]
        results[name]["harness_launches"] = harness_launches[name]
        results[name]["arch_launches"] = arch_launches[name]
        results[name]["ring_launches"] = ring_launches[name]
    results["fused_reduce"]["harness_routes"] = harness_routes
    print(json.dumps({"kernels": [results[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
