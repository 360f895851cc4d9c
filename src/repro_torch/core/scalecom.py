"""ScaleCom Algorithm 1: the worker-axis gradient reduce.

The port of ``repro.core.scalecom``. ``scalecom_reduce``
replaces the dense data-parallel all-reduce: inputs are per-worker,
unreduced gradients stacked on a leading worker axis plus the
``ScaleComState``; the output is the dense reduced, sparsified gradient ĝ
every worker applies, and the updated state.

Plan / execute / launch:

  plan     ``core.plan.plan_tensors`` (cached per tree structure): per tensor
           the compressor after rate rules, the dense fallback, grouping,
           layout, storage/work shapes and wire bytes.
  execute  ``_execute``: Algorithm 1 over the plan's trailing-axis work view
           (flat is the single-row case), every chunked op through one
           KernelBackend, between the residue codec's decode and encode
           (``core.state``: fp32, bf16, fp8, fp8_ec; the lossy ones round
           stochastically with the draw of ``codec_key(path, t)``). On the
           "cuda" backend the inner loop is three kernel launches per
           tensor: worker-stacked select, fused Eq. 5 residue update, ĝ
           scatter. With ``fused`` (True, or "auto" and $SCALECOM_TORCH_FUSED
           set) clt_k and true_topk tensors take one ``fused_reduce`` launch
           instead; local_topk, random_k, the exact path and dense tensors
           keep the unfused path without a word.
  launch   optional buckets (``core.plan.plan_buckets``, ``core.overlap``):
           the tensors run bucket by bucket in reverse leaf order, on a
           side CUDA stream with ``overlap``. Launch order only: the result
           is bitwise the unbucketed one.

Telemetry: with ``telemetry=True`` the taps of ``repro_torch.obs.taps``
(wire bytes measured against the plan, gradient build-up, per-tensor
contraction gamma, codec roundtrip error, the fused-path facts, bucket
sizes and, every ``metrics_every`` steps, the similarity diagnostics of
``core.metrics``) come back as ``stats["obs/<key>"]``, under the JAX
package's key strings. They are 0-d tensors left on the device: the reduce
never waits for the card, and ĝ and the new state are bitwise those of
telemetry off.

Hierarchical mode: with ``groups=G < n`` the n/G workers of a group are
dense-averaged first and compression runs across the G groups; residues then
live per group (init the state with n_workers=G).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.backends import FUSABLE_MODES, resolve_backend, resolve_fused
from repro_torch.core import overlap
from repro_torch.core.compressors import CompressorConfig, compress, select_indices
from repro_torch.core.filter import lowpass_update
from repro_torch.core.metrics import residue_similarity_report
from repro_torch.core.plan import TensorPlan, plan_tensors
from repro_torch.core.state import ScaleComState, codec_key, require_codec, residue_signature
from repro_torch.obs import taps

__all__ = ["ScaleComConfig", "scalecom_reduce", "dense_reduce"]


@dataclasses.dataclass(frozen=True)
class ScaleComConfig:
    """ScaleCom configuration: the fields of ``repro.core.scalecom.ScaleComConfig``.

    compressor:    CompressorConfig (clt_k / true_topk / local_topk / random_k / none)
    beta:          low-pass discount (1.0 = classic error feedback)
    min_size:      tensors smaller than this are reduced densely
    residue_dtype: fp32 | bf16 | fp8 | fp8_ec (``core.state.CODECS``)
    layout:        "auto" ($SCALECOM_TORCH_LAYOUT, else flat) | "flat" | "rowwise"
    backend:       "auto" | "torch" | "cuda" | a KernelBackend instance
    fused:         True | False | "auto" ($SCALECOM_TORCH_FUSED decides at
                   call time, unset means off): the single-launch fused
                   reduce for clt_k and true_topk tensors
    groups:        ScaleCom worker count; None => every worker
    warmup_steps:  dense steps before compression (applied by the train loop)
    bucket_bytes:  dense-byte target of a launch bucket (25 MB); whether the
                   reduce is bucketed is ``scalecom_reduce(buckets=...)``
                   (default: $SCALECOM_TORCH_BUCKET_MB)
    overlap:       run the buckets on a side CUDA stream (``core.overlap``);
                   False runs them on the caller's stream. Same numerics.
    telemetry:     return the metric taps as ``stats["obs/..."]``
    metrics_every: with telemetry, sample the similarity diagnostics every
                   this many steps; 0 never
    rate_rules:    per-tensor rate rules (core.rates.RateRule), first match wins
    """

    compressor: CompressorConfig = CompressorConfig()
    beta: float = 1.0
    min_size: int = 2048
    residue_dtype: str = "fp32"
    layout: str = "auto"
    backend: Any = "auto"
    fused: Any = "auto"
    groups: Optional[int] = None
    warmup_steps: int = 0
    bucket_bytes: int = 25 << 20
    overlap: bool = True
    telemetry: bool = False
    metrics_every: int = 0
    rate_rules: Tuple = ()

    def __post_init__(self):
        require_codec(self.residue_dtype)
        if self.bucket_bytes <= 0:
            raise ValueError(
                f"bucket_bytes must be positive, got {self.bucket_bytes} "
                "(bucketing is toggled by scalecom_reduce(buckets=...) / "
                "$SCALECOM_TORCH_BUCKET_MB, not by zeroing the size)"
            )
        if self.groups is not None and self.groups < 1:
            raise ValueError(
                f"groups must be a positive worker-group count or None, got {self.groups}"
            )
        if self.metrics_every < 0:
            raise ValueError(
                f"metrics_every must be >= 0 (0 disables the similarity taps of "
                f"telemetry), got {self.metrics_every}"
            )
        if not (isinstance(self.fused, bool) or self.fused in (None, "auto")):
            raise ValueError(
                f"fused must be True, False, or 'auto' (then $SCALECOM_TORCH_FUSED "
                f"decides at call time); got {self.fused!r}"
            )

    def n_workers(self, data_ranks: int) -> int:
        return self.groups if self.groups is not None else data_ranks


def _group_fold(g: torch.Tensor, groups: int) -> torch.Tensor:
    """(n, ...) -> (G, ...): dense mean inside each group of n/G workers."""
    n = g.shape[0]
    if groups == n:
        return g
    if n % groups != 0:
        raise ValueError(f"{n} workers not divisible into {groups} groups")
    return torch.mean(g.reshape((groups, n // groups) + tuple(g.shape[1:])), dim=1)


def dense_reduce(grads_pw):
    """Baseline dense reduce: plain mean over the worker axis."""
    return tree.tree_map(lambda g: torch.mean(g, dim=0), grads_pw)


def _execute_exact(ef: torch.Tensor, t: int, comp: CompressorConfig, backend):
    """Dense top-k analysis path (comp.exact): the non-chunked ``compress``,
    each worker's own dense contribution for the Eq. 5 update, and the
    (vals, idx) payload for the taps."""
    vals, idx, ghat = compress(ef, t, comp, backend=backend)
    i = idx.long() if comp.name == "local_topk" else idx.long().expand(vals.shape)
    return ghat, torch.zeros_like(ef).scatter(1, i, vals), vals, idx


# the similarity taps, in the JAX package's order
_SIMILARITY_KEYS = (
    "pairwise_cosine_distance",
    "hamming_d_over_k",
    "topk_energy_overlap",
    "spearman_rho",
)


def _const(value: float, device) -> torch.Tensor:
    """A 0-d float32 tap value filled on the device (a copy from host
    memory would wait for the card)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _tap_execute(plan: TensorPlan, codec, ef, vals, idx, ghat, new_m, new_enc, t: int,
                 metrics_every: int) -> None:
    """One tensor's taps, as ``repro.core.scalecom._tap_execute``."""
    comp, G, dev = plan.comp, ef.shape[0], ef.device
    # wire bytes measured from the payload's shapes, against the plan's rule
    value_bytes = 4.0 * (vals.numel() // G)
    if comp.name == "local_topk":
        index_bytes = 4.0 * (idx.numel() // G)
    elif comp.name == "random_k":
        index_bytes = 0.0
    else:
        index_bytes = 4.0 * idx.numel() / G
    labels = dict(path=plan.path, compressor=comp.name)
    taps.tap("bytes_measured", _const(value_bytes + index_bytes, dev), **labels)
    taps.tap("bytes_planned", _const(plan.bytes_payload, dev), **labels)
    # gradient build-up: nnz(ĝ) against the k values each worker sent
    taps.tap("buildup_nnz", torch.count_nonzero(ghat).to(torch.float32), path=plan.path)
    taps.tap("buildup_k", _const(plan.k, dev), path=plan.path)
    # what the storage codec loses of the new residue this step
    m_stored = new_m.reshape((G,) + plan.storage)
    decoded = codec.decode(new_enc, plan.storage)
    taps.tap(
        "codec_roundtrip_err",
        torch.linalg.norm(decoded - m_stored) / torch.clamp_min(torch.linalg.norm(m_stored), 1e-30),
        path=plan.path, codec=codec.name,
    )
    # the similarity diagnostics every metrics_every steps (t is a host
    # int); unsampled steps give zeros under the same keys, as lax.cond does
    if metrics_every > 0 and G >= 2:
        sampled = t % metrics_every == 0
        if sampled:
            ef2 = ef.reshape(G, -1)
            rep = residue_similarity_report(ef2, max(1, min(plan.k, ef2.shape[1])))
            report = [rep[name] for name in _SIMILARITY_KEYS]
        else:
            report = [_const(0.0, dev) for _ in _SIMILARITY_KEYS]
        taps.tap("similarity_sampled", _const(1.0 if sampled else 0.0, dev), path=plan.path)
        for name, value in zip(_SIMILARITY_KEYS, report):
            taps.tap(name, value, path=plan.path)


def _execute(plan: TensorPlan, gw: torch.Tensor, enc, codec, beta: float, t: int,
             backend, compute_stats: bool, metrics_every: int = 0, fused: bool = False):
    """Algorithm 1 for one tensor over the plan's trailing-axis work view.

    gw: (G, *plan.shape) folded fp32 gradients. With ``fused`` a clt_k or
    true_topk tensor takes the backend's ``fused_reduce`` (one kernel launch
    on the "cuda" backend), and ``ef = m + g`` is built only when stats or
    taps ask for it. The new residue is encoded with the draw of
    ``codec_key(plan.path, t)``. Returns (ghat (*plan.shape), new_enc,
    ef_mean), ef_mean only when ``compute_stats``.
    """
    comp = plan.comp
    G = gw.shape[0]
    work = gw.reshape((G,) + plan.work)
    m = codec.decode(enc, plan.storage).reshape((G,) + plan.work)
    C = work.shape[-1]
    use_fused = fused and not comp.exact and comp.name in FUSABLE_MODES
    ef = None if use_fused else m + work
    if comp.exact:
        ghat, own, vals, idx = _execute_exact(ef, t, comp, backend)
        new_m = lowpass_update(m, work, own, beta)
    elif use_fused:
        leader = t % G if comp.name == "clt_k" else None
        idx, vals, new_m, ghat = backend.fused_reduce(
            m, work, beta, comp.chunk, comp.topm, comp.name, leader
        )
    else:
        idx = select_indices(ef, t, comp, backend)  # shared, or per worker
        # fused Eq. 5: one pass gives the residue update and each worker's values
        new_m, vals = backend.ef_update(m, work, idx, beta, comp.chunk, comp.topm)
        if comp.name == "local_topk":
            # union-average (gradient build-up): every worker scatters its own
            ghat = torch.mean(backend.scatter(vals, idx, comp.chunk, C, comp.topm), dim=0)
        else:
            vmean = torch.mean(vals, dim=0)  # the all-reduce of k values
            ghat = backend.scatter(vmean, idx, comp.chunk, C, comp.topm)
    if not (taps.active() or compute_stats):
        # read no more: freed before the encode's full-size temporaries (at a
        # vocabulary table over workers, each is GBs)
        m = ef = None
    new_enc = codec.encode(new_m.reshape((G,) + plan.storage), plan.storage,
                           key=codec_key(plan.path, t))
    if taps.active():
        if ef is None:
            ef = m + work  # telemetry only; the fused path skips it
        dev = ef.device
        taps.tap("fused", _const(1.0 if use_fused else 0.0, dev), path=plan.path,
                 compressor=comp.name)
        taps.tap("fused_launches",
                 _const(0.0 if comp.exact else (1.0 if use_fused else 3.0), dev), path=plan.path)
        _tap_execute(plan, codec, ef, vals, idx, ghat, new_m, new_enc, t, metrics_every)
    if compute_stats and ef is None:
        ef = m + work
    ef_mean = torch.mean(ef, dim=0).reshape(plan.shape) if compute_stats else None
    return ghat.reshape(plan.shape), new_enc, ef_mean


def scalecom_reduce(
    grads_pw,
    state: ScaleComState,
    cfg: ScaleComConfig,
    *,
    compute_stats: bool = False,
    buckets: Any = None,
) -> Tuple[Any, ScaleComState, Dict[str, Any]]:
    """Run Algorithm 1 on worker-stacked gradients.

    grads_pw: nested dict of (n_workers, *shape) tensors (unreduced).
    buckets:  launch granularity (``core.overlap.resolve_buckets``):
              None/"auto" reads $SCALECOM_TORCH_BUCKET_MB, False is
              unbucketed, True buckets at cfg.bucket_bytes, a number is a
              byte target, a tuple of ``core.plan.Bucket`` a prebuilt
              schedule. Bitwise the same result either way.
    Returns (ghat, new_state, stats): ghat has the un-stacked parameter
    shapes; stats holds ``comm_bytes_per_worker`` and ``comm_bytes_dense``
    (floats), with ``compute_stats`` ``contraction_gamma`` (a 0-d tensor on
    the device), and with ``cfg.telemetry`` one ``"obs/<key>"`` 0-d tensor
    per tap, keys sorted.
    """
    with taps.collect() if cfg.telemetry else contextlib.nullcontext() as collected:
        ghat, new_state, stats = _reduce(grads_pw, state, cfg, compute_stats, buckets,
                                         collected)
    for key in sorted(collected or ()):
        stats[f"obs/{key}"] = collected[key]
    return ghat, new_state, stats


def _reduce(grads_pw, state: ScaleComState, cfg: ScaleComConfig, compute_stats: bool,
            buckets: Any, collected):
    """The reduce body; ``collected`` is the open tap collector, or None."""
    codec = require_codec(cfg.residue_dtype)
    flat = tree.flatten_with_path(grads_pw)
    device = flat[0][1].device if flat else None
    backend = resolve_backend(cfg.backend, device)
    fused = resolve_fused(cfg.fused)
    plans = plan_tensors(
        tuple((p, tuple(g.shape[1:]), g.shape[0]) for p, g in flat),
        cfg,
        residue_signature(state.residues),
    )
    t = state.t

    def run_leaf(i: int):
        """One tensor -> (ghat leaf, new_enc, (sq_err, sq_all) or None)."""
        plan, g = plans[i], flat[i][1]
        gw = _group_fold(g.to(torch.float32), plan.groups)
        if plan.dense:
            return torch.mean(gw, dim=0).reshape(plan.shape).to(g.dtype), None, None
        want_ef = compute_stats or taps.active()
        ghat, new_enc, ef_mean = _execute(
            plan, gw, state.residues[plan.path], codec, cfg.beta, t, backend, want_ef,
            cfg.metrics_every, fused,
        )
        sums = None
        if want_ef:
            sq = (torch.sum((ef_mean - ghat) ** 2), torch.sum(ef_mean**2))
            taps.tap("contraction_gamma", sq[0] / torch.clamp_min(sq[1], 1e-30),
                     path=plan.path)
            if compute_stats:
                sums = sq
        return ghat.to(g.dtype), new_enc, sums

    results: list = [None] * len(flat)
    schedule = overlap.resolve_buckets(buckets, cfg, plans)
    if schedule is None:
        for i in range(len(flat)):
            results[i] = run_leaf(i)
    else:
        def run_bucket(b):
            if taps.active():
                taps.tap("bucket_staged_leaves", _const(len(b.leaf_ids), device),
                         bucket=b.index, overlap=cfg.overlap)
                taps.tap("bucket_bytes_dense", _const(b.bytes_dense, device), bucket=b.index)
                taps.tap("bucket_bytes_payload", _const(b.bytes_payload, device),
                         bucket=b.index)
            for i in b.leaf_ids:
                results[i] = run_leaf(i)

        caller = overlap.run_buckets(schedule, run_bucket, device, cfg.overlap)
        if caller is not None:
            overlap.hand_over([results, collected], caller)

    # accumulate in leaf order whatever the schedule: bucketed == unbucketed
    new_residues = dict(state.residues)
    ghat_leaves = []
    bytes_sent = bytes_dense = 0.0
    sq_err = sq_all = 0.0
    for plan, (ghat, new_enc, sums) in zip(plans, results):
        bytes_dense += plan.bytes_dense
        bytes_sent += plan.bytes_payload
        ghat_leaves.append(ghat)
        if new_enc is not None:
            new_residues[plan.path] = new_enc
        if sums is not None:
            sq_err = sq_err + sums[0]
            sq_all = sq_all + sums[1]

    stats: Dict[str, Any] = {
        "comm_bytes_per_worker": bytes_sent,
        "comm_bytes_dense": bytes_dense,
    }
    if compute_stats:
        # a clamp on the device, as jnp.maximum: no host sync
        stats["contraction_gamma"] = sq_err / torch.clamp_min(torch.as_tensor(sq_all), 1e-30)
    new_state = ScaleComState(residues=new_residues, t=t + 1)
    return tree.unflatten(grads_pw, ghat_leaves), new_state, stats
