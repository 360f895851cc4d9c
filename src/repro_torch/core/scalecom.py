"""ScaleCom Algorithm 1: the worker-axis gradient reduce.

The port of ``repro.core.scalecom``. ``scalecom_reduce``
replaces the dense data-parallel all-reduce: inputs are per-worker,
unreduced gradients stacked on a leading worker axis plus the
``ScaleComState``; the output is the dense reduced, sparsified gradient ĝ
every worker applies, and the updated state.

Plan / execute:

  plan     ``core.plan.plan_tensors`` (cached per tree structure): per tensor
           the compressor after rate rules, the dense fallback, grouping,
           layout, storage/work shapes and wire bytes.
  execute  ``_execute``: Algorithm 1 over the plan's trailing-axis work view
           (flat is the single-row case), every chunked op through one
           KernelBackend. On the "cuda" backend the inner loop is three
           kernel launches per tensor: worker-stacked select, fused Eq. 5
           residue update, ĝ scatter. With ``fused`` (True, or "auto" and
           $SCALECOM_TORCH_FUSED set) clt_k and true_topk tensors take one
           ``fused_reduce`` launch instead; local_topk, random_k, the exact
           path and dense tensors keep the unfused path without a word.

Hierarchical mode: with ``groups=G < n`` the n/G workers of a group are
dense-averaged first and compression runs across the G groups; residues then
live per group (init the state with n_workers=G).

Not ported yet, and refused with NotImplementedError rather than ignored:
lossy residue codecs, bucketed launch and telemetry taps (see ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.backends import FUSABLE_MODES, resolve_backend, resolve_fused
from repro_torch.core.compressors import CompressorConfig, compress, select_indices
from repro_torch.core.filter import lowpass_update
from repro_torch.core.plan import TensorPlan, plan_tensors
from repro_torch.core.state import ScaleComState, require_codec, residue_signature

__all__ = ["ScaleComConfig", "scalecom_reduce", "dense_reduce"]


@dataclasses.dataclass(frozen=True)
class ScaleComConfig:
    """ScaleCom configuration (the fields of ``repro.core.scalecom.ScaleComConfig``
    this slice runs).

    compressor:    CompressorConfig (clt_k / true_topk / local_topk / random_k / none)
    beta:          low-pass discount (1.0 = classic error feedback)
    min_size:      tensors smaller than this are reduced densely
    residue_dtype: "fp32" (lossy codecs are not ported)
    layout:        "auto" ($SCALECOM_TORCH_LAYOUT, else flat) | "flat" | "rowwise"
    backend:       "auto" | "torch" | "cuda" | a KernelBackend instance
    fused:         True | False | "auto" ($SCALECOM_TORCH_FUSED decides at
                   call time, unset means off): the single-launch fused
                   reduce for clt_k and true_topk tensors
    groups:        ScaleCom worker count; None => every worker
    warmup_steps:  dense steps before compression (applied by the train loop)
    telemetry:     metric taps; only False runs here
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
    telemetry: bool = False
    rate_rules: Tuple = ()

    def __post_init__(self):
        require_codec(self.residue_dtype)
        if self.groups is not None and self.groups < 1:
            raise ValueError(
                f"groups must be a positive worker-group count or None, got {self.groups}"
            )
        if not (isinstance(self.fused, bool) or self.fused in (None, "auto")):
            raise ValueError(
                f"fused must be True, False, or 'auto' (then $SCALECOM_TORCH_FUSED "
                f"decides at call time); got {self.fused!r}"
            )
        if self.telemetry:
            raise NotImplementedError(
                "telemetry=True: the metric taps are not ported yet "
                "(ROADMAP Queue 1 item 14, telemetry then the harness)"
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
    plus each worker's own dense contribution for the Eq. 5 update."""
    vals, idx, ghat = compress(ef, t, comp, backend=backend)
    i = idx.long() if comp.name == "local_topk" else idx.long().expand(vals.shape)
    return ghat, torch.zeros_like(ef).scatter(1, i, vals)


def _execute(plan: TensorPlan, gw: torch.Tensor, enc, codec, beta: float,
             t: int, backend, compute_stats: bool, fused: bool = False):
    """Algorithm 1 for one tensor over the plan's trailing-axis work view.

    gw: (G, *plan.shape) folded fp32 gradients. With ``fused`` a clt_k or
    true_topk tensor takes the backend's ``fused_reduce`` (one kernel launch
    on the "cuda" backend), and ``ef = m + g`` is built only when
    ``compute_stats`` asks for it. Returns (ghat (*plan.shape), new_enc,
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
        ghat, own = _execute_exact(ef, t, comp, backend)
        new_m = lowpass_update(m, work, own, beta)
    elif use_fused:
        leader = t % G if comp.name == "clt_k" else None
        _, _, new_m, ghat = backend.fused_reduce(
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
    new_enc = codec.encode(new_m.reshape((G,) + plan.storage), plan.storage)
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
    buckets:  None or False; the bucketed launch is not ported yet.
    Returns (ghat, new_state, stats): ghat has the un-stacked parameter
    shapes; stats holds ``comm_bytes_per_worker`` and ``comm_bytes_dense``
    (floats) and, with ``compute_stats``, ``contraction_gamma``.
    """
    if buckets not in (None, False):
        raise NotImplementedError(
            "bucketed launch is not ported yet (ROADMAP Queue 1 item 13, buckets and overlap)"
        )
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
    new_residues = dict(state.residues)
    ghat_leaves = []
    bytes_sent = bytes_dense = 0.0
    sq_err = sq_all = 0.0
    for plan, (_, g) in zip(plans, flat):
        gw = _group_fold(g.to(torch.float32), plan.groups)
        bytes_dense += plan.bytes_dense
        bytes_sent += plan.bytes_payload
        if plan.dense:
            ghat_leaves.append(torch.mean(gw, dim=0).reshape(plan.shape).to(g.dtype))
            continue
        ghat, new_enc, ef_mean = _execute(
            plan, gw, state.residues[plan.path], codec, cfg.beta, t, backend,
            compute_stats, fused,
        )
        new_residues[plan.path] = new_enc
        if compute_stats:
            sq_err = sq_err + torch.sum((ef_mean - ghat) ** 2)
            sq_all = sq_all + torch.sum(ef_mean**2)
        ghat_leaves.append(ghat.to(g.dtype))

    stats: Dict[str, Any] = {
        "comm_bytes_per_worker": bytes_sent,
        "comm_bytes_dense": bytes_dense,
    }
    if compute_stats:
        stats["contraction_gamma"] = sq_err / max(float(sq_all), 1e-30)
    new_state = ScaleComState(residues=new_residues, t=t + 1)
    return tree.unflatten(grads_pw, ghat_leaves), new_state, stats
