"""Scale & failure scenarios: G ∈ {8..64} sweeps of ``scalecom_reduce`` under
injected faults, with per-step invariants.

The port of ``repro.harness.scenarios``. The runner simulates a
data-parallel fleet on one device: a deterministic per-worker gradient
stream (shared signal + worker-identity-keyed noise, so a worker's stream is
reproducible across membership changes), a virtual weight vector advanced
by the reduced ĝ, and a fault injector transforming what the reduce sees
(``repro_torch.harness.injectors`` — the reduce itself is the genuine
production entry point, numerics untouched, on the run's device: the
hand-written kernels on the card, their plain versions on the CPU).

Every faulted run is compared against its fault-free twin (cached per
configuration, device and fused setting) and checked per step by
``repro_torch.harness.invariants``: build-up stays bounded, trajectories
stay within codec tolerance, and the reported comm bytes match
``core.plan`` exactly.

Elastic re-plan
---------------
A membership change (dropped or rejoining worker) exercises the full elastic
path:

  1. the STALE plan is attempted first and must fail loudly — the plan-time
     divisibility guard (n no longer divisible into ``groups``, e.g. 64 -> 63)
     or the state-drift check (residue worker rows != the new fold) raises a
     named ValueError instead of a cryptic reshape inside ``_execute``;
  2. ``elastic_replan`` picks the largest feasible group count for the new
     world size and migrates the EF residues with ``core.state.remap_state``
     (mean-preserving worker-axis fold/expand), so no accumulated gradient
     mass is lost or double-counted;
  3. the next reduce re-plans automatically: the residue encoding signature
     is part of the plan-cache key, so stale cached plans cannot be reused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.backends import resolve_backend, resolve_fused
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.plan import plan_tensors
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import CODECS, init_state, remap_state, residue_signature
from repro_torch.device import resolve_device
from repro_torch.harness import injectors as inj
from repro_torch.harness import invariants

Pytree = Any
Device = Union[str, torch.device]

__all__ = [
    "ScenarioSpec",
    "ScenarioResult",
    "SCENARIOS",
    "TOY_SHAPES",
    "elastic_groups",
    "elastic_replan",
    "make_stream",
    "scenario_names",
    "run_scenario",
    "run_buildup_sweep",
]

# Toy parameter tree: two compressed matrices + one dense-fallback bias.
# Small enough that a G=64 sweep runs in seconds, large enough for hundreds
# of chunks per tensor.
TOY_SHAPES: Dict[str, Tuple[int, ...]] = {
    "wq": (24, 96),
    "mlp": (36, 80),
    "bias": (96,),
}
MIN_SIZE = 256  # bias stays dense, matrices carry EF residues
DEFAULT_CHUNK = 16

# the draws of make_stream, by kind (the reference's fold_in tags)
_BASE, _DRIFT, _NOISE = 0, 1, 2


def make_stream(
    world: int,
    seed: int = 0,
    sigma: float = 0.25,
    base_scale: float = 1.0,
    drift: float = 0.1,
    shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
    device: Device = "cuda",
) -> inj.Stream:
    """Deterministic per-worker gradient stream.

    g_i(t) = base_scale * (b0 + drift * b_t) + sigma * noise(i, t): a fixed
    shared direction ``b0`` (the true gradient — temporally correlated, as in
    real training, so a straggler's delayed gradient is NEAR the current one)
    with a small per-step drift, plus per-worker minibatch noise. Noise is
    drawn once per step for the FULL world and rows are selected by worker
    id, so a worker's contribution is identical whether or not other workers
    are present — membership changes never perturb survivors' streams.

    ``stream(t, active)`` is a pure function of its arguments: every draw
    comes from a CPU generator keyed by (seed, leaf, kind, t), the rows are
    taken by worker id and the result is moved to ``device``, so a
    straggler's re-draw is bitwise what that worker got at that step, and
    the card and the CPU see the same bytes.

    For the build-up sweep, pass ``sigma >> base_scale``: a noise-dominated
    stream makes workers' top-k selections near-independent, where the
    union-average model is tight.
    """
    shapes = dict(shapes or TOY_SHAPES)
    device = resolve_device(device)

    def stream(t: int, active: Tuple[int, ...]) -> Pytree:
        rows = torch.as_tensor(active, dtype=torch.int64)
        out = {}
        for i, (name, shape) in enumerate(sorted(shapes.items())):
            shape = tuple(shape)
            base = base_scale * (
                inj.keyed_normal(shape, seed, i, _BASE)
                + drift * inj.keyed_normal(shape, seed, i, _DRIFT, t)
            )
            noise = sigma * inj.keyed_normal((world,) + shape, seed, i, _NOISE, t)
            out[name] = (base[None] + noise[rows]).to(device)
        return out

    return stream


def elastic_groups(n: int, target: int) -> int:
    """Largest feasible hierarchical group count for ``n`` workers: the
    biggest divisor of n that does not exceed the configured target (64 -> 63
    with target 16 re-plans to 9 groups of 7)."""
    for d in range(min(target, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def elastic_replan(
    cfg: ScaleComConfig,
    state,
    new_n: int,
    residue_dtype: str,
    groups_target: Optional[int] = None,
) -> Tuple[ScaleComConfig, Any, Dict[str, Any]]:
    """Re-plan config + state for a changed world size (the step-2 half of the
    elastic path; the caller is expected to have seen the stale plan fail).

    Returns (new_cfg, new_state, info). The residue worker axis is folded /
    expanded mean-preservingly by ``remap_state``; hierarchical configs pick
    ``elastic_groups(new_n, target)`` where ``target`` defaults to the
    currently configured group count (pass the original target so a rejoin
    restores the original topology).
    """
    old_rows = None
    for enc in state.residues.values():
        old_rows = enc["q"].shape[0]
        break
    if cfg.groups is None:
        new_groups: Optional[int] = None
        new_rows = new_n
    else:
        new_groups = elastic_groups(new_n, groups_target or cfg.groups)
        new_rows = new_groups
    if old_rows is not None and old_rows != new_rows:
        state = remap_state(state, old_rows, new_rows, residue_dtype)
    new_cfg = dataclasses.replace(cfg, groups=new_groups)
    return new_cfg, state, {
        "new_n": new_n,
        "groups": new_groups,
        "rows_before": old_rows,
        "rows_after": new_rows,
    }


# ---------------------------------------------------------------------------
# scenario registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A named failure scenario: injector factory + trajectory tolerance.

    ``row_fault`` marks scenarios that perturb ONE residue worker-row: their
    blast radius is the row's weight in the worker mean, so the trajectory
    tolerance additionally scales by workers / residue_rows (1 for flat;
    workers/groups in hierarchical mode, where a row is a whole group).
    """

    name: str
    description: str
    tol_scale: float
    # (workers, steps) -> injector (None = fault-free)
    make: Callable[[int, int], Optional[inj.Injector]]
    row_fault: bool = False


SCENARIOS: Dict[str, ScenarioSpec] = {
    "baseline": ScenarioSpec(
        "baseline",
        "fault-free control: the faulted run IS the reference (distance 0)",
        1.0,
        lambda workers, steps: None,
    ),
    "straggler": ScenarioSpec(
        "straggler",
        "one worker contributes gradients delayed by 2 steps",
        1.5,
        lambda workers, steps: inj.StragglerInjector(
            worker=1 % workers, delay=2, start=min(3, steps - 1)
        ),
    ),
    "drop": ScenarioSpec(
        "drop",
        "the last worker leaves mid-run and rejoins (elastic re-plan + "
        "remap_state; 64 -> 63 hits the plan-time divisibility guard)",
        2.0,
        lambda workers, steps: inj.DropRejoinInjector(
            worker=workers - 1,
            drop_at=max(steps // 3, 1),
            rejoin_at=max(2 * steps // 3, 2),
        ),
    ),
    "stale": ScenarioSpec(
        "stale",
        "one worker's EF residue is reverted 3 steps (checkpoint-restore "
        "staleness); error feedback must re-absorb the delta",
        1.5,
        lambda workers, steps: inj.StaleResidueInjector(
            worker=1 % workers, at=max(steps // 2, 4), staleness=3
        ),
        row_fault=True,
    ),
    "corrupt": ScenarioSpec(
        "corrupt",
        "one residue row is overwritten with finite garbage; EF flushes it "
        "as one bounded ĝ perturbation",
        2.0,
        lambda workers, steps: inj.CorruptResidueInjector(
            worker=0, at=max(steps // 2, 3), scale=2.0
        ),
        row_fault=True,
    ),
}


def scenario_names(spec: str) -> List[str]:
    """The scenario names of ``spec``: "all" (every one of ``SCENARIOS``) or a
    comma list, as ``--scenarios`` and ``--preflight-scenarios`` take them."""
    if spec == "all":
        return list(SCENARIOS)
    return [s.strip() for s in spec.split(",") if s.strip()]


# ---------------------------------------------------------------------------
# the simulation loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScenarioResult:
    name: str
    workers: int
    groups: Optional[int]
    compressor: str
    residue_dtype: str
    steps: int
    records: List[Dict[str, Any]]
    replans: List[Dict[str, Any]]
    violations: List[str]
    final_distance: float
    max_distance: float
    tolerance: float
    mean_buildup: float

    @property
    def passed(self) -> bool:
        return not self.violations

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["passed"] = self.passed
        return d


def _leaf_sig(grads_pw: Pytree) -> Tuple:
    return tuple(
        (path, tuple(g.shape[1:]), g.shape[0]) for path, g in tree.flatten_with_path(grads_pw)
    )


def _flat_vector(t: Pytree) -> np.ndarray:
    return np.concatenate([x.detach().cpu().numpy().ravel() for x in tree.leaves(t)])


def _effective_weights(weights: Pytree, state, plans, residue_dtype: str, lr: float) -> Pytree:
    """w_eff = w - lr * mean-over-rows(decoded EF residues).

    Error feedback telescopes: sum_t ĝ(t) = mean_i sum_t g_i(t) - mean_i
    residue_i(T), so the *effective* trajectory w_eff(T) = -lr · Σ inputs
    exactly (up to codec roundtrip). Comparing faulted vs clean runs on
    w_eff measures precisely the gradient mass a fault lost, duplicated, or
    injected — not the benign re-timing of which index was delivered when.
    It is also the quantity ``remap_state``'s mean-preservation keeps
    continuous across an elastic re-plan.
    """
    codec = CODECS[residue_dtype]
    res_mean = {}
    for p in plans:
        if p.dense or p.path not in state.residues:
            continue
        m = codec.decode(state.residues[p.path], p.storage)
        res_mean[p.path] = torch.mean(m, dim=0).reshape(p.shape)
    eff = [
        w - lr * res_mean[path] if path in res_mean else w
        for path, w in tree.flatten_with_path(weights)
    ]
    return tree.unflatten(weights, eff)


def _simulate(
    cfg: ScaleComConfig,
    workers: int,
    steps: int,
    stream: inj.Stream,
    injector: Optional[inj.Injector],
    residue_dtype: str,
    lr: float,
    device: Device = "cuda",
) -> Tuple[List[np.ndarray], List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Run one stream through ``scalecom_reduce`` for ``steps`` steps on
    ``device`` (``stream`` must return tensors there).

    Returns (trajectory, per-step records, re-plan events). The injector owns
    membership and pre-step mutation; this loop owns the elastic re-plan
    reaction and the per-step measurements, read to the host after each
    reduce.
    """
    device = resolve_device(device)
    params = {
        k: torch.zeros(s, dtype=torch.float32, device=device)
        for k, s in sorted(TOY_SHAPES.items())
    }
    weights = params
    world = tuple(range(workers))
    state = init_state(
        params, cfg.n_workers(workers), residue_dtype, min_size=cfg.min_size,
        layout=cfg.layout,
    )
    orig_groups = cfg.groups
    prev_active = world
    traj: List[np.ndarray] = []
    records: List[Dict[str, Any]] = []
    replans: List[Dict[str, Any]] = []

    for t in range(steps):
        active = injector.membership(t, world) if injector else world
        if active != prev_active:
            # 1) the stale plan must fail LOUDLY at plan time (divisibility /
            #    state-drift guards) — record the message as evidence
            probe = stream(t, active)
            stale_error = None
            try:
                plan_tensors(
                    _leaf_sig(probe), cfg, residue_signature(state.residues)
                )
            except ValueError as e:
                stale_error = str(e)
            # 2) elastic re-plan: new groups + mean-preserving residue remap
            cfg, state, info = elastic_replan(
                cfg, state, len(active), residue_dtype, groups_target=orig_groups
            )
            replans.append({"t": t, "stale_plan_error": stale_error, **info})
            prev_active = active

        grads_pw = stream(t, active)
        ctx = inj.StepContext(
            t=t, active=active, grads_pw=grads_pw, state=state, notes={}
        )
        if injector:
            ctx = injector.inject(ctx, stream)

        plans = plan_tensors(
            _leaf_sig(ctx.grads_pw), cfg, residue_signature(ctx.state.residues)
        )
        ghat, state, stats = scalecom_reduce(ctx.grads_pw, ctx.state, cfg)
        if injector:
            injector.observe(t, state)
        weights = tree.tree_map(lambda w, g: w - lr * g, weights, ghat)
        traj.append(
            _flat_vector(
                _effective_weights(weights, state, plans, residue_dtype, lr)
            )
        )

        # measurements: build-up ratio + comm accounting, against the plans
        nnz = 0
        k_total = 0
        for plan, leaf in zip(plans, tree.leaves(ghat)):
            if not plan.dense:
                nnz += int(torch.count_nonzero(leaf))
                k_total += plan.k
        records.append(
            {
                "t": t,
                "n_active": len(active),
                "groups": cfg.groups,
                "comm_bytes": float(stats["comm_bytes_per_worker"]),
                "comm_planned": float(sum(p.bytes_payload for p in plans)),
                "nnz": nnz,
                "k": k_total,
                "buildup_ratio": nnz / k_total if k_total else 0.0,
                "G": cfg.n_workers(len(active)),
                **ctx.notes,
            }
        )
    return traj, records, replans


# fault-free reference trajectories, cached per full configuration and per
# what decides the numerics of a run: the device, the resolved fused
# setting and the resolved kernel backend
_CLEAN_CACHE: Dict[Tuple, List[np.ndarray]] = {}


def run_scenario(
    scenario: str,
    workers: int,
    *,
    steps: int = 12,
    compressor: str = "clt_k",
    chunk: int = DEFAULT_CHUNK,
    topm: int = 1,
    groups: Optional[int] = None,
    residue_dtype: str = "fp32",
    beta: float = 1.0,
    lr: float = 0.1,
    sigma: float = 0.25,
    base_scale: float = 1.0,
    seed: int = 0,
    device: Device = "cuda",
) -> ScenarioResult:
    """Run one named scenario at one world size and check every invariant."""
    spec = SCENARIOS[scenario]
    device = resolve_device(device)
    cfg = ScaleComConfig(
        compressor=CompressorConfig(compressor, chunk=chunk, topm=topm),
        beta=beta,
        min_size=MIN_SIZE,
        residue_dtype=residue_dtype,
        groups=groups,
    )
    stream = make_stream(workers, seed=seed, sigma=sigma, base_scale=base_scale,
                         device=device)
    injector = spec.make(workers, steps)

    sim_args = (cfg, workers, steps, stream, injector, residue_dtype, lr, device)
    traj, records, replans = _simulate(*sim_args)

    if injector is None:
        clean = traj  # the baseline control IS the reference
    else:
        ckey = (
            workers, steps, compressor, chunk, topm, groups, residue_dtype,
            beta, lr, sigma, base_scale, seed, str(device),
            resolve_fused(cfg.fused), resolve_backend(cfg.backend, device).name,
        )
        clean = _CLEAN_CACHE.get(ckey)
        if clean is None:
            clean, _, _ = _simulate(
                cfg, workers, steps, stream, None, residue_dtype, lr, device
            )
            _CLEAN_CACHE[ckey] = clean

    eps = 1e-12
    dists = [
        float(np.linalg.norm(f - c) / max(np.linalg.norm(c), eps))
        for f, c in zip(traj, clean)
    ]
    for r, d in zip(records, dists):
        r["distance"] = d

    violations: List[str] = []
    for r in records:
        v = invariants.check_comm_accounting(r["comm_bytes"], r["comm_planned"])
        if v:
            violations.append(f"step {r['t']}: {v}")
        v = invariants.check_buildup(
            r["buildup_ratio"], compressor, r["G"], chunk, topm
        )
        if v:
            violations.append(f"step {r['t']}: {v}")
    tol_scale = spec.tol_scale
    if spec.row_fault:
        tol_scale *= workers / cfg.n_workers(workers)
    v = invariants.check_trajectory(
        dists[-1], residue_dtype, tol_scale, label=f"{scenario}@n={workers}"
    )
    if v:
        violations.append(v)

    return ScenarioResult(
        name=scenario,
        workers=workers,
        groups=groups,
        compressor=compressor,
        residue_dtype=residue_dtype,
        steps=steps,
        records=records,
        replans=replans,
        violations=violations,
        final_distance=dists[-1],
        max_distance=max(dists),
        tolerance=invariants.codec_tolerance(residue_dtype, tol_scale),
        mean_buildup=float(
            np.mean([r["buildup_ratio"] for r in records if r["k"]])
        ),
    )


def run_buildup_sweep(
    workers_list: Tuple[int, ...] = (8, 16, 32, 64),
    *,
    steps: int = 4,
    chunk: int = DEFAULT_CHUNK,
    topm: int = 1,
    seed: int = 0,
    device: Device = "cuda",
) -> Dict[str, Any]:
    """Measure the gradient build-up curve: local_topk's O(n) growth vs
    clt_k's flat 1, against ``analysis.perfmodel.buildup_ratio_model``.

    Uses a noise-dominated stream (worker selections near-independent), where
    the independent-uniform union model is tight. Violations: clt_k off the
    flat curve, local_topk above the model bound, or local_topk failing to
    GROW with n while the model says it must.
    """
    from repro_torch.analysis.perfmodel import buildup_ratio_model

    rows: List[Dict[str, float]] = []
    violations: List[str] = []
    measured: Dict[int, float] = {}
    for n in workers_list:
        row: Dict[str, float] = {"workers": float(n)}
        for comp in ("clt_k", "local_topk"):
            res = run_scenario(
                "baseline", n, steps=steps, compressor=comp, chunk=chunk,
                topm=topm, sigma=1.0, base_scale=0.05, seed=seed, device=device,
            )
            row[comp] = res.mean_buildup
            violations.extend(res.violations)
        row["local_topk_model"] = buildup_ratio_model(n, chunk, topm)
        measured[n] = row["local_topk"]
        rows.append(row)

    n_lo, n_hi = min(workers_list), max(workers_list)
    if len(workers_list) > 1:
        model_growth = buildup_ratio_model(n_hi, chunk, topm) / buildup_ratio_model(
            n_lo, chunk, topm
        )
        got = measured[n_hi] / max(measured[n_lo], 1e-9)
        if got < 0.5 * model_growth:
            violations.append(
                f"build-up growth violation: local_topk measured "
                f"{measured[n_lo]:.2f} -> {measured[n_hi]:.2f} over n "
                f"{n_lo} -> {n_hi} (x{got:.2f}); the union-average model "
                f"predicts x{model_growth:.2f} — O(n) growth not observed"
            )
    return {"rows": rows, "violations": violations, "chunk": chunk, "topm": topm}
