"""The rank side of ``tests/test_torch_tp_families.py``: four processes
joined in a gloo group through a ``file://`` store, as a (2 data, 2 model)
grid for phi3.5-moe, kimi-k2 and rwkv6 SMOKE, then the first three as a
(1 data, 3 model) one for phi3.5-moe SMOKE (the fourth idles).

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only, runs torch on one thread, takes its job from the
parent's pipe, runs every case with the others and sends back numpy arrays
and plain values. A failure raises, and the process exits non-zero.
"""

import dataclasses
import datetime
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.distributed import ring, sharding, slices, tensor_parallel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (
    gather_shards, params_from_jax, residue_bits, train_state_from_shard,
    train_state_shard_from_jax,
)
from repro_torch.optim import make_optimizer, schedule
from repro_torch.optim.optimizer import Optimizer
from repro_torch.training import TrainState, build_train_step, shard_train_state
from repro_torch.training import train_step as ts

TIMEOUT_S = 120
CHUNK, BETA, MIN_SIZE, LR = 16, 0.1, 512, 0.05
MODES = ("dense", "scalecom", "scalecom")
BUCKET_BYTES = 256 << 10  # several buckets over a SMOKE model's ~3 MB of gradients
# a token whose K-th and (K+1)-th router probabilities differ by no more
# than this may route either way between two passes that round differently
NEAR_TIE_PROB = 1e-6
# run label: (ScaleComConfig fields, build_train_step keywords)
RUNS = {
    "plain": ({}, {}),
    "fused": ({"fused": True}, {}),
    "fp8": ({"residue_dtype": "fp8"}, {}),
    "buckets": ({}, {"buckets": BUCKET_BYTES}),
}


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates the parameters in place."""
    return t.detach().cpu().numpy().copy()


def _flat_np(t) -> dict:
    return {p: _np(v) for p, v in tree.flatten_with_path(t)}


def sc_cfg(**kw) -> ScaleComConfig:
    return ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                          min_size=MIN_SIZE, backend="torch", **kw)


def model_of(arch: str, overrides=None):
    """The arch's SMOKE model, with ``overrides`` of its config fields."""
    return build_model(dataclasses.replace(registry.smoke(arch), **(overrides or {})),
                       compute_dtype="float32", loss_chunk=16)


def _jax_state(job: dict, codec: str) -> SimpleNamespace:
    return SimpleNamespace(params=job["params"], opt_state={"m": job["opt_m"]},
                           sc_state=SimpleNamespace(residues=job["residues"][codec], t=job["t"]),
                           step=job["step"])


def _router_margins(model, whole, batch) -> list:
    """The tokens of ``batch`` at a router near tie, per MoE layer: a
    forward of the unsplit model on the whole parameters that records, for
    each token, the gap between its K-th and (K+1)-th router probabilities.
    Returns [(tokens at a near tie, least gap)] by layer."""
    seen = []
    real = tmoe.moe_ffn

    def recording(cfg, p, x, **kw):
        logits = x.reshape(-1, x.shape[-1]) @ p["router"]
        top = torch.topk(torch.softmax(logits, dim=-1), cfg.moe_topk + 1, dim=-1).values
        gap = top[:, -2] - top[:, -1]
        seen.append((int((gap <= NEAR_TIE_PROB).sum()), float(gap.min())))
        return real(cfg, p, x, **kw)

    tmoe.moe_ffn = recording
    try:
        with torch.no_grad():
            model.loss(whole, {k: v[0] for k, v in batch.items()})
    finally:
        tmoe.moe_ffn = real
    return seen


def _unsplit(model, whole, specs, mesh, batch, microbatches=1):
    """The unsplit pass on the whole parameters and this worker's row:
    (loss, this rank's slices of the gradients)."""
    loss, _, g = ts.per_worker_grads(model, whole, batch, 1, microbatches)
    return float(loss), {p: _np(sharding.shard_of(x[0], s, mesh)) for (p, x), s in
                         zip(tree.flatten_with_path(g), tree.leaves(specs))}


class _CallLog:
    """The model-axis collectives of the pass, in issue order, as (op,
    shape): every rank of a model group must issue the same ones."""

    def __init__(self):
        self.ops = []
        self.real = tensor_parallel._count

    def __enter__(self):
        def count(op, x):
            self.ops.append((op, tuple(x.shape)))
            return self.real(op, x)

        tensor_parallel._count = count
        return self

    def __exit__(self, *exc):
        tensor_parallel._count = self.real


def _run(job: dict, mesh, label: str) -> list:
    """1 dense + 2 compressed tensor-parallel steps of the run ``label``
    (``RUNS``) from the carried-across JAX state: after each, this rank's
    parameter slices, the ĝ slices its optimizer received, the metrics,
    the counted payload and model-axis calls; for the plain run also each
    compressed step's per-worker gradients, the microbatched pass's, the
    model-axis collectives in order and the router's near ties."""
    model = model_of(job["arch"], job.get("overrides"))
    cfg_kw, step_kw = RUNS[label]
    codec = cfg_kw.get("residue_dtype", "fp32")
    base = make_optimizer("sgdm")
    seen = []

    def update(grads, state, params, lr):
        seen.append(_flat_np(grads))
        return base.update(grads, state, params, lr)

    opt = Optimizer(base.init, update)
    abstract, axes = model.abstract_params(), model.logical_axes()
    specs = sharding.specs_for_axes(abstract, axes, "tp", mesh)
    state = train_state_shard_from_jax(_jax_state(job, codec), axes, mesh, "cpu")
    layout = ts._tp_layout(abstract, axes, mesh)
    out = []
    d = mesh.index("data")
    for mode, batch in zip(MODES, job["batches"]):
        rec = {}
        one = {k: torch.as_tensor(v[d:d + 1]) for k, v in batch.items()}
        if label == "plain":
            whole = gather_shards(state.params, specs, mesh)
            if model.cfg.arch_type == "moe":
                rec["margins"] = _router_margins(model, whole, one)
            if mode == "scalecom":
                rec["unsplit"] = _unsplit(model, whole, specs, mesh, one)
                rec["micro_unsplit"] = _unsplit(model, whole, specs, mesh, one, 2)
                loss, _, g = ts.per_worker_grads(model, state.params, one, 1, 2, tp=layout.axis)
                rec["micro"] = (float(loss), _flat_np(tree.tree_map(lambda x: x[0], g)))
            del whole
        leader = mode == "scalecom" and d == state.sc_state.t % mesh.shape["data"]
        before = state.sc_state.residues
        fn = build_train_step(model, opt, schedule.constant(LR), sc_cfg(**cfg_kw),
                              n_workers=mesh.shape["data"], mode=mode, mesh=mesh, **step_kw)
        real = ts.per_worker_grads

        def spy(*a, **k):
            # copies now: the step's reduce consumes the gradients
            loss, auxs, g = real(*a, **k)
            grads = dict(tree.flatten_with_path(g))
            if label == "plain":
                rec["grads"] = (float(loss), {k: _np(v) for k, v in auxs.items()},
                                {p: _np(x[0]) for p, x in grads.items()})
            if leader:  # the leader's ef (its residue slice + gradient slice), by leaf
                rec["ef"] = {}
                for i, path in enumerate(layout.paths):
                    if path in before:
                        m = slices.decode(slices.codec_name(before[path]), before[path],
                                          layout.slice(i), "flat")
                        m = m.reshape(1, -1)[:, :grads[path].numel()].reshape(grads[path].shape)
                        rec["ef"][path] = _np(m + grads[path])[0]
            taken.append(g)
            return loss, auxs, g

        taken = []
        ring.reset_sent()
        tensor_parallel.reset_sent()
        ts.per_worker_grads = spy
        try:
            with _CallLog() as log:
                state, metrics = fn(state, batch)
        finally:
            ts.per_worker_grads = real
        rec.update({"params": _flat_np(state.params), "ghat": seen.pop(),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "payload": ring.payload_sent(), "model_calls": dict(tensor_parallel.calls),
                    "ops": log.ops,
                    "consumed": all(x is None for t in taken for x in tree.leaves(t))})
        out.append(rec)
    return out


def _group_dense(job: dict) -> dict:
    """One dense step of the group step (``build_train_step(group=)``, one
    worker a rank over the whole world) from the carried-across JAX state:
    the parameters and metrics."""
    model = model_of(job["arch"])
    world = dist.get_world_size()
    whole = TrainState(params_from_jax(job["params"], "cpu"),
                       {"m": params_from_jax(job["opt_m"], "cpu")},
                       tstate.ScaleComState({p: {k: torch.as_tensor(v) for k, v in e.items()}
                                             for p, e in job["residues"]["fp32"].items()},
                                            job["t"]), job["step"])
    state = shard_train_state(whole, dist.get_rank(), world)
    fn = build_train_step(model, make_optimizer("sgdm"), schedule.constant(LR), sc_cfg(),
                          n_workers=world, mode="dense", group=dist.group.WORLD)
    state, metrics = fn(state, job["batches"][0])
    return {"params": _flat_np(state.params),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _round_trip(arch: str, mesh, overrides=None) -> dict:
    """Per codec: a whole stacked state (random parameters, residues of
    random values encoded by the codec, nearest rounding) through
    ``shard_train_state(mesh=)`` and back through ``train_state_from_shard``:
    whether the parameters and momentum come back bitwise and the rank's
    residue row bitwise the stacked row, every field."""
    model = model_of(arch, overrides)
    opt = make_optimizer("sgdm")
    n = mesh.shape["data"]
    specs = sharding.specs_for_axes(model.abstract_params(), model.logical_axes(), "tp", mesh)
    out = {}
    for codec in tstate.CODECS:
        cfg = sc_cfg(residue_dtype=codec, layout="flat")
        gen = torch.Generator().manual_seed(11)
        whole = ts.init_train_state(model, opt, cfg, gen, n_workers=n, device="cpu")
        sizes = {p: x.numel() for p, x in tree.flatten_with_path(whole.params)}
        residues = {p: tstate.CODECS[codec].encode(
            0.01 * torch.randn((n, sizes[p]), generator=gen), (sizes[p],))
            for p in whole.sc_state.residues}
        momentum = tree.tree_map(lambda x: torch.randn(x.shape, generator=gen),
                                 whole.opt_state["m"])
        whole = TrainState(whole.params, {**whole.opt_state, "m": momentum},
                           tstate.ScaleComState(residues, 3), 2)
        mine = shard_train_state(whole, mesh=mesh, axes=model.logical_axes())
        back = train_state_from_shard(mine, specs, mesh)
        want, got = residue_bits(whole.sc_state), residue_bits(back.sc_state)
        row = mesh.index("data")
        out[codec] = {
            "params": all(torch.equal(a, b) for a, b in zip(tree.leaves(whole.params),
                                                            tree.leaves(back.params))),
            "momentum": all(torch.equal(a, b) for a, b in zip(tree.leaves(momentum),
                                                              tree.leaves(back.opt_state["m"]))),
            "residues": sorted(want) == sorted(got) and all(
                sorted(want[p]) == sorted(got[p]) and all(
                    np.array_equal(want[p][k][row:row + 1], got[p][k]) for k in want[p])
                for p in want),
            "split": {p: [d for d, ax in enumerate(s) if ax == "model"]
                      for p, s in tree.flatten_with_path(specs)},
        }
    return out


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    grid = make_test_mesh((2, 2))
    result = {"coords": dict(grid.coords), "runs": {}, "round_trip": {}, "split": {}}
    for arch, arch_job in job["grid"].items():
        model = model_of(arch)
        result["split"][(arch, (2, 2))] = sorted(ts._tp_layout(
            model.abstract_params(), model.logical_axes(), grid).axis.split)
        for label in arch_job["runs"]:
            result["runs"][(arch, (2, 2), label)] = _run(arch_job, grid, label)
    for arch in job["round_trip"]:
        result["round_trip"][arch] = _round_trip(arch, grid)
    result["group_dense"] = _group_dense(job["group"])
    line = make_test_mesh((1, 3), subset=True)
    if line is not None:
        result["line"] = dict(line.coords)
        for arch, arch_job in job["line"].items():
            model = model_of(arch)
            result["split"][(arch, (1, 3))] = sorted(ts._tp_layout(
                model.abstract_params(), model.logical_axes(), line).axis.split)
            for label in arch_job["runs"]:
                result["runs"][(arch, (1, 3), label)] = _run(arch_job, line, label)
    conn.send(result)
    dist.barrier()
    dist.destroy_process_group()
