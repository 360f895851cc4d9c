"""The rank side of ``tests/test_torch_tp.py``: four processes joined in a
gloo group through a ``file://`` store, first as a (2 data, 2 model) grid,
then regrouped as (1 data, 4 model).

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only, runs torch on one thread, takes its job from the
parent's pipe, runs every case with the others and sends back numpy arrays
and plain values. A failure raises, and the process exits non-zero.
"""

import datetime
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.core.state import ScaleComState
from repro_torch.distributed import ring, sharding, tensor_parallel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import (
    gather_shards, params_from_jax, shards_from_jax, train_state_shard_from_jax,
)
from repro_torch.optim import make_optimizer, schedule
from repro_torch.optim.optimizer import Optimizer
from repro_torch.training import TrainState, build_train_step, shard_train_state
from repro_torch.training import train_step as ts

TIMEOUT_S = 120
CHUNK, BETA, MIN_SIZE, LR = 16, 0.1, 512, 0.05


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates the parameters in place."""
    return t.detach().cpu().numpy().copy()


def _flat_np(t) -> dict:
    return {p: _np(v) for p, v in tree.flatten_with_path(t)}


def _sc_cfg(**kw) -> ScaleComConfig:
    return ScaleComConfig(compressor=kw.pop("compressor", CompressorConfig("clt_k", chunk=CHUNK)),
                          beta=BETA, min_size=MIN_SIZE, backend="torch",
                          fused=kw.pop("fused", False), **kw)


def _model(arch: str):
    return build_model(registry.smoke(arch), compute_dtype="float32", loss_chunk=16)


def _jax_state(job: dict) -> SimpleNamespace:
    return SimpleNamespace(params=job["params"], opt_state={"m": job["opt_m"]},
                           sc_state=SimpleNamespace(residues={p: {"q": q} for p, q in
                                                              job["residues"].items()},
                                                    t=job["t"]),
                           step=job["step"])


def _steps(job: dict, mesh, fused: bool) -> list:
    """1 dense + 2 compressed tensor-parallel steps from the carried-across
    JAX state: after each, this rank's parameter slices, the ĝ slices its
    optimizer received, the metrics and the counted bytes."""
    model = _model(job["arch"])
    base = make_optimizer("sgdm")
    seen = []

    def update(grads, state, params, lr):
        seen.append(_flat_np(grads))
        return base.update(grads, state, params, lr)

    opt = Optimizer(base.init, update)
    state = train_state_shard_from_jax(_jax_state(job), model.logical_axes(), mesh, "cpu")
    out = []
    for mode, batch in zip(("dense", "scalecom", "scalecom"), job["batches"]):
        fn = build_train_step(model, opt, schedule.constant(LR), _sc_cfg(fused=fused),
                              n_workers=mesh.shape["data"], mode=mode, mesh=mesh)
        ring.reset_sent()
        tensor_parallel.reset_sent()
        state, metrics = fn(state, batch)
        out.append({"params": _flat_np(state.params), "ghat": seen.pop(),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "payload": ring.payload_sent(), "model_sent": dict(tensor_parallel.sent),
                    "model_calls": dict(tensor_parallel.calls)})
    whole = gather_shards(state.params, sharding.specs_for_axes(
        model.abstract_params(), model.logical_axes(), "tp", mesh), mesh)
    out[-1]["gathered"] = _flat_np(whole)
    return out


def _reduce(job: dict, mesh) -> dict:
    """The teacher-forced reduce: this rank's slice of its worker's
    gradient and residue (the job's whole ones) through ``_tp_reduce`` at
    each t; the offsets each part's reduce used, captured from
    ``train_step.ring_steps``, and the results."""
    shapes, axes = job["shapes"], job["axes"]
    abstract = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    layout = ts._tp_layout(abstract, axes, mesh)
    row = mesh.index("data")
    whole = TrainState({k: torch.zeros(s) for k, s in shapes.items()}, {},
                       ScaleComState({p: {"q": torch.from_numpy(q)} for p, q in
                                     job["residues"].items()}, 0), 0)
    mine = shard_train_state(whole, mesh=mesh, axes=axes)
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(abstract, axes, "tp", mesh)))
    grads = {k: sharding.shard_of(torch.from_numpy(g[row]), specs[f"['{k}']"], mesh)[None]
             for k, g in job["grads"].items()}
    captured = []
    real = ts.ring_steps

    def spy(*args, **kwargs):
        out = yield from real(*args, **kwargs)
        captured.append(_np(out[3]))
        return out

    out = {}
    ts.ring_steps = spy
    try:
        for t in job["ts"]:
            for fused in (False, True):
                captured.clear()
                ring.reset_sent()
                state = ScaleComState(mine.sc_state.residues, t)
                ghat, new, stats = ts._tp_reduce(grads, state, _sc_cfg(fused=fused), layout)
                out[(t, fused)] = {
                    "offsets": list(captured), "ghat": _flat_np(ghat),
                    "residues": {p: _np(e["q"]) for p, e in new.residues.items()},
                    "payload": ring.payload_sent(), "stats": {k: float(v) for k, v in
                                                              stats.items()}}
    finally:
        ts.ring_steps = real
    out["share"] = {p: _np(e["q"]) for p, e in mine.sc_state.residues.items()}
    return out


def _refusals(job: dict, mesh) -> dict:
    """Each configuration outside the slice: the error it raises (None if it
    ran a step)."""
    out = {}
    for label, arch, cfg_kw, step_kw, env in job["refusals"]:
        model = _model(arch)
        opt = make_optimizer("sgdm")
        os.environ.update(env)
        try:
            fn = build_train_step(model, opt, schedule.constant(LR), _sc_cfg(**cfg_kw),
                                  mode="scalecom",
                                  **{"n_workers": mesh.shape["data"], "mesh": mesh, **step_kw})
            whole = ts.init_train_state(model, opt, _sc_cfg(**cfg_kw),
                                        torch.Generator().manual_seed(0),
                                        n_workers=mesh.shape["data"], device="cpu")
            fn(shard_train_state(whole, mesh=mesh, axes=model.logical_axes()),
               job["batch"])
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
        finally:
            for key in env:
                del os.environ[key]
    return out


def _init_share(mesh) -> dict:
    """``init_train_state(mesh=...)`` against ``shard_train_state`` of the
    stacked init from the same generator state: the same slices and residue
    shapes."""
    model, opt, cfg = _model("starcoder2-3b"), make_optimizer("sgdm"), _sc_cfg()
    n = mesh.shape["data"]
    mine = ts.init_train_state(model, opt, cfg, torch.Generator().manual_seed(7), n_workers=n,
                               device="cpu", mesh=mesh)
    whole = ts.init_train_state(model, opt, cfg, torch.Generator().manual_seed(7), n_workers=n,
                                device="cpu")
    want = shard_train_state(whole, mesh=mesh, axes=model.logical_axes())
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(mine.params),
                                                 tree.leaves(want.params)))
    return {"params": same, "residues": {p: tuple(e["q"].shape) for p, e in
                                         mine.sc_state.residues.items()},
            "want": {p: tuple(e["q"].shape) for p, e in want.sc_state.residues.items()},
            "zero": all(not e["q"].any() for e in mine.sc_state.residues.values())}


def _attention(job: dict, mesh) -> dict:
    """starcoder2-3b SMOKE's loss and gradients with its parameters split
    over a model axis of 4 (half a kv head a rank), through the batched
    pass and plain autograd, the logical axes the layout splits, and the
    same pass unsplit on this rank."""
    model = _model("starcoder2-3b")
    specs = sharding.specs_for_axes(model.abstract_params(), model.logical_axes(), "tp", mesh)
    params = shards_from_jax(job["params"], specs, mesh, "cpu")
    whole = params_from_jax(job["params"], "cpu")
    batch = {k: torch.as_tensor(v) for k, v in job["batch"].items()}
    axis = ts._tp_layout(model.abstract_params(), model.logical_axes(), mesh).axis
    out = {"specs": _flat_spec(specs), "split": sorted(axis.split)}
    tensor_parallel.reset_sent()
    loss, _, grads = ts.per_worker_grads(model, params, batch, 1, tp=axis)
    out["vmap"] = (float(loss), _flat_np(tree.tree_map(lambda g: g[0], grads)))
    loss, _, grads = ts.dense_grads(model, params, {k: v[0:1] for k, v in batch.items()}, tp=axis)
    out["plain"] = (float(loss), _flat_np(grads))
    out["calls"] = dict(tensor_parallel.calls)
    loss, _, grads = ts.per_worker_grads(model, whole, batch, 1)
    out["whole"] = (float(loss), _flat_np(tree.tree_map(lambda g: g[0], grads)))
    return out


def _flat_spec(specs) -> dict:
    return {p: s for p, s in tree.flatten_with_path(specs)}


def _operators(job: dict, mesh) -> dict:
    """The vocabulary-parallel cross-entropy and embedding on this rank's
    vocabulary slice, with their gradients, plain and batched."""
    tp_group = mesh.group("model")
    index, size = mesh.index("model"), mesh.shape["model"]
    logits = torch.from_numpy(job["logits"])
    labels = torch.from_numpy(job["labels"])
    cols = logits.shape[-1] // size
    mine = logits[..., index * cols:(index + 1) * cols].clone()
    table = torch.from_numpy(job["table"])
    rows = table.shape[0] // size
    tab = table[index * rows:(index + 1) * rows].clone()
    tokens = torch.from_numpy(job["tokens"])
    tp = tensor_parallel.ModelAxis(tp_group, index, size, frozenset({"vocab"}))

    def xent(x, y):
        return torch.sum(tensor_parallel.vocab_xent(tp, x, y))

    def embed(w, ids):
        return torch.sum(tensor_parallel.vocab_embed(tp, w, ids, torch.float32) ** 2)

    x = mine.clone().requires_grad_(True)
    loss = xent(x, labels)
    (gx,) = torch.autograd.grad(loss, x)
    gv, lv = torch.func.vmap(torch.func.grad_and_value(xent), in_dims=(0, 0))(mine, labels)
    w = tab.clone().requires_grad_(True)
    e = embed(w, tokens)
    (gw,) = torch.autograd.grad(e, w)
    rows_out = tensor_parallel.vocab_embed(tp, tab, tokens, torch.float32)
    return {"xent": (float(loss.detach()), _np(gx)), "xent_vmap": (_np(lv), _np(gv)),
            "embed": (float(e.detach()), _np(gw), _np(rows_out))}


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    grid = make_test_mesh((2, 2))
    result = {"coords": dict(grid.coords)}
    result["steps"] = {arch: _steps(job["steps"][arch], grid, False) for arch in job["steps"]}
    result["fused"] = _steps(job["steps"][job["fused_arch"]], grid, True)
    result["reduce"] = _reduce(job["reduce"], grid)
    result["refusals"] = _refusals(job, grid)
    result["init"] = _init_share(grid)
    line = make_test_mesh((1, 4))
    result["line"] = dict(line.coords)
    result["attention"] = _attention(job["attention"], line)
    result["operators"] = _operators(job["operators"], line)
    conn.send(result)
    dist.destroy_process_group()
