"""The rank side of ``tests/test_torch_ring.py``: one process per ScaleCom
worker, joined in a gloo group through a ``file://`` store.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only, runs torch on one thread, takes its job from the
parent's pipe, runs every ring and group-step case of the job with the
others, and sends back numpy arrays and plain values. A failure raises, and
the process exits non-zero.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.core.state import ScaleComState
from repro_torch.distributed import ring
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainState, build_train_step, shard_train_state

ARCH = "paper-transformer-base"
TIMEOUT_S = 120


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _flat_np(t) -> dict:
    return {p: _np(v) for p, v in tree.flatten_with_path(t)}


def _ring_cases(job: dict, rank: int, group) -> dict:
    """Every (size, topm, backend, t) of the job through ``make_ring_reducer``
    on this rank's row; the broadcast offsets are captured as they arrive."""
    captured = []
    real = dist.broadcast

    def spy(tensor, *args, **kwargs):
        out = real(tensor, *args, **kwargs)
        captured.append(tensor.clone())
        return out

    dist.broadcast = spy
    out = {}
    try:
        for size, topm in job["cases"]:
            cfg = CompressorConfig("clt_k", chunk=job["chunk"], topm=topm)
            g = torch.from_numpy(job["g"][size][rank:rank + 1])
            m = torch.from_numpy(job["m"][size][rank:rank + 1])
            for backend in job["backends"]:
                reducer = ring.make_ring_reducer(group, cfg, job["beta"], backend)
                for t in job["ts"]:
                    captured.clear()
                    ghat, m_new = reducer(g, m, t)
                    (idx,) = captured
                    out[(size, topm, backend, t)] = (_np(idx), _np(ghat), _np(m_new))
    finally:
        dist.broadcast = real
    return out


def _state(job: dict, device="cpu") -> TrainState:
    return TrainState(
        params=params_from_jax(job["params"], device),
        opt_state={"m": params_from_jax(job["opt_m"], device)},
        sc_state=ScaleComState(residues={p: {"q": torch.from_numpy(q)}
                                         for p, q in job["residues"].items()}, t=job["t"]),
        step=job["step"],
    )


def _sc_cfg(job: dict, chunk: int, **kw) -> ScaleComConfig:
    return ScaleComConfig(compressor=kw.pop("compressor", CompressorConfig("clt_k", chunk=chunk)),
                          beta=0.1, min_size=job["min_size"], warmup_steps=2, backend="torch",
                          **kw)


def _group_steps(job: dict, rank: int, world: int, group) -> dict:
    """One dense and one scalecom group step from the job's state; three
    steps (dense, scalecom, scalecom) for the cross-rank check; the counted
    bytes of a step at the main path's chunk; one scalecom step of each
    labelled configuration, or its refusal."""
    model = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(job["lr"]), 2)

    def steps(chunk, **kw):
        cfg = _sc_cfg(job, chunk)
        return {mode: build_train_step(model, opt, sched, cfg, n_workers=world, mode=mode,
                                       group=group, **kw)
                for mode in ("dense", "scalecom")}

    out = {"step": {}, "bytes": {}, "errors": {}, "cases": {}}
    fns = steps(job["chunk"])
    for mode, fn in fns.items():
        ring.reset_sent()
        new, metrics = fn(shard_train_state(_state(job), rank, world), job["batch"])
        out["step"][mode] = {
            "params": _flat_np(new.params), "m": _flat_np(new.opt_state["m"]),
            "residues": {p: _np(e["q"]) for p, e in new.sc_state.residues.items()},
            "t": new.sc_state.t, "step": new.step,
            "metrics": {k: float(v) for k, v in metrics.items()}, "sent": dict(ring.sent),
        }
    state = shard_train_state(_state(job), rank, world)
    for mode, batch in zip(("dense", "scalecom", "scalecom"), job["batches3"]):
        state, _ = fns[mode](state, batch)
    out["run3"] = _flat_np(state.params)
    for mode, fn in steps(64).items():
        ring.reset_sent()
        _, metrics = fn(shard_train_state(_state(job), rank, world), job["batch"])
        out["bytes"][mode] = (dict(ring.sent), metrics.get("comm_bytes_per_worker"),
                              metrics.get("comm_bytes_dense"))
    for label, cfg_kw, step_kw, env in job["cases"]:
        os.environ.update(env)
        try:
            fn = build_train_step(model, opt, sched, _sc_cfg(job, job["chunk"], **cfg_kw),
                                  mode="scalecom", group=group, **{"n_workers": world, **step_kw})
            ring.reset_sent()
            new, metrics = fn(shard_train_state(_state(job), rank, world), job["batch"])
            out["cases"][label] = {"params": _flat_np(new.params), "sent": dict(ring.sent),
                                   "metrics": {k: float(v) for k, v in metrics.items()}}
            out["errors"][label] = None
        except ValueError as e:
            out["errors"][label] = str(e)
        finally:
            for key in env:
                del os.environ[key]
    return out


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    group = dist.group.WORLD
    result = {"ring": _ring_cases(job["ring"], rank, group)}
    result.update(_group_steps(job["step"], rank, world, group))
    conn.send(result)
    dist.destroy_process_group()
