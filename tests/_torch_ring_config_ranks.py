"""The rank side of ``tests/test_torch_ring_configs.py``: one process per
ScaleCom worker, joined in a gloo group through a ``file://`` store.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only (the residues arrive as numpy arrays of ``ml_dtypes``
dtypes, which ``params_from_jax`` moves across by their bits), runs torch
on one thread, takes its job from the parent's pipe (the step's state
second) and puts JAX's draws in place of the port's: ``core.compressors.random_draw`` (random_k) and
``core.state.codec_dither`` (the lossy codecs' stochastic rounding) look the
requested (step, shape) up in the job, and a draw the job does not hold
raises. It then runs every ring, group-reduce and group-step case of the
job with the others and sends back numpy arrays and plain values. A failure
raises, and the process exits non-zero.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.backends.torch_backend import TorchBackend
from repro_torch.configs import registry
from repro_torch.core import compressors as tcomp
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.core.state import ScaleComState
from repro_torch.distributed import ring
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, residue_bits
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainState, build_train_step, shard_train_state
from repro_torch.training import train_step as ts

ARCH = "paper-transformer-base"
TIMEOUT_S = 120


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SpyBackend(TorchBackend):
    """The torch backend, keeping the offsets each ``ef_update`` runs at:
    the rank's offsets, whichever collective brought them."""

    def __init__(self):
        self.offsets = []

    def ef_update(self, m, g, idx, *args, **kwargs):
        self.offsets.append(idx.clone())
        return super().ef_update(m, g, idx, *args, **kwargs)


def _install_draws(job: dict) -> None:
    draws, dithers = job["draws"], job["dithers"]

    def random_draw(t, shape, device, high=None):
        return torch.from_numpy(draws[(int(t), tuple(shape), high)]).to(device)

    def codec_dither(key, shape, device):
        path, t = key
        return torch.from_numpy(dithers[(path, int(t), tuple(shape))]).to(device)

    tcomp.random_draw = random_draw
    tstate.codec_dither = codec_dither


def _reduce_cases(job: dict, rank: int, group) -> dict:
    """Every (compressor, size, topm, t) through ``ring.ring_reduce`` on this
    rank's row: the offsets it updated at, ĝ, m' and the counted bytes."""
    out = {}
    for name, size, topm in job["cases"]:
        cfg = CompressorConfig(name, chunk=job["chunk"], topm=topm)
        g = torch.from_numpy(job["g"][size][rank])
        m = torch.from_numpy(job["m"][size][rank])
        for t in job["ts"]:
            spy = SpyBackend()
            ring.reset_sent()
            ghat, m_new = ring.ring_reduce(g, m, t, cfg, job["beta"], group, spy)
            (idx,) = spy.offsets
            out[(name, size, topm, t)] = (_np(idx), _np(ghat), _np(m_new), dict(ring.sent))
    return out


def sc_config(job: dict, name: str, codec: str, groups) -> ScaleComConfig:
    return ScaleComConfig(compressor=CompressorConfig(name, chunk=job["chunk"]), beta=job["beta"],
                          min_size=job["min_size"], residue_dtype=codec, groups=groups,
                          backend="torch", fused=False, layout="flat")


def _group_reduces(job: dict, rank: int, world: int, group) -> dict:
    """Every labelled configuration's ``_group_reduce`` on this rank's row
    (its group's, with ``groups``) of the job's tree and residues, at each
    t: ĝ, the new residue's bits, the stats and the counted bytes."""
    out = {}
    grads = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in job["tree"].items()}
    for label, (name, codec, groups, stats) in job["reduces"].items():
        cfg = sc_config(job, name, codec, groups)
        hier = None if groups is None else ring.make_hierarchy(group, groups)
        rows = params_from_jax(job["residues"][label], "cpu")
        for t in job["ts"]:
            share = shard_train_state(TrainState({}, {}, ScaleComState(rows, t)), rank, world,
                                      groups)
            ring.reset_sent()
            ghat, new, got = ts._group_reduce(grads, share.sc_state, cfg, group, hier, stats)
            out[(label, t)] = {"ghat": {k: _np(v) for k, v in ghat.items()},
                               "residues": residue_bits(new), "t": new.t,
                               "stats": {k: float(v) for k, v in got.items()},
                               "sent": dict(ring.sent)}
    # every rank's rows of the fp8 residues, not this rank's: refused before
    # any collective
    try:
        ts._group_reduce(grads, ScaleComState(params_from_jax(job["residues"]["fp8"], "cpu"), 0),
                         sc_config(job, "clt_k", "fp8", None), group, None, False)
        out["not_my_row"] = None
    except ValueError as e:
        out["not_my_row"] = str(e)
    return out


def _group_steps(job: dict, rank: int, world: int, group) -> dict:
    """One dense and one scalecom group step (groups, fp8, compute_stats)
    from the job's state, then the refusal of a world that the groups do not
    divide."""
    model = build_model(registry.smoke(ARCH), loss_chunk=16)
    opt = make_optimizer("sgdm")
    sched = schedule.linear_warmup(schedule.constant(job["lr"]), 2)
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=job["chunk"]), beta=0.1,
                         min_size=job["min_size"], warmup_steps=2, backend="torch",
                         residue_dtype="fp8", groups=job["groups"], fused=False)
    out = {"step": {}}
    for mode in ("dense", "scalecom"):
        fn = build_train_step(model, opt, sched, cfg, n_workers=world, mode=mode, group=group,
                              compute_stats=True)
        state = TrainState(params_from_jax(job["params"], "cpu"),
                           {"m": params_from_jax(job["opt_m"], "cpu")},
                           ScaleComState(params_from_jax(job["residues"], "cpu"), job["t"]),
                           job["step"])
        ring.reset_sent()
        new, metrics = fn(shard_train_state(state, rank, world, job["groups"]), job["batch"])
        out["step"][mode] = {
            "params": {p: _np(v) for p, v in tree.flatten_with_path(new.params)},
            "m": {p: _np(v) for p, v in tree.flatten_with_path(new.opt_state["m"])},
            "residues": residue_bits(new.sc_state), "t": new.sc_state.t, "step": new.step,
            "metrics": {k: float(v) for k, v in metrics.items()}, "sent": dict(ring.sent),
        }
    bad = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=job["chunk"]),
                         min_size=job["min_size"], groups=3, fused=False)
    try:
        build_train_step(model, opt, sched, bad, n_workers=world, group=group)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    _install_draws(job)
    group = dist.group.WORLD
    result = {"ring": _reduce_cases(job["ring"], rank, group),
              "reduce": _group_reduces(job["reduce"], rank, world, group)}
    result.update(_group_steps(conn.recv(), rank, world, group))
    conn.send(result)
    dist.destroy_process_group()
