"""The rank side of ``tests/test_torch_ring_group_paths.py``: one process per
ScaleCom worker, joined in a gloo group through a ``file://`` store.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only, runs torch on one thread, takes its job from the
parent's pipe (the residues as tensors, encoded by the port's codecs) and
runs every labelled group reduce of the job (``train_step._group_reduce``)
at every t with the others. Around each it
records the offsets each tensor's reduce ended with (``ring_steps``'
return, by tensor size), every ``torch.distributed`` call this rank made
(op, dtype, elements, whether async) and the calls of the fused variant's
wrapper and plain twin, and sends back numpy arrays and plain values. A
failure raises, and the process exits non-zero.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.core.state import ScaleComState
from repro_torch.distributed import ring
from repro_torch.kernels import fused_reduce as fr
from repro_torch.models.convert import residue_bits
from repro_torch.training import TrainState, shard_train_state
from repro_torch.training import train_step as ts

TIMEOUT_S = 120


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def sc_config(job: dict, case: dict) -> ScaleComConfig:
    comp = CompressorConfig(case.get("compressor", "clt_k"), chunk=job["chunk"],
                            exact=case.get("exact", False))
    return ScaleComConfig(compressor=comp, beta=job["beta"], min_size=job["min_size"],
                          residue_dtype=case.get("codec", "fp32"), groups=case.get("groups"),
                          backend=case.get("backend", "torch"), fused=case.get("fused", False),
                          layout="flat", overlap=case.get("overlap", True),
                          bucket_bytes=job["bucket_bytes"], telemetry=case.get("telemetry", False),
                          metrics_every=case.get("metrics_every", 0))


class Spies:
    """Inside ``with``: the offsets of every tensor's reduce (keyed by its
    size), this rank's collective calls in order, and the calls of the fused
    variant's wrapper and of its plain twin."""

    def __enter__(self):
        self.offsets, self.calls = {}, []
        self.fused = {"wrapper": 0, "plain": 0}
        self._real = (ts.ring_steps, dist.all_reduce, dist.broadcast, dist.all_gather,
                      fr.fused_select_update, fr.fused_select_update_plain)
        steps, all_reduce, broadcast, all_gather, wrapper, plain = self._real

        def ring_steps(g_local, *args, **kwargs):
            out = yield from steps(g_local, *args, **kwargs)
            self.offsets[int(g_local.shape[-1])] = _np(out[3])
            return out

        def logged(op, fn):
            def call(tensor, *args, **kwargs):
                x = args[0] if op == "all_gather" else tensor
                self.calls.append((op, str(x.dtype), int(x.numel()),
                                   bool(kwargs.get("async_op", False))))
                return fn(tensor, *args, **kwargs)
            return call

        def counted(key, fn):
            def call(*args, **kwargs):
                self.fused[key] += 1
                return fn(*args, **kwargs)
            return call

        ts.ring_steps = ring_steps
        dist.all_reduce = logged("all_reduce", all_reduce)
        dist.broadcast = logged("broadcast", broadcast)
        dist.all_gather = logged("all_gather", all_gather)
        fr.fused_select_update = counted("wrapper", wrapper)
        fr.fused_select_update_plain = counted("plain", plain)
        return self

    def __exit__(self, *exc):
        (ts.ring_steps, dist.all_reduce, dist.broadcast, dist.all_gather,
         fr.fused_select_update, fr.fused_select_update_plain) = self._real
        return False


def _group_reduces(job: dict, rank: int, world: int, group) -> dict:
    """Every labelled case's ``_group_reduce`` on this rank's row (its
    group's, with ``groups``) of the job's tree and residues, at each t."""
    out = {}
    grads = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in job["tree"].items()}
    for label, case in job["cases"].items():
        cfg = sc_config(job, case)
        groups = case.get("groups")
        hier = None if groups is None else ring.make_hierarchy(group, groups)
        rows = job["residues"][case.get("codec", "fp32"), groups]
        os.environ.update(case.get("env", {}))
        try:
            for t in job["ts"]:
                share = shard_train_state(TrainState({}, {}, ScaleComState(rows, t)), rank,
                                          world, groups)
                ring.reset_sent()
                with Spies() as spy:
                    ghat, new, got = ts._group_reduce(grads, share.sc_state, cfg, group, hier,
                                                      case.get("stats", False),
                                                      case.get("buckets", False))
                out[(label, t)] = {"ghat": {k: _np(v) for k, v in ghat.items()},
                                   "residues": residue_bits(new), "t": new.t,
                                   "stats": {k: float(v) for k, v in got.items()},
                                   "sent": dict(ring.sent), "offsets": spy.offsets,
                                   "calls": spy.calls, "fused": dict(spy.fused)}
        finally:
            for key in case.get("env", {}):
                del os.environ[key]
    return out


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    conn.send(_group_reduces(job, rank, world, dist.group.WORLD))
    dist.destroy_process_group()
