"""The rank side of ``tests/test_torch_tp_paths.py``: four processes joined
in a gloo group through a ``file://`` store, as a (2 data, 2 model) grid.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only (residues arrive as numpy arrays of ``ml_dtypes``
dtypes, moved across by their bits) and runs torch on one thread. It
counts the rounds ``ring.ring_steps`` yields for each compressor, exact
and not, on the data group; then puts JAX's random_k draws and
stochastic-rounding bits, which the job holds, in place of the port's
(``_torch_tp_config_ranks._install_draws``) and runs every labelled
``_tp_reduce`` of the first job at every t on its slice of the case's
tree, recording the offsets each tensor's reduce updated at
(``ring_steps``' and ``_tp_exact_steps``' returns, in the order they end),
every ``torch.distributed`` call it made (op, dtype, elements, async, and
the axis of its group), the counted bytes of both axes and the stats; then
the whole step of the second job. It sends back numpy arrays and plain
values. A failure raises, and the process exits non-zero.
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
from repro_torch.distributed import ring, sharding, tensor_parallel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, residue_bits, train_state_shard_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.optim.optimizer import Optimizer
from repro_torch.training import TrainState, build_train_step, shard_train_state
from repro_torch.training import train_step as ts
from _torch_tp_config_ranks import _install_draws

ARCH = "paper-transformer-base"
TIMEOUT_S = 120


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates the parameters in place."""
    return t.detach().cpu().numpy().copy()


def sc_config(job: dict, case: dict) -> ScaleComConfig:
    comp = CompressorConfig(case.get("compressor", "clt_k"), chunk=job["chunk"],
                            exact=case.get("exact", False))
    return ScaleComConfig(compressor=comp, beta=job["beta"], min_size=job["min_size"],
                          residue_dtype=case.get("codec", "fp32"), groups=case.get("groups"),
                          backend=case.get("backend", "torch"), fused=case.get("fused", False),
                          layout=case.get("layout", "flat"), overlap=case.get("overlap", True),
                          telemetry=case.get("telemetry", False),
                          metrics_every=case.get("metrics_every", 0))


class Spies:
    """Inside ``with``: the offsets of every tensor's reduce in the order
    the reduces end, keyed by the reduce and its input's shape, and this
    rank's collective calls in order, each
    (op, dtype, elements, async, axis) with the axis of its group named by
    ``axes`` (a process group -> "data", "model", "intra", "inter")."""

    def __init__(self, axes: dict):
        self.axes = axes

    def __enter__(self):
        self.offsets, self.calls = [], []
        self._real = (ts.ring_steps, ts._tp_exact_steps, dist.all_reduce, dist.broadcast,
                      dist.all_gather)
        steps, exact, all_reduce, broadcast, all_gather = self._real

        def offsets(fn, name, at):
            def spy(*args, **kwargs):
                out = yield from fn(*args, **kwargs)
                self.offsets.append(((name, tuple(args[at].shape)), _np(out[3])))
                return out
            return spy

        def logged(op, fn):
            def call(tensor, *args, **kwargs):
                x = args[0] if op == "all_gather" else tensor
                group = kwargs.get("group")
                self.calls.append((op, str(x.dtype), int(x.numel()),
                                   bool(kwargs.get("async_op", False)),
                                   next(name for g, name in self.axes.items() if g is group)))
                return fn(tensor, *args, **kwargs)
            return call

        ts.ring_steps = offsets(steps, "ring", 0)
        ts._tp_exact_steps = offsets(exact, "exact", 2)
        dist.all_reduce = logged("all_reduce", all_reduce)
        dist.broadcast = logged("broadcast", broadcast)
        dist.all_gather = logged("all_gather", all_gather)
        return self

    def __exit__(self, *exc):
        (ts.ring_steps, ts._tp_exact_steps, dist.all_reduce, dist.broadcast,
         dist.all_gather) = self._real
        return False


def _axes(mesh, hier) -> dict:
    out = {mesh.group("data"): "data", mesh.group("model"): "model"}
    if hier is not None:
        out.update({hier.intra: "intra", hier.inter: "inter"})
    return out


def _tree(job: dict, name: str, mesh):
    """A tree of the job: its layout on this rank, its shapes and logical
    axes, and this rank's slice of its worker's gradient row."""
    shapes, axes = job["trees"][name]["shapes"], job["trees"][name]["axes"]
    abstract = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(abstract, axes, "tp", mesh)))
    row = mesh.index("data")
    grads = {k: sharding.shard_of(torch.from_numpy(g[row]), specs[f"['{k}']"], mesh)[None]
             for k, g in job["trees"][name]["grads"].items()}
    return ts._tp_layout(abstract, axes, mesh), shapes, axes, grads


def _rounds(mesh) -> dict:
    """The rounds ``ring.ring_steps`` yields on this rank of the data group
    for each compressor, exact and not, at t = 0 (rank 0 leads)."""
    group = mesh.group("data")
    gen = torch.Generator().manual_seed(mesh.index("data"))
    g, m = torch.randn(256, generator=gen), torch.randn(256, generator=gen)
    out = {}
    for name in ("clt_k", "true_topk", "random_k", "local_topk"):
        for exact in (False, True):
            cfg = CompressorConfig(name, chunk=8, exact=exact)
            flight = ring.Flight([ring.ring_steps(g, m, 0, cfg, 0.1, group,
                                                  ts.resolve_backend("torch", "cpu"))], False)
            rounds = 0
            while flight.advance():
                rounds += 1
            out[(name, exact)] = rounds
    return out


def _reduces(job: dict, mesh) -> dict:
    """Every labelled case's ``_tp_reduce`` on this rank's slice of its
    worker's gradient row and of the stacked residues (its worker's row, or
    its group's), teacher-forced at each t."""
    trees = {name: _tree(job, name, mesh) for name in job["trees"]}
    out = {}
    for label, case in job["cases"].items():
        cfg = sc_config(job, case)
        groups = case.get("groups")
        hier = (None if groups is None else
                ring.make_hierarchy(mesh.group("data"), groups, lines=mesh.lines("data")))
        name = case.get("tree", "main")
        layout, shapes, axes, grads = trees[name]
        key = (name, case.get("codec", "fp32"), groups, case.get("layout", "flat"))
        whole = TrainState({k: torch.zeros(s) for k, s in shapes.items()}, {},
                           ScaleComState(params_from_jax(job["residues"][key], "cpu"), 0), 0)
        share = shard_train_state(whole, mesh=mesh, axes=axes, groups=groups)
        os.environ.update(case.get("env", {}))
        try:
            for t in job["ts"]:
                ring.reset_sent()
                tensor_parallel.reset_sent()
                with Spies(_axes(mesh, hier)) as spy:
                    ghat, new, got = ts._tp_reduce(
                        grads, ScaleComState(share.sc_state.residues, t), cfg, layout, hier,
                        case.get("stats", False), case.get("buckets", False))
                out[(label, t)] = {
                    "offsets": spy.offsets, "calls": spy.calls,
                    "ghat": {p: _np(v) for p, v in tree.flatten_with_path(ghat)},
                    "residues": residue_bits(new), "t": new.t,
                    "stats": {k: float(v) for k, v in got.items()}, "sent": dict(ring.sent),
                    "model_sent": dict(tensor_parallel.sent),
                    "model_calls": dict(tensor_parallel.calls)}
        finally:
            for k in case.get("env", {}):
                del os.environ[k]
    return out


def _ns(js: dict):
    from types import SimpleNamespace

    return SimpleNamespace(params=js["params"], opt_state={"m": js["opt_m"]},
                           sc_state=SimpleNamespace(residues=js["residues"], t=js["t"]),
                           step=js["step"])


def _step(job: dict, mesh) -> dict:
    """The whole step from the job's JAX state with buckets and telemetry:
    this rank's parameter slices, the ĝ slices its optimizer received and
    the metrics."""
    model = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    cfg = sc_config(job, job["case"])
    base, seen = make_optimizer("sgdm"), []

    def update(grads, state, params, lr):
        seen.append({p: _np(v) for p, v in tree.flatten_with_path(grads)})
        return base.update(grads, state, params, lr)

    state = train_state_shard_from_jax(_ns(job["state"]), model.logical_axes(), mesh, "cpu")
    fn = build_train_step(model, Optimizer(base.init, update), schedule.constant(job["lr"]), cfg,
                          n_workers=mesh.shape["data"], mesh=mesh, compute_stats=True,
                          buckets=job["case"]["buckets"])
    state, metrics = fn(state, job["batch"])
    return {"params": {p: _np(v) for p, v in tree.flatten_with_path(state.params)},
            "ghat": seen.pop(), "metrics": {k: float(v) for k, v in metrics.items()}}


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    grid = make_test_mesh((2, 2))
    result = {"coords": dict(grid.coords), "rounds": _rounds(grid)}  # the port's own draws
    job = conn.recv()
    _install_draws(job["draws"], job["dithers"])
    result["reduce"] = _reduces(job, grid)
    result["step"] = _step(conn.recv(), grid)
    conn.send(result)
    dist.destroy_process_group()
