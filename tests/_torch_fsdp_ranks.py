"""The rank side of ``tests/test_torch_fsdp.py``: eight processes joined in a
gloo group through a ``file://`` store as a (2 pod, 2 data, 2 model) grid.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only, runs torch on one thread, takes its job from the
parent's pipe (then a second one: the reference's state for the other
configurations, with its draws), runs every case with the others and sends
back numpy arrays and plain values. A failure raises, and the process exits non-zero.
"""

import dataclasses
import datetime
import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from _torch_tp_config_ranks import _install_draws
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import compressors as tcomp
from repro_torch.core import state as state_codecs
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.distributed import fsdp, ring, sharding, slices, tensor_parallel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_shard_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.optim.optimizer import Optimizer
from repro_torch.training import TrainState, build_train_step, shard_train_state
from repro_torch.training import train_step as ts

TIMEOUT_S = 240
BETA, MIN_SIZE, LR = 0.1, 512, 0.05
GRID, AXES = (2, 2, 2), ("pod", "data", "model")
N = GRID[0]  # workers: one a pod
MODES = ("dense", "scalecom", "scalecom")
# the round trip of a residue row through two-cut blocks: (shape, logical
# axes); under fsdp on (2, 2, 2) "x" cuts dim 1 (40 -> 20) over "data" and
# dim 2 (24 -> 12) over "model": runs of 12 elements, so chunks of 16 and
# fp8's 512-blocks cross both edges; "y" (rowwise) cuts its last dim too
ROUND_TRIP = {"['x']": ((3, 40, 24), ("layers", "embed", "vocab")),
              "['y']": ((40, 24), ("embed", "vocab"))}


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates the parameters in place."""
    return t.detach().cpu().numpy().copy()


def _flat_np(t) -> dict:
    return {p: _np(v) for p, v in tree.flatten_with_path(t)}


def sc_cfg(chunk: int, codec: str = "fp32", fused: bool = False, **kw) -> ScaleComConfig:
    return ScaleComConfig(compressor=kw.pop("compressor", CompressorConfig("clt_k", chunk=chunk)),
                          beta=BETA, min_size=MIN_SIZE, residue_dtype=codec, backend="torch",
                          fused=fused, layout=kw.pop("layout", "flat"), **kw)


def model_of(arch: str, overrides=None):
    cfg = dataclasses.replace(registry.smoke(arch), **(overrides or {}))
    return build_model(cfg, compute_dtype="float32", loss_chunk=16)


def _jax_state(job: dict, codec: str) -> SimpleNamespace:
    return SimpleNamespace(params=job["params"], opt_state={"m": job["opt_m"]},
                           sc_state=SimpleNamespace(residues=job["residues"][codec], t=job["t"]),
                           step=job["step"])


def resident(state: TrainState) -> dict:
    """Bytes this rank holds of the parameters, the momentum and the
    residues."""
    def size(xs):
        return sum(x.numel() * x.element_size() for x in xs)

    return {"params": size(tree.leaves(state.params)),
            "momentum": size(tree.leaves(state.opt_state["m"])),
            "residues": size(v for e in state.sc_state.residues.values() for v in e.values())}


class _Spy:
    """Wraps ``train_step._tp_reduce``: the per-worker gradient blocks it
    was handed (after the data axis's reduce-scatter and division), copied
    before the reduce consumes them."""

    def __init__(self):
        self.grads = None
        self.real = ts._tp_reduce

    def __call__(self, grads, *args, **kw):
        self.grads = tree.tree_map(lambda g: g[0].detach().clone(), grads)
        return self.real(grads, *args, **kw)


def _logical(blocks: dict, specs: dict, mesh) -> dict:
    """This pod's logical tensors from its ranks' blocks (collective)."""
    return {p: _np(sharding.unshard(x, specs[p], mesh)) for p, x in blocks.items()}


def _steps(model, opt_base, state, batches, modes, cfg, mesh, specs, *, buckets=False,
           stats=False, watch=False):
    """The fsdp step over ``batches``: after each, this rank's parameter
    blocks, metrics, counted bytes and resident bytes; with ``watch`` at
    each compressed step the pod's logical per-worker gradient, its leader
    ef (residue + gradient) and ĝ, on its (data 0, model 0) rank."""
    seen = []

    def update(grads, st, params, lr):
        seen.append(grads)
        return opt_base.update(grads, st, params, lr)

    opt = Optimizer(opt_base.init, update)
    out = []
    spy = _Spy()
    shapes = {p: tuple(x.shape) for p, x in tree.flatten_with_path(model.abstract_params())}
    blocks = {p: slices.block_of(shapes[p], specs[p], mesh, ("data", "model")) for p in shapes}
    head = mesh.index("data") == 0 and mesh.index("model") == 0
    for mode, batch in zip(modes, batches):
        fn = build_train_step(model, opt, schedule.constant(LR), cfg, n_workers=N, mode=mode,
                              mesh=mesh, policy="fsdp", buckets=buckets, compute_stats=stats)
        before = {p: slices.decode(cfg.residue_dtype, e, blocks[p], "flat")
                  for p, e in state.sc_state.residues.items()} if watch else None
        ring.reset_sent()
        tensor_parallel.reset_sent()
        ts._tp_reduce = spy
        try:
            state, metrics = fn(state, batch)
        finally:
            ts._tp_reduce = spy.real
        rec = {"params": _flat_np(state.params),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "payload": ring.payload_sent(), "ring_sent": dict(ring.sent),
               "sent": dict(tensor_parallel.sent), "calls": dict(tensor_parallel.calls),
               "resident": resident(state)}
        ghat = seen.pop()
        if watch and mode == "scalecom":
            grads = dict(tree.flatten_with_path(spy.grads))
            g = _logical(grads, specs, mesh)
            own = _logical({p: before[p].reshape(grads[p].shape) + grads[p] for p in before},
                           specs, mesh)
            gh = _logical(dict(tree.flatten_with_path(ghat)), specs, mesh)
            if head:
                rec.update(grads=g, own_ef=own, ghat=gh)
        out.append(rec)
    return out, state


def _run(job: dict, mesh, codec: str, fused: bool, watch: bool) -> dict:
    model = model_of(job["arch"], job["overrides"])
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(
        model.abstract_params(), model.logical_axes(), "fsdp", mesh)))
    state = train_state_shard_from_jax(_jax_state(job, codec), model.logical_axes(), mesh, "cpu",
                                       policy="fsdp")
    first = resident(state)
    steps, _ = _steps(model, make_optimizer("sgdm"), state, job["batches"], MODES,
                      sc_cfg(job["chunk"], codec, fused), mesh, specs, watch=watch)
    return {"steps": steps, "resident0": first}


def _configs(job: dict, configs: list, mesh) -> dict:
    """Each configuration's 2 compressed fsdp steps from the reference's
    state after the paper run's dense step (``job``: its parameters,
    momentum, each codec's zero residues, and the reference's random_k
    draws and stochastic-rounding bits, which take the port's draws' place
    meanwhile), watched: the rank's blocks, and the pod's ĝ on its head."""
    model = model_of("paper-transformer-base")
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(
        model.abstract_params(), model.logical_axes(), "fsdp", mesh)))
    opt = make_optimizer("sgdm")
    real = tcomp.random_draw, state_codecs.codec_dither
    _install_draws(job["draws"], job["dithers"])
    out = {}
    try:
        for label, codec, fused, comp, kw in configs:
            cfg = sc_cfg(comp.chunk, codec, fused, compressor=comp)
            mine = train_state_shard_from_jax(_jax_state(job, codec), model.logical_axes(), mesh,
                                              "cpu", policy="fsdp")
            steps, _ = _steps(model, opt, mine, job["batches"], MODES[1:], cfg, mesh, specs,
                              buckets=kw.get("buckets", False), stats=kw.get("stats", False),
                              watch=True)
            out[label] = {"steps": steps}
    finally:
        tcomp.random_draw, state_codecs.codec_dither = real
    return out


def _double_backward(mesh):
    """The second-order pass through ``fsdp.copy_to_data`` over the data
    group, x the same on every rank and w, v this rank's own: d/dx <v,
    d/dx <w, copy(x)^2>> on this rank, and its closed form 2 (sum w) (sum
    v) over the group."""
    group = mesh.group("data")
    x = torch.linspace(-1.0, 1.0, 6, requires_grad=True)
    gen = torch.Generator().manual_seed(dist.get_rank())
    w, v = torch.rand(6, generator=gen), torch.rand(6, generator=gen)
    (g,) = torch.autograd.grad(torch.sum(w * fsdp.copy_to_data(x, group) ** 2), x,
                               create_graph=True)
    (h,) = torch.autograd.grad(torch.sum(v * g), x)
    sums = [t.clone() for t in (w, v)]
    for t in sums:
        dist.all_reduce(t, group=group)
    return _np(h), _np(2 * sums[0] * sums[1])


def _round_trip(mesh) -> dict:
    """A logical residue row of each ``ROUND_TRIP`` leaf cut to this rank's
    two-cut block, coded in every codec (nearest rounding, and the
    stacked draw's dither) in both layouts and joined back: the joined bits
    and the stacked codec's, and the block's decode and the stacked
    decode's block."""
    pieces = slices.grid_pieces(mesh, ("data", "model"))
    abstract = {p[2:-2]: torch.empty(s, device="meta") for p, (s, _) in ROUND_TRIP.items()}
    axes = {p[2:-2]: a for p, (_, a) in ROUND_TRIP.items()}
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(abstract, axes, "fsdp", mesh)))
    out = {}
    rng = np.random.default_rng(11)
    for path, (shape, _) in ROUND_TRIP.items():
        sl = slices.block_of(shape, specs[path], mesh, ("data", "model"))
        logical = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        logical.view(-1)[::97] *= 300.0  # blocks whose amax lies on another rank
        for layout in ("flat", "rowwise"):
            store = state_codecs.storage_shape(shape, layout)
            row = logical.reshape((1,) + store)
            for name in ("fp32", "bf16", "fp8", "fp8_ec"):
                codec = state_codecs.require_codec(name)
                for dithered in (False, True):
                    key = state_codecs.codec_key(path, 3)
                    full = state_codecs.row_dither(name, key, N, 1, store, "cpu") \
                        if dithered else None
                    want = codec.encode(row, store, key=full) if dithered else codec.encode(
                        row, store)
                    dither = slices.row_dither(name, key, N, 1, sl, layout, "cpu") \
                        if dithered else None
                    m = slices.cut("fp32", {"q": row}, sl, layout)["q"]
                    enc = slices.encode(name, m, sl, layout, dither, pieces)
                    joined = slices.join(name, enc, sl, layout, pieces)
                    dec = slices.decode(name, enc, sl, layout)
                    stacked = codec.decode(want, store).reshape(shape)
                    out[(path, layout, name, dithered)] = {
                        "joined": {k: _np(v.view(torch.uint8)) for k, v in joined.items()},
                        "want": {k: _np(v.view(torch.uint8)) for k, v in want.items()},
                        "decoded": _np(dec).reshape(-1),
                        "stacked_block": _np(sl.cut(stacked)).reshape(-1),
                        "cut_back": {k: _np(v.view(torch.uint8)) for k, v in slices.join(
                            name, slices.cut(name, want, sl, layout), sl, layout,
                            pieces).items()},
                        "crossing": sl.crosses(layout), "cuts": len(sl.cuts)}
    return out


def _refusals(job: dict, refusals: list, mesh) -> dict:
    """Each configuration the fsdp step refuses: the error it raises (None
    if it built and ran a step)."""
    model = model_of(job["arch"])
    opt = make_optimizer("sgdm")
    out = {}
    for label, cfg_kw, step_kw in refusals:
        try:
            fn = build_train_step(model, opt, schedule.constant(LR), sc_cfg(16, **cfg_kw),
                                  mesh=mesh, policy="fsdp", **{"n_workers": N, **step_kw})
            state = train_state_shard_from_jax(_jax_state(job, "fp32"), model.logical_axes(),
                                               mesh, "cpu", policy="fsdp")
            fn(state, job["batches"][1])
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    mesh = make_test_mesh(GRID, AXES)
    result = {"rank": rank, "coords": dict(mesh.coords), "runs": {}}
    for key, (arch_chunk, codec, fused, watch) in job["runs"].items():
        result["runs"][key] = _run(job["archs"][arch_chunk], mesh, codec, fused, watch)
    config_job = conn.recv()
    config_job["batches"] = job["archs"][job["configs_arch"]]["batches"][1:]
    result["configs"] = _configs(config_job, job["configs"], mesh)
    result["round_trip"] = _round_trip(mesh)
    result["double_backward"] = _double_backward(mesh)
    result["refusals"] = _refusals(job["archs"][job["configs_arch"]], job["refusals"], mesh)
    conn.send(result)
    dist.barrier()
    dist.destroy_process_group()
    conn.close()
    assert math.prod(GRID) == world


def _same_bits(a, b) -> bool:
    """Whether two TrainStates hold the same leaves, bit for bit."""
    from repro_torch.checkpoint.checkpoint import _flatten

    la, lb = _flatten(a), _flatten(b)
    if [k for k, _ in la] != [k for k, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            n = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
            if x.dtype != y.dtype or not torch.equal(x.view(n), y.view(n)):
                return False
        elif x != y:
            return False
    return True


def checkpoint_main(rank: int, world: int, store: str, conn) -> None:
    """The rank side of ``tests/test_torch_sharded_checkpoint.py``: for each
    codec, this rank's share of the job's stacked state on a (2, 2) tp
    grid (the world's first 4 ranks) and on the (2, 2, 2) fsdp grid, saved
    with ``checkpoint.save_sharded`` into the job's directories and read
    back with ``restore_sharded``: whether the share came back bit for
    bit, and what ``save_sharded`` returned."""
    from repro_torch import checkpoint
    from repro_torch.models.convert import params_from_jax, state_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    meshes = {"tp": make_test_mesh((2, 2), ("data", "model"), subset=True),
              "fsdp": make_test_mesh(GRID, AXES)}
    model = model_of(job["arch"])
    out = {}
    for codec, js in job["states"].items():
        def whole():
            return TrainState(params_from_jax(js["params"], "cpu"),
                              {"m": params_from_jax(js["opt_m"], "cpu")},
                              state_from_jax(SimpleNamespace(residues=js["residues"], t=js["t"]),
                                             "cpu"), js["step"])

        for policy, mesh in meshes.items():
            if mesh is None:
                continue
            mine = shard_train_state(whole(), mesh=mesh, axes=model.logical_axes(),
                                     policy=policy)
            where = job["dirs"][(policy, codec)]
            path = checkpoint.save_sharded(where, js["step"], mine, model, mesh, policy)
            back = checkpoint.restore_sharded(where, whole(), model, mesh, policy)
            out[(policy, codec)] = {"path": path, "round_trip": _same_bits(back, mine),
                                    "t": back.sc_state.t, "step": back.step}
    conn.send(out)
    dist.barrier()
    dist.destroy_process_group()
    conn.close()
