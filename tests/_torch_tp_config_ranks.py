"""The rank side of ``tests/test_torch_tp_configs.py``: four processes joined
in a gloo group through a ``file://`` store, as a (2 data, 2 model) grid.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only (lossy residues arrive as numpy arrays of
``ml_dtypes`` dtypes, moved across by their bits), runs torch on one
thread, and puts JAX's draws in place of the port's: ``core.compressors.
random_draw`` (random_k) and ``core.state.codec_dither`` (stochastic
rounding) look the requested (step, shape) up in the job, and a draw the
job does not hold raises. It runs the teacher-forced reduces and NaN encodes of
the first job, then the whole steps of the second, and sends back numpy arrays and
plain values. A failure raises, and the process exits non-zero.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import compressors as tcomp
from repro_torch.core import state as tstate
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.core.state import ScaleComState
from repro_torch.distributed import ring, sharding, slices, tensor_parallel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import (
    params_from_jax, residue_bits, train_state_from_shard, train_state_shard_from_jax,
)
from repro_torch.optim import make_optimizer, schedule
from repro_torch.optim.optimizer import Optimizer
from repro_torch.training import TrainState, build_train_step, shard_train_state
from repro_torch.training import train_step as ts

ARCH = "paper-transformer-base"
TIMEOUT_S = 120


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates the parameters in place."""
    return t.detach().cpu().numpy().copy()


def _flat_np(t) -> dict:
    return {p: _np(v) for p, v in tree.flatten_with_path(t)}


def _install_draws(draws: dict, dithers: dict) -> None:
    def random_draw(t, shape, device, high=None):
        return torch.from_numpy(draws[(int(t), tuple(shape), high)]).to(device)

    def codec_dither(key, shape, device):
        path, t = key
        return torch.from_numpy(dithers[(path, int(t), tuple(shape))]).to(device)

    tcomp.random_draw = random_draw
    tstate.codec_dither = codec_dither


def _sc_cfg(job: dict, name: str, exact: bool, codec: str, groups, fused: bool,
            layout: str = "flat") -> ScaleComConfig:
    return ScaleComConfig(compressor=CompressorConfig(name, chunk=job["chunk"], exact=exact),
                          beta=job["beta"], min_size=job["min_size"], residue_dtype=codec,
                          groups=groups, backend="torch", fused=fused, layout=layout)


class _Offsets:
    """Keeps the offsets each compressed tensor's reduce updated at, in leaf
    order: ``ring_steps``' (chunked) and ``_tp_exact_steps``' (exact)."""

    def __init__(self):
        self.got = []
        self.real = (ts.ring_steps, ts._tp_exact_steps)

    def __enter__(self):
        def wrap(fn, at):
            def spy(*args, **kwargs):
                out = yield from fn(*args, **kwargs)
                self.got.append(_np(out[at]))
                return out
            return spy

        ts.ring_steps = wrap(self.real[0], 3)
        ts._tp_exact_steps = wrap(self.real[1], 3)
        return self

    def __exit__(self, *exc):
        ts.ring_steps, ts._tp_exact_steps = self.real


def _hierarchy(mesh, groups):
    if groups is None:
        return None
    return ring.make_hierarchy(mesh.group("data"), groups, lines=mesh.lines("data"))


def _reduces(job: dict, mesh) -> dict:
    """Each labelled configuration's ``_tp_reduce`` on this rank's slice of
    its worker's gradient row and of the stacked residues (its worker's
    row, or its group's), teacher-forced at each t: the offsets, ĝ, the new
    residue slice and the row it joins back to (bits), the stats and the
    counted payload; and the share itself, cut and joined."""
    shapes, axes = job["shapes"], job["axes"]
    abstract = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    layout = ts._tp_layout(abstract, axes, mesh)
    specs = dict(tree.flatten_with_path(sharding.specs_for_axes(abstract, axes, "tp", mesh)))
    row = mesh.index("data")
    grads = {k: sharding.shard_of(torch.from_numpy(g[row]), specs[f"['{k}']"], mesh)[None]
             for k, g in job["grads"].items()}
    spec_tree = sharding.specs_for_axes(abstract, axes, "tp", mesh)
    out = {}
    for label, (name, exact, codec, groups, fused, stats, t_list, lay) in job["configs"].items():
        cfg = _sc_cfg(job, name, exact, codec, groups, fused, lay)
        hier = _hierarchy(mesh, groups)
        whole = TrainState({k: torch.zeros(s) for k, s in shapes.items()}, {},
                           ScaleComState(params_from_jax(job["residues"][label], "cpu"), 0), 0)
        share = shard_train_state(whole, mesh=mesh, axes=axes, groups=groups)
        back = train_state_from_shard(share, spec_tree, mesh)
        out[(label, "share")] = {"slices": residue_bits(share.sc_state),
                                 "rows": residue_bits(back.sc_state)}
        for t in t_list:
            ring.reset_sent()
            tensor_parallel.reset_sent()
            with _Offsets() as spy:
                ghat, new, got = ts._tp_reduce(grads, ScaleComState(share.sc_state.residues, t),
                                               cfg, layout, hier, stats)
            payload = ring.payload_sent()
            sent = dict(ring.sent)
            joined = train_state_from_shard(TrainState(share.params, {}, new, 0), spec_tree,
                                            mesh)
            out[(label, t)] = {"offsets": spy.got, "ghat": _flat_np(ghat),
                               "slices": residue_bits(new), "rows": residue_bits(joined.sc_state),
                               "t": new.t, "stats": {k: float(v) for k, v in got.items()},
                               "payload": payload, "sent": sent}
    return out


def _nan_encodes(job: dict, mesh) -> dict:
    """``slices.encode`` (nearest rounding) of each logical residue row of
    leaf "a" in the job's NaN cases: every rank codes its slice of the row,
    one NaN in a block (flat) or row (rowwise) that crosses the slices,
    held by the model rank the case names. The slice's fields and the row
    they join back to (``slices.join``), as bits."""
    abstract = {k: torch.empty(s, device="meta") for k, s in job["shapes"].items()}
    layout = ts._tp_layout(abstract, job["axes"], mesh)
    sl = layout.slice(layout.paths.index("['a']"))
    out = {}
    for (codec, lay, holder), row in job["nan"].items():
        m = slices.cut("fp32", {"q": torch.from_numpy(row)}, sl, lay)["q"]
        enc = slices.encode(codec, m, sl, lay, None, layout.pieces)
        joined = slices.join(codec, enc, sl, lay, layout.pieces)
        out[(codec, lay, holder)] = {
            "slice": residue_bits(ScaleComState({"a": enc}, 0))["a"],
            "row": residue_bits(ScaleComState({"a": joined}, 0))["a"]}
    return out


def _steps(job: dict, mesh) -> dict:
    """Whole steps from each labelled JAX state: this rank's parameter
    slices, the ĝ slices its optimizer received, the metrics, the counted
    payload and the new residue rows (joined, bits)."""
    model = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    base = make_optimizer("sgdm")
    seen = []

    def update(grads, state, params, lr):
        seen.append(_flat_np(grads))
        return base.update(grads, state, params, lr)

    opt = Optimizer(base.init, update)
    specs = sharding.specs_for_axes(model.abstract_params(), model.logical_axes(), "tp", mesh)
    out = {}
    for label, (name, codec, groups, stats, modes) in job["configs"].items():
        cfg = _sc_cfg(job, name, False, codec, groups, False)
        js = job["states"][label]
        for mode in modes:
            # a share of its own for each mode: the step writes the parameters in place
            state = train_state_shard_from_jax(_ns(js), model.logical_axes(), mesh, "cpu",
                                               groups=groups)
            fn = build_train_step(model, opt, schedule.constant(job["lr"]), cfg,
                                  n_workers=mesh.shape["data"], mode=mode, mesh=mesh,
                                  compute_stats=stats)
            ring.reset_sent()
            state, metrics = fn(state, job["batch"])
            out[(label, mode)] = {"params": _flat_np(state.params), "ghat": seen.pop(),
                                  "metrics": {k: float(v) for k, v in metrics.items()},
                                  "payload": ring.payload_sent(), "t": state.sc_state.t,
                                  "rows": residue_bits(train_state_from_shard(
                                      state, specs, mesh).sc_state)}
    return out


def _inits(mesh) -> dict:
    """Per codec, ``init_train_state(mesh=)``'s residue fields (name, shape,
    dtype, all zero) against ``shard_train_state(mesh=)`` of the stacked
    init's; with ``groups=1`` too."""
    model = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    opt = make_optimizer("sgdm")
    out = {}
    for codec in tstate.CODECS:
        for groups in (None, 1):
            cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=16), min_size=512,
                                 residue_dtype=codec, groups=groups, layout="flat")
            mine = ts.init_train_state(model, opt, cfg, torch.Generator().manual_seed(3),
                                       n_workers=mesh.shape["data"], device="cpu", mesh=mesh)
            whole = ts.init_train_state(model, opt, cfg, torch.Generator().manual_seed(3),
                                        n_workers=mesh.shape["data"], device="cpu")
            want = shard_train_state(whole, mesh=mesh, axes=model.logical_axes(), groups=groups)

            def fields(residues):
                return {p: sorted((k, tuple(v.shape), str(v.dtype)) for k, v in e.items())
                        for p, e in residues.items()}

            out[(codec, groups)] = {
                "mine": fields(mine.sc_state.residues), "want": fields(want.sc_state.residues),
                "zero": all(not v.to(torch.float32).any() for e in mine.sc_state.residues.values()
                            for v in e.values())}
    return out


def _ns(js: dict):
    from types import SimpleNamespace

    return SimpleNamespace(params=js["params"], opt_state={"m": js["opt_m"]},
                           sc_state=SimpleNamespace(residues=js["residues"], t=js["t"]),
                           step=js["step"])


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    grid = make_test_mesh((2, 2))
    _install_draws(job["draws"], job["dithers"])
    result = {"coords": dict(grid.coords), "reduce": _reduces(job["reduce"], grid),
              "inits": _inits(grid), "nan": _nan_encodes(job["reduce"], grid)}
    steps = conn.recv()
    _install_draws({}, steps["dithers"])
    result["steps"] = _steps(steps, grid)
    conn.send(result)
    dist.destroy_process_group()
