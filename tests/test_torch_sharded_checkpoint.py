"""Checkpoints of a sharded state (``checkpoint.save_sharded`` /
``restore_sharded``) against the unsharded state and ``repro.checkpoint``.

The reference's ``save`` writes ``np.asarray`` of each leaf, which gathers
a sharded array: its checkpoint of a GSPMD state is the logical stacked
state. Eight gloo ranks (``_torch_fsdp_ranks.checkpoint_main``, one torch
thread each, a ``file://`` store under the test's temporary directory)
take their share of a paper-transformer SMOKE ``TrainState`` at 2 workers
whose every leaf holds random bits (NaN and inf patterns included; a flat
fp8 residue's padding holds zero codes, as every encode leaves it; step 7,
t 9), on a (2, 2) tp grid (the first 4 ranks) and on the (2, 2, 2) fsdp
grid, for every residue codec, save it with ``save_sharded`` and read it
back with ``restore_sharded``:

- each rank's share comes back bit for bit;
- the file, restored by the port into the unsharded state, is the stacked
  state bit for bit, parameters, momentum and every worker's residue row;
- ``repro.checkpoint.restore`` reads the file as the JAX stacked state, bit
  for bit;
- only global rank 0 writes.
"""

import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_fsdp_ranks as ranks
from repro import checkpoint as jcheckpoint
from repro.configs import registry as jregistry
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.state import ScaleComState as JState
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.training import init_train_state as jinit
from repro_torch import checkpoint
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.training import TrainState

ARCH = "paper-transformer-base"
CODECS = ("fp32", "bf16", "fp8", "fp8_ec")
POLICIES = ("tp", "fsdp")
N, WORLD = 2, 8
TIMEOUT_S = 120
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        n = x.element_size()
        return x.detach().cpu().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[n]
                                     ).numpy().view(_UINT[n])
    a = np.asarray(x)
    if a.dtype == np.int64 or (a.shape == () and a.dtype.kind == "i"):
        a = a.astype(np.int32)
    return a.view(_UINT[a.dtype.itemsize])


def _jax_state(codec: str, seed: int):
    """A JAX TrainState at 2 workers whose every leaf holds random bits,
    but a flat residue's padding past the tensor's elements: zero codes."""
    rng = np.random.default_rng(seed)
    cfg = JCfg(compressor=JComp("clt_k", chunk=16), min_size=ranks.MIN_SIZE, residue_dtype=codec,
               layout="flat")
    model = jbuild(jregistry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    js, _ = jinit(model, jmake_opt("sgdm"), cfg, jax.random.PRNGKey(seed), n_workers=N)
    sizes = {jax.tree_util.keystr(p): int(np.prod(x.shape)) for p, x in
             jax.tree_util.tree_flatten_with_path(js.params)[0]}

    def noise(x):
        a = np.asarray(x)
        bits = rng.integers(0, 2 ** (8 * a.dtype.itemsize), a.shape, dtype=np.uint64)
        return bits.astype(_UINT[a.dtype.itemsize]).view(a.dtype)

    residues = {}
    for path, enc in js.sc_state.residues.items():
        residues[path] = {}
        for field, v in enc.items():
            a = noise(v)
            if field != "scale" and a.shape[-1] > sizes[path]:
                a[..., sizes[path]:] = np.zeros((), a.dtype)
            residues[path][field] = jnp.asarray(a)
    js.params = jax.tree.map(lambda x: jnp.asarray(noise(x)), js.params)
    js.opt_state = jax.tree.map(lambda x: jnp.asarray(noise(x)), js.opt_state)
    js.sc_state = JState(residues=residues, t=jnp.int32(9))
    js.step = jnp.int32(7)
    return js


def _carry(js) -> TrainState:
    return TrainState(params=params_from_jax(js.params, "cpu"),
                      opt_state={"m": params_from_jax(js.opt_state["m"], "cpu")},
                      sc_state=state_from_jax(js.sc_state, "cpu"), step=int(js.step))


def _assert_same_bits(port_state, jax_state, label):
    jflat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    tflat = _flatten(port_state)
    assert [k for k, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (key, t), (_, j) in zip(tflat, jflat):
        assert np.shape(j) == tuple(getattr(t, "shape", ())), key
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=f"{label} {key}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    states = {codec: _jax_state(codec, i) for i, codec in enumerate(CODECS)}
    dirs = {(p, c): str(tmp / f"{p}-{c}") for p in POLICIES for c in CODECS}
    job = {"arch": ARCH, "dirs": dirs,
           "states": {c: {"params": jax.tree.map(np.asarray, js.params),
                          "opt_m": jax.tree.map(np.asarray, js.opt_state["m"]),
                          "residues": jax.tree.map(np.asarray, js.sc_state.residues),
                          "t": int(js.sc_state.t), "step": int(js.step)}
                      for c, js in states.items()}}
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(WORLD)]
    procs = [ctx.Process(target=ranks.checkpoint_main,
                         args=(r, WORLD, str(tmp / "store"), pipes[r][1]), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()
    try:
        for parent, _ in pipes:
            parent.send(job)
        results = []
        for r, (parent, _) in enumerate(pipes):
            assert parent.poll(TIMEOUT_S), f"rank {r} sent no result within {TIMEOUT_S} s"
            results.append(parent.recv())
        for r, p in enumerate(procs):
            p.join(TIMEOUT_S)
            assert p.exitcode == 0, f"rank {r} exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return {"ranks": results, "states": states, "dirs": dirs}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_share_round_trips(world, policy, codec):
    grid = range(4) if policy == "tp" else range(WORLD)
    for r in grid:
        got = world["ranks"][r][(policy, codec)]
        assert got["round_trip"], (policy, codec, r)
        assert (got["t"], got["step"]) == (9, 7)
        assert (got["path"] is not None) == (r == 0)
    assert all((policy, codec) not in world["ranks"][r] for r in range(WORLD) if r not in grid)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_checkpoint_is_the_stacked_state(world, policy, codec):
    js = world["states"][codec]
    where = world["dirs"][(policy, codec)]
    like = _carry(js)
    restored = checkpoint.restore(where, like)
    _assert_same_bits(restored, js, f"port {policy} {codec}")
    assert restored.step == 7 and restored.sc_state.t == 9


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_checkpoint_restores_in_jax(world, policy, codec):
    js = world["states"][codec]
    where = world["dirs"][(policy, codec)]
    assert jcheckpoint.latest_step(where) == 7
    restored = jcheckpoint.restore(where, js)
    _assert_same_bits(_carry(js), restored, f"jax {policy} {codec}")
    assert dataclasses.is_dataclass(restored)
