"""repro_torch's checkpoints against ``repro.checkpoint``: the same files.

A ``TrainState`` (smoke width, 4 workers, sgdm; residues in each codec,
fp32, bf16, fp8 and fp8_ec, filled with random bits, NaN and inf patterns
included; step 7 and t 9) saved by one package restores in the other bit
for bit, leaf by leaf, in both directions: the paper transformer in every
codec, and in fp32 the phi3.5-moe SMOKE state (stacked experts, the router,
RMSNorm scales without biases), the recurrentgemma one at 5 layers (stacked
``units`` beside an un-stacked 2-layer ``tail``) and the whisper one
(``encoder`` with its final norm inside, ``decoder`` with cross-attention).
The port's leaf keys are JAX's ``keystr`` paths of the whole state
(``[<flat index 0>]['blocks']...``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro.configs import registry as jregistry
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.state import ScaleComState as JState
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jmake_opt
from repro.training import init_train_state as jinit
from repro_torch import checkpoint, tree
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import make_batches
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainLoop, TrainState, init_train_state, run_training

ARCH = "paper-transformer-base"
MOE = "phi3.5-moe-42b-a6.6b"
HYBRID = "recurrentgemma-2b"
WHISPER = "whisper-medium"
N, CHUNK, MIN_SIZE = 4, 16, 512
CODECS = ("fp32", "bf16", "fp8", "fp8_ec")
# (arch, codec) per case; the paper transformer's cases keep their codec ids
CASES = [(ARCH, c) for c in CODECS] + [(MOE, "fp32"), (HYBRID, "fp32"), (WHISPER, "fp32")]
CASE_IDS = list(CODECS) + ["phi3.5-moe-fp32", "recurrentgemma-fp32", "whisper-fp32"]
# SMOKE overrides: the hybrid at 5 layers, so its state has a tail
OVERRIDES = {HYBRID: dict(n_layers=5)}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _bits(x) -> np.ndarray:
    """A leaf's bits as unsigned ints (torch tensor, JAX or numpy array, int)."""
    if isinstance(x, torch.Tensor):
        n = x.element_size()
        return x.detach().cpu().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[n]
                                     ).numpy().view(_UINT[n])
    a = np.asarray(x)
    if a.dtype == np.int64 or (a.shape == () and a.dtype.kind == "i"):
        a = a.astype(np.int32)  # the port's host ints against JAX's int32 scalars
    return a.view(_UINT[a.dtype.itemsize])


def _jax_state(codec, seed=0, arch=ARCH):
    """A JAX TrainState whose every leaf holds random bits."""
    rng = np.random.default_rng(seed)
    cfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), min_size=MIN_SIZE, residue_dtype=codec)
    jcfg = dataclasses.replace(jregistry.smoke(arch), **OVERRIDES.get(arch, {}))
    model = jbuild(jcfg, compute_dtype="float32", loss_chunk=16)
    js, _ = jinit(model, jmake_opt("sgdm"), cfg, jax.random.PRNGKey(seed), n_workers=N)

    def noise(x):
        a = np.asarray(x)
        bits = rng.integers(0, 2 ** (8 * a.dtype.itemsize), a.shape, dtype=np.uint64)
        return jnp.asarray(bits.astype(_UINT[a.dtype.itemsize]).view(a.dtype))

    js.opt_state = jax.tree.map(noise, js.opt_state)
    js.sc_state = JState(residues=jax.tree.map(noise, js.sc_state.residues), t=jnp.int32(9))
    js.step = jnp.int32(7)
    return js


def _carry(js) -> TrainState:
    return TrainState(params=params_from_jax(js.params, "cpu"),
                      opt_state={"m": params_from_jax(js.opt_state["m"], "cpu")},
                      sc_state=state_from_jax(js.sc_state, "cpu"), step=int(js.step))


def _port_like(codec, arch=ARCH) -> TrainState:
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), min_size=MIN_SIZE,
                         residue_dtype=codec)
    tcfg = dataclasses.replace(registry.smoke(arch), **OVERRIDES.get(arch, {}))
    return init_train_state(build_model(tcfg, compute_dtype="float32", loss_chunk=16),
                            make_optimizer("sgdm"), cfg, torch.Generator().manual_seed(1),
                            n_workers=N, device="cpu")


def _assert_same_bits(port_state, jax_state):
    jflat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    tflat = _flatten(port_state)
    assert [k for k, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (key, t), (_, j) in zip(tflat, jflat):
        assert np.shape(j) == tuple(getattr(t, "shape", ())), key
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=key)


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def states(request):
    arch, codec = request.param
    js = _jax_state(codec, arch=arch)
    return (arch, codec), js, _carry(js)


def test_port_keys_are_jax_keystr_paths(states):
    (arch, _), js, ts = states
    keys = [k for k, _ in _flatten(ts)]
    assert keys == [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert keys[-1] == "[<flat index 3>]"
    if arch in (ARCH, MOE):
        assert "[<flat index 0>]['blocks']['attn_wq']" in keys
    if arch == HYBRID:
        assert "[<flat index 0>]['units']['u2_attn']['attn_wq']" in keys
        assert "[<flat index 0>]['tail']['layer_1_rec']['rec_conv']" in keys
        assert "[<flat index 2>][<flat index 0>][\"['tail']['layer_0_rec']['rec_in_x']\"]['q']" in keys
    if arch == WHISPER:
        assert "[<flat index 0>]['encoder']['ln_enc_final_bias']" in keys
        assert "[<flat index 1>]['m']['decoder']['cross_wq']" in keys
        assert "[<flat index 2>][<flat index 0>][\"['decoder']['cross_wv']\"]['q']" in keys
    if arch == MOE:
        assert "[<flat index 0>]['blocks']['expert_gate']" in keys
        assert "[<flat index 2>][<flat index 0>][\"['blocks']['expert_down']\"]['q']" in keys
        assert not any(k.endswith("_bias']") for k in keys)


def test_port_checkpoint_restores_in_jax(states, tmp_path):
    _, js, ts = states
    path = checkpoint.save(str(tmp_path), 7, ts)
    assert path.endswith("ckpt_00000007.npz") and jcheckpoint.latest_step(str(tmp_path)) == 7
    restored = jcheckpoint.restore(str(tmp_path), js)
    _assert_same_bits(ts, restored)


def test_jax_checkpoint_restores_in_the_port(states, tmp_path):
    (arch, codec), js, ts = states
    jcheckpoint.save(str(tmp_path), 7, js)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    like = _port_like(codec, arch)
    restored = checkpoint.restore(str(tmp_path), like)
    _assert_same_bits(restored, js)
    assert isinstance(restored.step, int) and restored.step == 7 and restored.sc_state.t == 9
    for (_, r), (_, l) in zip(_flatten(restored), _flatten(like)):
        if isinstance(l, torch.Tensor):
            assert r.dtype == l.dtype and r.device == l.device


def test_port_round_trip_keeps_ints_and_adam_count(tmp_path):
    opt = make_optimizer("adam")
    params = {"w": torch.randn(3, 4), "b": {"c": torch.tensor([-0.0, float("nan"), 1.0])}}
    state = {"params": params, "opt": opt.init(params), "tokens": torch.arange(5)}
    state["opt"]["count"] = 11
    checkpoint.save(str(tmp_path), 2, state)
    like = {"params": tree.zeros_like(params), "opt": opt.init(params),
            "tokens": torch.zeros(5, dtype=torch.int64)}
    out = checkpoint.restore(str(tmp_path), like)
    assert out["opt"]["count"] == 11 and isinstance(out["opt"]["count"], int)
    assert torch.equal(out["tokens"], torch.arange(5))
    for (k, a), (_, b) in zip(_flatten(out["params"]), _flatten(params)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def test_restore_rejects_a_wrong_shape(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match=r"\['w'\]: shape \(3, 4\), want \(4, 3\)"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(4, 3)})


def test_loop_saves_every_checkpoint_every_steps(tmp_path):
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), min_size=MIN_SIZE,
                         warmup_steps=1, backend="torch")
    model = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    opt = make_optimizer("sgdm")
    state = init_train_state(model, opt, cfg, torch.Generator().manual_seed(0), n_workers=2,
                             device="cpu")
    loop = TrainLoop(model=model, optimizer=opt, schedule=schedule.constant(0.05), sc_cfg=cfg,
                     n_workers=2, checkpoint_dir=str(tmp_path), checkpoint_every=2, log_every=1)
    final, _ = run_training(loop, state, make_batches(512, 2, 2, 16, seed=0), 5, log=None)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.npz", "ckpt_00000004.npz", "manifest.json"]
    restored = checkpoint.restore(str(tmp_path), final)
    assert restored.step == 5 and checkpoint.latest_step(str(tmp_path)) == 4
    for (k, a), (_, b) in zip(_flatten(restored), _flatten(final)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
