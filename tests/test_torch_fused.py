"""repro_torch's fused reduce against ``repro``'s: kernel, backend and reduce.

On CPU tensors the ``fused_reduce`` wrapper runs its plain version, which the
CUDA kernel equals bit for bit on the card (``chip_smoke.py``), so these tests
pin the kernel's function against the Pallas ``_fused_kernel`` in interpret
mode and ``scalecom_reduce(fused=True)`` against the JAX package's.

Tolerances: indices and vals bitwise (a select only copies; with the
integer-valued inputs used against the kernel, worker means are exact, so
true_topk's indices are bitwise too). m' and ĝ rtol 1e-6 / atol 1e-7: XLA may
contract the Eq. 5 axpy into an FMA, and the worker mean is summed in worker
order here but in XLA's order there. Against the unfused path from the same
state, clt_k's idx, vals and m' are bitwise.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunked as jchunked
from repro.core import scalecom as jsc
from repro.core.compressors import CompressorConfig as JComp
from repro.core.rates import RateRule as JRule
from repro.kernels.fused_reduce import fused_reduce_trailing
from repro_torch.backends import base as tbase
from repro_torch.backends import resolve_backend, resolve_fused
from repro_torch.backends.cuda_backend import CudaBackend
from repro_torch.core import scalecom as tsc
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.rates import RateRule
from repro_torch.kernels import fused_reduce as fr_kernel
from repro_torch.models.convert import state_from_jax
from test_torch_scalecom import CHUNK, MIN_SIZE, N, T, _flat, _inputs, _map

BETA = 0.1


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("topm", [1, 2, 3])
@pytest.mark.parametrize("mode", ["clt_k", "true_topk"])
def test_fused_kernel_matches_pallas_interpret(mode, topm, G):
    """The kernel's plain version through the cuda backend (pad, (G, rows,
    chunk) view, slice back) against the Pallas kernel, with a chunk tail
    and integer-valued inputs full of ties."""
    rng = np.random.default_rng([G, topm, len(mode)])
    size = 100  # 7 chunks of 16, the last holding 4 real lanes
    m, g = (rng.integers(-3, 4, size=(G, 2, size)).astype(np.float32) for _ in range(2))
    leader = (G - 1) // 2 if mode == "clt_k" else None
    got = resolve_backend("cuda").fused_reduce(torch.from_numpy(m), torch.from_numpy(g), BETA,
                                               CHUNK, topm, mode, leader)
    pad = lambda x: jchunked.pad_to_chunks(jnp.asarray(x), CHUNK)  # noqa: E731
    want = fused_reduce_trailing(pad(m), pad(g), jnp.int32(leader or 0), BETA, CHUNK, topm, mode,
                                 interpret=True)
    idx, vals, m_new, ghat = (t.numpy() for t in got)
    np.testing.assert_array_equal(idx, np.asarray(want[0]))
    np.testing.assert_array_equal(vals, np.asarray(want[1]))
    _close(m_new, np.asarray(want[2])[..., :size], "m_new")
    _close(ghat, np.asarray(want[3])[..., :size], "ghat")
    assert m_new.shape == m.shape and ghat.shape == m.shape[1:]


@pytest.mark.parametrize("topm", [1, 2])
def test_fused_clt_k_equals_the_unfused_ops_bitwise(topm):
    """From the same state the fused clt_k path gives the unfused path's idx,
    vals and m' bit for bit; ĝ differs only in the worker mean's order."""
    rng = np.random.default_rng(topm)
    m, g = (torch.from_numpy(rng.standard_normal((N, 3, 100)).astype(np.float32)) for _ in range(2))
    be = resolve_backend("cuda")
    idx, vals, m_new, ghat = be.fused_reduce(m, g, BETA, CHUNK, topm, "clt_k", 2)
    want_idx = be.select_indices(m + g, CHUNK, topm)[2]
    want_m, want_vals = be.ef_update(m, g, want_idx, BETA, CHUNK, topm)
    assert torch.equal(idx, want_idx) and torch.equal(vals, want_vals)
    assert torch.equal(m_new, want_m)
    _close(ghat.numpy(), be.scatter(torch.mean(want_vals, 0), idx, CHUNK, 100, topm).numpy(), "ghat")


def test_plain_worker_mean_sums_in_worker_order():
    vals = torch.tensor([[1e8], [1.0], [-1e8]])
    ghat = fr_kernel.fused_reduce_plain(vals[:, :, None].expand(3, 1, 2).contiguous(),
                                        torch.zeros(3, 1, 2), BETA, 1, "true_topk")[3]
    assert float(ghat.max()) == 0.0  # (1e8 + 1) - 1e8 in fp32, not 1/3


class _CountingBackend(CudaBackend):
    """The cuda backend, counting the fused_reduce calls of one reduce."""

    def __init__(self):
        self.fused_calls = 0

    def fused_reduce(self, *args, **kwargs):
        self.fused_calls += 1
        return super().fused_reduce(*args, **kwargs)


def _reduce_both(compressor, layout, groups, rules=(), fused=True, backend="cuda"):
    grads, jst = _inputs(zlib.crc32(repr((compressor, layout, groups)).encode()), groups, layout)
    common = dict(beta=BETA, min_size=MIN_SIZE, layout=layout, groups=groups)
    jcfg = jsc.ScaleComConfig(compressor=JComp(compressor, chunk=CHUNK), backend="jnp",
                              fused=fused, rate_rules=tuple(JRule(*r) for r in rules), **common)
    tcfg = tsc.ScaleComConfig(compressor=CompressorConfig(compressor, chunk=CHUNK),
                              backend=backend, fused=fused,
                              rate_rules=tuple(RateRule(*r) for r in rules), **common)
    jout = jsc.scalecom_reduce(_map(jnp.asarray, grads), jst, jcfg, compute_stats=True,
                               buckets=False)
    tout = tsc.scalecom_reduce(_map(torch.from_numpy, grads), state_from_jax(jst, "cpu"), tcfg,
                               compute_stats=True)
    return jout, tout


def _assert_reduce_close(jout, tout):
    (jg, jnew, jstats), (tg, tnew, tstats) = jout, tout
    jflat, tflat = _flat(jg), _flat(tg)
    assert jflat.keys() == tflat.keys()
    for path in jflat:
        _close(tflat[path].numpy(), np.asarray(jflat[path]), path)
    assert jnew.residues.keys() == tnew.residues.keys()
    for path, enc in jnew.residues.items():
        _close(tnew.residues[path]["q"].numpy(), np.asarray(enc["q"]), path)
    assert tnew.t == int(jnew.t) == T + 1
    np.testing.assert_allclose(float(tstats["contraction_gamma"]),
                               float(jstats["contraction_gamma"]), rtol=1e-5)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("compressor", ["clt_k", "true_topk"])
def test_fused_reduce_step_matches_jax(compressor, layout, groups, backend):
    _assert_reduce_close(*_reduce_both(compressor, layout, groups, backend=backend))


@pytest.mark.parametrize("compressor,want_fused", [("clt_k", 2), ("local_topk", 0)])
def test_mixed_rate_rules_fuse_only_the_fusable(compressor, want_fused):
    """A top-2 rule, a dense rule and the base rate: clt_k tensors each take
    one fused_reduce; local_topk silently keeps the unfused path."""
    rules = ((r"\['a'\]", 8, 2), (r"\['z'\]", None))
    be = _CountingBackend()
    jout, tout = _reduce_both(compressor, "flat", None, rules, backend=be)
    _assert_reduce_close(jout, tout)
    assert be.fused_calls == want_fused


def test_fused_and_unfused_reduce_agree_and_only_fused_calls_the_kernel():
    grads, jst = _inputs(3, None, "rowwise")
    outs = []
    for fused in (False, True):
        be = _CountingBackend()
        cfg = tsc.ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK, topm=2),
                                 beta=BETA, min_size=MIN_SIZE, layout="rowwise", backend=be,
                                 fused=fused)
        outs.append(tsc.scalecom_reduce(_map(torch.from_numpy, grads), state_from_jax(jst, "cpu"),
                                        cfg))
        assert be.fused_calls == (3 if fused else 0)
    (ug, unew, _), (fg, fnew, _) = outs
    for path, enc in unew.residues.items():
        assert torch.equal(enc["q"], fnew.residues[path]["q"]), path  # m' bitwise
    for path, v in _flat(ug).items():
        _close(_flat(fg)[path].numpy(), v.numpy(), path)


def test_scalecom_fused_env_resolves_at_call_time(monkeypatch):
    monkeypatch.delenv("SCALECOM_TORCH_FUSED", raising=False)
    monkeypatch.setenv("SCALECOM_FUSED", "1")  # the JAX package's name: ignored
    assert resolve_fused("auto") is False and resolve_fused(None) is False
    for on in ("1", "true", "ON", " yes "):
        monkeypatch.setenv("SCALECOM_TORCH_FUSED", on)
        assert resolve_fused("auto") is True
    assert resolve_fused(False) is False  # explicit wins
    for off in ("0", "False", "off", "no", ""):
        monkeypatch.setenv("SCALECOM_TORCH_FUSED", off)
        assert resolve_fused("auto") is False
    assert resolve_fused(True) is True
    monkeypatch.setenv("SCALECOM_TORCH_FUSED", "maybe")
    with pytest.raises(ValueError, match="yes"):
        resolve_fused("auto")
    with pytest.raises(ValueError, match="'auto'"):
        resolve_fused("sometimes")
    assert tbase._FUSED_TRUE == ("1", "true", "on", "yes")


def test_fused_config_validates_and_env_drives_the_reduce(monkeypatch):
    with pytest.raises(ValueError, match="SCALECOM_TORCH_FUSED"):
        tsc.ScaleComConfig(fused="yes")
    assert tsc.ScaleComConfig().fused == "auto"
    grads, jst = _inputs(4, None, "flat")
    cfg = dataclasses.replace(
        tsc.ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK)), min_size=MIN_SIZE)
    for env, want in (("0", 0), ("1", 3)):
        monkeypatch.setenv("SCALECOM_TORCH_FUSED", env)
        be = _CountingBackend()
        tsc.scalecom_reduce(_map(torch.from_numpy, grads), state_from_jax(jst, "cpu"),
                            dataclasses.replace(cfg, backend=be))
        assert be.fused_calls == want, env
