"""repro_torch's bucketed reduce against ``repro.core.plan`` / ``repro.core.overlap``.

Bucket schedules (leaf ids, dense and payload bytes) equal JAX's exactly,
from small trees to the full-width paper-transformer-base shapes; the
bucket-size spec resolves as JAX's does under the port's own
$SCALECOM_TORCH_BUCKET_MB. Bucketing changes launch order only: bucketed
reduces, with overlap on and off, are bitwise the unbucketed one over a
multi-step trajectory. On the CPU both run the buckets on the caller's
stream; the side-stream launch is checked on the card (chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import overlap as joverlap
from repro.core import plan as jplan
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.core import overlap, plan
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.rates import RateRule
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import init_state
from repro_torch.launch import train as cli
from repro_torch.training import train_step as ts_mod

N = 4


def _cfgs(chunk=8, min_size=64, **kw):
    return (JCfg(compressor=JComp("clt_k", chunk=chunk), min_size=min_size, backend="jnp", **kw),
            ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=chunk), min_size=min_size,
                           backend="torch", **kw))


def _both_schedules(leaves, bucket_bytes, **kw):
    jcfg, tcfg = _cfgs(**kw)
    residues = frozenset(p for p, _, _ in leaves)
    jp = jplan.plan_tensors(tuple(leaves), jcfg, residues)
    tp = plan.plan_tensors(tuple(leaves), tcfg, residues)
    return jplan.plan_buckets(jp, bucket_bytes), plan.plan_buckets(tp, bucket_bytes)


def _fields(b):
    return (b.index, b.leaf_ids, b.bytes_dense, b.bytes_payload)


@pytest.mark.parametrize(
    "leaves,bucket_bytes",
    [
        (tuple((f"['w{i}']", (256,), N) for i in range(6)), 2048),  # two per bucket
        (tuple((f"['w{i}']", (256,), N) for i in range(3)), 2048),  # exact boundary
        ((("['small']", (64,), N), ("['huge']", (8192,), N)), 1024),  # oversize
        (tuple((f"['w{i}']", (2048,), N) for i in range(3)), 1024),  # all oversize
        ((("['tiny']", (16,), N), ("['big']", (1024,), N), ("['m']", (7, 40), N)), 1 << 20),
        ((), 1024),  # empty tree
    ],
    ids=["pairs", "boundary", "oversize", "all-oversize", "dense-rides-along", "empty"],
)
def test_schedules_match_jax(leaves, bucket_bytes):
    want, got = _both_schedules(leaves, bucket_bytes)
    assert [_fields(b) for b in got] == [_fields(b) for b in want]
    assert sorted(i for b in got for i in b.leaf_ids) == list(range(len(leaves)))


@pytest.mark.parametrize("bucket_mb", [1, 4, 25, 1000])
@pytest.mark.parametrize("rules", [False, True])
def test_full_width_paper_transformer_schedule_matches_jax(bucket_mb, rules):
    """The full-width model's 19 tensors (56.8 M parameters), planned from
    shapes only, at the smoke's settings (chunk 64, min_size 1024, 8 workers),
    with and without a top-2 rate rule on the blocks."""
    params, _ = jbuild(jregistry.arch("paper-transformer-base")).init(None, abstract=True)
    import jax

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = tuple((jax.tree_util.keystr(p), tuple(x.shape), 8) for p, x in flat)
    assert sum(int(np.prod(s)) for _, s, _ in leaves) == 56_800_256
    jcfg, tcfg = _cfgs(chunk=64, min_size=1024)
    if rules:
        from repro.core.rates import RateRule as JRule

        jcfg = dataclasses.replace(jcfg, rate_rules=(JRule(r"\['blocks'\]", 64, 2),))
        tcfg = dataclasses.replace(tcfg, rate_rules=(RateRule(r"\['blocks'\]", 64, 2),))
    residues = frozenset(p for p, s, _ in leaves if int(np.prod(s)) >= 1024)
    want = jplan.plan_buckets(jplan.plan_tensors(leaves, jcfg, residues), bucket_mb << 20)
    got = plan.plan_buckets(plan.plan_tensors(leaves, tcfg, residues), bucket_mb << 20)
    assert [_fields(b) for b in got] == [_fields(b) for b in want]


def test_plan_buckets_is_cached_and_rejects_nonpositive():
    leaves = (("['w']", (256,), N),)
    _, tcfg = _cfgs(min_size=1)
    plans = plan.plan_tensors(leaves, tcfg, frozenset(["['w']"]))
    assert plan.plan_buckets(plans, 512) is plan.plan_buckets(plans, 512)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            plan.plan_buckets(plans, bad)
    with pytest.raises(ValueError, match="bucket_bytes must be positive"):
        ScaleComConfig(bucket_bytes=0)


@pytest.mark.parametrize("env", [None, "", "8", "0.5", "0", "-3", " 2 "])
@pytest.mark.parametrize("spec", [None, "auto", False, True, 4096, 2.5e6])
def test_resolve_bucket_bytes_follows_jax(monkeypatch, spec, env):
    """The same spec and the same env value give JAX's answer; the JAX
    package's variable is not read."""
    for var in (overlap.BUCKET_ENV, joverlap.BUCKET_ENV):
        monkeypatch.delenv(var, raising=False)
    if env is not None:
        monkeypatch.setenv(joverlap.BUCKET_ENV, env)
    want = joverlap.resolve_bucket_bytes(spec, default_bytes=123 << 10)
    monkeypatch.setenv(joverlap.BUCKET_ENV, "7")
    if env is not None:
        monkeypatch.setenv(overlap.BUCKET_ENV, env)
    assert overlap.resolve_bucket_bytes(spec, default_bytes=123 << 10) == want


def test_resolve_bucket_bytes_rejects_bad_values(monkeypatch):
    monkeypatch.setenv(overlap.BUCKET_ENV, "lots")
    with pytest.raises(ValueError, match="SCALECOM_TORCH_BUCKET_MB"):
        overlap.resolve_bucket_bytes(None)
    monkeypatch.delenv(overlap.BUCKET_ENV)
    with pytest.raises(ValueError, match="positive"):
        overlap.resolve_bucket_bytes(-1)
    with pytest.raises(TypeError, match="buckets spec"):
        overlap.resolve_bucket_bytes("yes please")


def test_resolve_buckets_passes_a_schedule_through(monkeypatch):
    _, tcfg = _cfgs(min_size=1)
    leaves = (("['w']", (256,), N), ("['v']", (256,), N))
    plans = plan.plan_tensors(leaves, tcfg, frozenset(["['w']", "['v']"]))
    prebuilt = plan.plan_buckets(plans, 512)
    assert overlap.resolve_buckets(prebuilt, tcfg, plans) == prebuilt
    assert overlap.resolve_buckets(list(prebuilt), tcfg, plans) == prebuilt
    monkeypatch.delenv(overlap.BUCKET_ENV, raising=False)
    assert overlap.resolve_buckets(None, tcfg, plans) is None
    monkeypatch.setenv(overlap.BUCKET_ENV, "1")
    sched = overlap.resolve_buckets(None, tcfg, plans)
    assert sched == plan.plan_buckets(plans, 1 << 20)
    assert overlap.resolve_buckets(True, dataclasses.replace(tcfg, bucket_bytes=1024),
                                   plans) == plan.plan_buckets(plans, 1024)


_SIZES = {"a": (96,), "b": (24, 16), "c": (520,), "d": {"e": (3, 7, 40)}, "tiny": (16,)}


def _trajectory(cfg, buckets, steps=6, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = _zeros(_SIZES)
    state = init_state(params, N, cfg.residue_dtype, cfg.min_size, cfg.layout)
    out = []
    for _ in range(steps):
        g = _map(lambda s: torch.randn((N,) + s, generator=gen), _SIZES)
        ghat, state, stats = scalecom_reduce(g, state, cfg, compute_stats=True, buckets=buckets)
        out.append((ghat, stats))
    return out, state


def _zeros(sizes):
    return _map(torch.zeros, sizes)


def _map(fn, sizes):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in sizes.items()}


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("residue_dtype", ["fp32", "bf16", "fp8_ec"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("layout", ["flat", "rowwise"])
def test_bucketed_is_bitwise_unbucketed(layout, fused, residue_dtype):
    base = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=8), beta=0.25, min_size=64,
                          layout=layout, fused=fused, residue_dtype=residue_dtype, backend="torch")
    ref, ref_state = _trajectory(base, False)
    leaves = tuple((p, tuple(s.shape), N) for p, s in tree.flatten_with_path(_zeros(_SIZES)))
    prebuilt = plan.plan_buckets(
        plan.plan_tensors(leaves, base, frozenset(ref_state.residues)), 1024)
    for cfg, buckets in ((base, 1024), (base, True), (dataclasses.replace(base, overlap=False), 600),
                         (base, prebuilt)):
        got, got_state = _trajectory(cfg, buckets)
        for (ga, sa), (gb, sb) in zip(ref, got):
            for (path, x), (_, y) in zip(tree.flatten_with_path(ga), tree.flatten_with_path(gb)):
                assert torch.equal(_bits(x), _bits(y)), (buckets, path)
            assert sa["comm_bytes_per_worker"] == sb["comm_bytes_per_worker"]
            assert torch.equal(_bits(sa["contraction_gamma"]), _bits(sb["contraction_gamma"]))
        for path, enc in ref_state.residues.items():
            for k, v in enc.items():
                assert torch.equal(_bits(v), _bits(got_state.residues[path][k])), (buckets, path, k)
        assert got_state.t == ref_state.t


def test_empty_tree_bucketed_is_a_no_op():
    cfg = ScaleComConfig(min_size=1, backend="torch")
    state = init_state({}, N, min_size=1)
    ghat, new_state, stats = scalecom_reduce({}, state, cfg, buckets=1024)
    assert ghat == {} and new_state.t == 1 and stats["comm_bytes_per_worker"] == 0.0


def _spy(monkeypatch):
    seen = []
    real = ts_mod.scalecom_reduce

    def spy(grads, state, cfg, **kw):
        seen.append((cfg, kw))
        return real(grads, state, cfg, **kw)

    monkeypatch.setattr(ts_mod, "scalecom_reduce", spy)
    return seen


@pytest.mark.parametrize(
    "argv,buckets,bucket_bytes,overlap_on",
    [
        ([], None, 25 << 20, True),
        (["--bucket-mb", "0"], False, 25 << 20, True),
        (["--bucket-mb", "-1"], False, 25 << 20, True),
        (["--bucket-mb", "4"], True, 4 << 20, True),
        (["--bucket-mb", "0.5", "--no-overlap"], True, 1 << 19, False),
    ],
)
def test_cli_passes_buckets_and_residue_dtype(monkeypatch, argv, buckets, bucket_bytes,
                                             overlap_on):
    seen = _spy(monkeypatch)
    history = cli.main(["--device", "cpu", "--workers", "2", "--steps", "3", "--warmup-steps",
                        "1", "--local-batch", "2", "--seq", "16", "--log-every", "1",
                        "--residue-dtype", "bf16"] + argv)
    assert len(seen) == 2 and all(np.isfinite(h["loss"]) for h in history)
    for cfg, kw in seen:
        assert cfg.residue_dtype == "bf16" and cfg.bucket_bytes == bucket_bytes
        assert cfg.overlap is overlap_on and kw["buckets"] == buckets


def test_train_loop_bucketed_matches_unbucketed(monkeypatch):
    """A TrainLoop with buckets gives the unbucketed loop's losses and
    parameters bit for bit, and hands ``buckets`` to every reduce."""
    from repro_torch.configs import registry
    from repro_torch.data import make_batches
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, schedule
    from repro_torch.training import TrainLoop, init_train_state, run_training

    seen = _spy(monkeypatch)
    model = build_model(registry.smoke("paper-transformer-base"), loss_chunk=16)
    sc = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=16), beta=0.1, min_size=512,
                        warmup_steps=1, residue_dtype="fp8", backend="torch")
    runs = []
    for buckets in (False, 1 << 16):
        opt = make_optimizer("sgdm")
        state = init_train_state(model, opt, sc, torch.Generator().manual_seed(0), n_workers=2,
                                 device="cpu")
        loop = TrainLoop(model=model, optimizer=opt, schedule=schedule.constant(0.05), sc_cfg=sc,
                         n_workers=2, log_every=1, buckets=buckets)
        state, history = run_training(loop, state, make_batches(512, 2, 2, 16), 3, log=None)
        runs.append(([h["loss"] for h in history], tree.leaves(state.params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert [kw["buckets"] for _, kw in seen] == [False, False, 1 << 16, 1 << 16]
