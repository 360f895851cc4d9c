"""``repro_torch.harness`` against ``repro.harness``, and the port's own checks.

Parity: both packages' ``_simulate`` run the same stream (JAX's draws,
handed to the port as torch tensors) and, for the corrupt scenario, the
same garbage (JAX's ``normal(fold_in(key, i))`` through the port's one
draw, ``injectors.corrupt_draw``), at fp32 with clt_k (and local_topk for
the build-up run), 8 steps. Per-step records (nnz, k, comm bytes, G,
membership, injector notes) and re-plan records are equal, with a stale
plan error exactly where the reference has one. Trajectories hold to rtol
1e-5 / atol 1e-6 and distances to the clean run to atol 1e-6: residues and
indices are bitwise, ĝ only allclose (the worker means are summed in
another order), and the weights accumulate it.

Port-only: the invariants' bounds and messages, the membership windows,
the stream's purity (a straggler's re-draw is bitwise), copies not aliases
in the injectors, the clean-twin cache's key, the device rule, the CLI and
``--preflight-scenarios``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JConfig
from repro.harness import invariants as jinv
from repro.harness import scenarios as jsc
from repro_torch.analysis.perfmodel import buildup_ratio_model
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.core.state import ScaleComState
from repro_torch.harness import cli as tcli
from repro_torch.harness import injectors as tinj
from repro_torch.harness import invariants as tinv
from repro_torch.harness import scenarios as tsc
from repro_torch.launch import train as train_cli
from repro_torch.obs import report

STEPS, LR, CHUNK = 8, 0.1, 16
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
DIST_ATOL = 1e-6
# (scenario, workers, groups, compressor): every scenario at 8 workers flat,
# a hierarchical drop (16 -> 15 re-plans groups 4 -> 3, and back) and a
# local_topk build-up run
CASES = [
    ("baseline", 8, None, "clt_k"),
    ("straggler", 8, None, "clt_k"),
    ("drop", 8, None, "clt_k"),
    ("stale", 8, None, "clt_k"),
    ("corrupt", 8, None, "clt_k"),
    ("drop", 16, 4, "clt_k"),
    ("baseline", 8, None, "local_topk"),
]


def _jax_garbage(seed, leaf, shape):
    """The reference's corrupt garbage (before scaling), as the port's draw."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), leaf)
    return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))


@functools.lru_cache(maxsize=None)
def _jax_run(name, workers, groups, compressor):
    cfg = JConfig(compressor=JComp(compressor, chunk=CHUNK), beta=1.0, min_size=tsc.MIN_SIZE,
                  residue_dtype="fp32", groups=groups)
    stream = jsc.make_stream(workers)
    injector = jsc.SCENARIOS[name].make(workers, STEPS)
    return jsc._simulate(cfg, workers, STEPS, stream, injector, "fp32", LR)


def _port_run(name, workers, groups, compressor):
    cfg = ScaleComConfig(compressor=CompressorConfig(compressor, chunk=CHUNK), beta=1.0,
                         min_size=tsc.MIN_SIZE, residue_dtype="fp32", groups=groups)
    jstream = jsc.make_stream(workers)

    def stream(t, active):
        return {k: torch.from_numpy(np.array(v)) for k, v in jstream(t, active).items()}

    injector = tsc.SCENARIOS[name].make(workers, STEPS)
    return tsc._simulate(cfg, workers, STEPS, stream, injector, "fp32", LR, "cpu")


@pytest.fixture(scope="module")
def jax_garbage():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinj, "corrupt_draw", _jax_garbage)
        yield


def _distances(traj, clean):
    return [float(np.linalg.norm(f - c) / max(np.linalg.norm(c), 1e-12))
            for f, c in zip(traj, clean)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1]}-g{c[2]}-{c[3]}")
def test_simulate_matches_the_reference(case, jax_garbage):
    name, workers, groups, compressor = case
    j_traj, j_rec, j_rep = _jax_run(*case)
    t_traj, t_rec, t_rep = _port_run(*case)

    assert len(t_rec) == len(j_rec) == STEPS
    for tr, jr in zip(t_rec, j_rec):
        # the reference's reported bytes are a float32 array, the port's a
        # Python float: equal to the plan, which the reference's are only to
        # float32 (4k/G at G = 7 is not a float32)
        assert tr["comm_bytes"] == tr["comm_planned"]
        assert float(np.float32(tr["comm_bytes"])) == jr["comm_bytes"]
        tr, jr = dict(tr, comm_bytes=None), dict(jr, comm_bytes=None)
        assert tr == jr, f"step {jr['t']}: port {tr} != reference {jr}"
    assert len(t_rep) == len(j_rep)
    for tp, jp in zip(t_rep, j_rep):
        assert {k: v for k, v in tp.items() if k != "stale_plan_error"} == \
            {k: v for k, v in jp.items() if k != "stale_plan_error"}
        assert (tp["stale_plan_error"] is None) == (jp["stale_plan_error"] is None)
    if name == "drop":
        assert [r["rows_after"] for r in t_rep] == ([7, 8] if groups is None else [3, 4])
        assert all(r["stale_plan_error"] for r in t_rep)

    for t, (a, b) in enumerate(zip(t_traj, j_traj)):
        np.testing.assert_allclose(a, b, **TRAJ_TOL, err_msg=f"trajectory at step {t}")
    if name != "baseline":
        j_clean = _jax_run("baseline", workers, groups, compressor)[0]
        t_clean = _port_run("baseline", workers, groups, compressor)[0]
        np.testing.assert_allclose(_distances(t_traj, t_clean), _distances(j_traj, j_clean),
                                   rtol=0, atol=DIST_ATOL)


def test_local_topk_builds_up_under_the_model():
    _, records, _ = _port_run("baseline", 8, None, "local_topk")
    ratios = [r["buildup_ratio"] for r in records]
    assert all(1.0 < x <= 1.10 * buildup_ratio_model(8, CHUNK) for x in ratios)


# -- invariants: the reference's bounds and messages -------------------------------------

@pytest.mark.parametrize("ratio,compressor,workers,topm", [
    (1.5, "clt_k", 8, 1), (0.9, "clt_k", 8, 1), (1.0 + 2e-6, "true_topk", 64, 1),
    (20.0, "local_topk", 8, 1), (5.0, "local_topk", 8, 1), (12.0, "local_topk", 16, 2),
    (3.0, "none", 8, 1),
])
def test_check_buildup_is_the_reference(ratio, compressor, workers, topm):
    assert (tinv.check_buildup(ratio, compressor, workers, CHUNK, topm)
            == jinv.check_buildup(ratio, compressor, workers, CHUNK, topm))


def test_check_buildup_flags_violations():
    assert tinv.check_buildup(1.5, "clt_k", 8, 16) is not None
    assert tinv.check_buildup(0.9, "clt_k", 8, 16) is None
    model = buildup_ratio_model(8, 16)
    assert tinv.check_buildup(model * 2.0, "local_topk", 8, 16) is not None
    assert tinv.check_buildup(model * 0.9, "local_topk", 8, 16) is None


@pytest.mark.parametrize("measured,planned", [
    (0.0, 0.0), (100.0, 100.0), (100.0, 100.0001), (101.0, 100.0), (3.0, 0.0),
    (227_201_024.0, 227_201_024.0),
])
def test_check_comm_accounting_is_the_reference(measured, planned):
    assert (tinv.check_comm_accounting(measured, planned)
            == jinv.check_comm_accounting(measured, planned))


@pytest.mark.parametrize("distance,codec,scale,label", [
    (0.04, "fp32", 1.0, ""), (0.06, "fp32", 1.0, ""), (0.2, "fp8", 1.0, ""),
    (0.09, "bf16", 1.0, "stale@n=8"), (0.11, "fp8_ec", 1.5, "corrupt@n=64"),
])
def test_check_trajectory_is_the_reference(distance, codec, scale, label):
    assert (tinv.check_trajectory(distance, codec, scale, label)
            == jinv.check_trajectory(distance, codec, scale, label))
    assert tinv.codec_tolerance(codec, scale) == jinv.codec_tolerance(codec, scale)


def test_tolerances_and_registry_are_the_reference():
    assert tinv.CODEC_TOL == jinv.CODEC_TOL
    assert tinv._FLAT_COMPRESSORS == jinv._FLAT_COMPRESSORS
    assert tinv._BUILDUP_MODEL_SLACK == jinv._BUILDUP_MODEL_SLACK
    assert (tsc.TOY_SHAPES, tsc.MIN_SIZE, tsc.DEFAULT_CHUNK) == \
        (jsc.TOY_SHAPES, jsc.MIN_SIZE, jsc.DEFAULT_CHUNK)
    assert list(tsc.SCENARIOS) == list(jsc.SCENARIOS)
    for name, spec in tsc.SCENARIOS.items():
        ref = jsc.SCENARIOS[name]
        assert (spec.description, spec.tol_scale, spec.row_fault) == \
            (ref.description, ref.tol_scale, ref.row_fault)
        for workers, steps in ((8, 12), (64, 12), (16, 8), (2, 3)):
            a, b = spec.make(workers, steps), ref.make(workers, steps)
            assert (a is None) == (b is None)
            if a is not None:
                assert type(a).__name__ == type(b).__name__
                assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("n,target", [(63, 16), (64, 16), (7, 2), (15, 4), (16, 4), (1, 8)])
def test_elastic_groups(n, target):
    assert tsc.elastic_groups(n, target) == jsc.elastic_groups(n, target)


def test_drop_rejoin_membership_windows():
    injector = tinj.DropRejoinInjector(worker=2, drop_at=3, rejoin_at=6)
    world = (0, 1, 2, 3)
    assert injector.membership(0, world) == world
    assert injector.membership(3, world) == (0, 1, 3)
    assert injector.membership(5, world) == (0, 1, 3)
    assert injector.membership(6, world) == world


# -- the stream and the injectors ---------------------------------------------------------

def test_stream_is_a_pure_function_of_step_and_workers():
    stream = tsc.make_stream(8, device="cpu")
    full = stream(5, tuple(range(8)))
    again = stream(5, tuple(range(8)))
    alone = stream(5, (1,))
    survivors = stream(5, (0, 1, 2, 3, 4, 5, 6))
    for k in full:
        assert full[k].shape == (8,) + tsc.TOY_SHAPES[k] and full[k].dtype == torch.float32
        assert torch.equal(full[k], again[k])
        assert torch.equal(alone[k][0], full[k][1])  # the straggler's re-draw
        assert torch.equal(survivors[k], full[k][:7])
    other = stream(6, tuple(range(8)))
    assert not any(torch.equal(full[k], other[k]) for k in full)


def test_straggler_uses_its_own_delayed_rows():
    stream = tsc.make_stream(4, device="cpu")
    world = (0, 1, 2, 3)
    state = ScaleComState(residues={}, t=0)
    grads = stream(5, world)
    before = {k: v.clone() for k, v in grads.items()}
    ctx = tinj.StepContext(t=5, active=world, grads_pw=grads, state=state, notes={})
    ctx = tinj.StragglerInjector(worker=1, delay=2, start=3).inject(ctx, stream)
    delayed = stream(3, world)
    for k in grads:
        assert torch.equal(ctx.grads_pw[k][1], delayed[k][1])
        assert torch.equal(ctx.grads_pw[k][[0, 2, 3]], before[k][[0, 2, 3]])
        assert torch.equal(grads[k], before[k])  # the caller's tensors are untouched
    assert ctx.notes["straggler"] == {"worker": 1, "uses_step": 3}


def _state(rows, seed):
    gen = torch.Generator().manual_seed(seed)
    return ScaleComState(
        residues={"['a']": {"q": torch.randn((rows, 40), generator=gen)},
                  "['b']": {"q": torch.randn((rows, 24), generator=gen)}},
        t=0)


def test_stale_snapshot_is_a_copy():
    injector = tinj.StaleResidueInjector(worker=1, at=4, staleness=3)
    live = _state(4, 0)
    kept = {p: enc["q"].clone() for p, enc in live.residues.items()}
    injector.observe(1, live)
    for enc in live.residues.values():
        enc["q"].add_(1.0)  # the live state moves on in place
    ctx = tinj.StepContext(t=4, active=(0, 1, 2, 3), grads_pw={}, state=_state(4, 1), notes={})
    current = {p: enc["q"].clone() for p, enc in ctx.state.residues.items()}
    held = ctx.state
    ctx = injector.inject(ctx, None)
    for p, enc in ctx.state.residues.items():
        assert torch.equal(enc["q"][1], kept[p][1])  # reverted to the snapshot, not the live row
        assert torch.equal(enc["q"][[0, 2, 3]], current[p][[0, 2, 3]])
        assert torch.equal(held.residues[p]["q"], current[p])  # no write into the old state
    assert ctx.notes["stale_residue"] == {"worker": 1, "reverted_to": 1}


def test_corrupt_writes_a_copy_with_the_keyed_draw():
    state = _state(4, 0)
    current = {p: enc["q"].clone() for p, enc in state.residues.items()}
    ctx = tinj.StepContext(t=5, active=(0, 1, 2, 3), grads_pw={}, state=state, notes={})
    ctx = tinj.CorruptResidueInjector(worker=2, at=5, scale=2.0).inject(ctx, None)
    for i, p in enumerate(sorted(current)):
        q = ctx.state.residues[p]["q"]
        assert torch.equal(q[2], 2.0 * tinj.corrupt_draw(0x0BAD, i, (q.shape[1],)))
        assert torch.equal(q[[0, 1, 3]], current[p][[0, 1, 3]])
        assert torch.equal(state.residues[p]["q"], current[p])
    assert not torch.equal(tinj.corrupt_draw(0x0BAD, 0, (40,))[:24],
                           tinj.corrupt_draw(0x0BAD, 1, (24,)))


def test_clean_twin_cache_keys_on_the_fused_setting(monkeypatch):
    monkeypatch.setattr(tsc, "_CLEAN_CACHE", {})
    monkeypatch.delenv("SCALECOM_TORCH_FUSED", raising=False)
    tsc.run_scenario("stale", 8, steps=6, device="cpu")
    monkeypatch.setenv("SCALECOM_TORCH_FUSED", "1")
    res = tsc.run_scenario("stale", 8, steps=6, device="cpu")
    assert res.passed, res.violations
    keys = list(tsc._CLEAN_CACHE)
    assert len(keys) == 2 and {k[-3] for k in keys} == {"cpu"}
    assert {k[-2] for k in keys} == {False, True}


def test_run_scenario_without_cuda_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsc.run_scenario("baseline", 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.run_cli(["--scenarios", "baseline", "--workers", "8", "--no-buildup"])


# -- the CLI and --preflight-scenarios ----------------------------------------------------

def test_cli_runs_writes_and_reports(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SCENARIOS_JSON", str(tmp_path / "reference.json"))
    events = tmp_path / "events.jsonl"
    rc = tcli.run_cli(["--device", "cpu", "--scenarios", "drop,stale", "--workers", "8,16",
                       "--steps", "10", "--events-out", str(events), "-q"])
    assert rc == 0
    # the default output is the port's own file; the reference's env var is not read
    assert sorted(p.name for p in tmp_path.iterdir()) == ["BENCH_scenarios_torch.json",
                                                         "events.jsonl"]
    payload = json.loads((tmp_path / "BENCH_scenarios_torch.json").read_text())
    assert payload["passed"] and len(payload["results"]) == 8
    assert payload["config"]["device"] == "cpu"
    assert [int(r["workers"]) for r in payload["buildup"]["rows"]] == [8, 16]
    drops = [r for r in payload["results"] if r["name"] == "drop"]
    assert all(len(r["replans"]) == 2 for r in drops)
    kinds = [json.loads(line)["type"] for line in events.read_text().splitlines()]
    assert kinds[0] == "provenance" and kinds[-1] == "summary"
    assert kinds.count("scenario") == 8 and "violation" not in kinds
    capsys.readouterr()
    assert report.main([str(events)]) == 0
    assert "violations: none" in capsys.readouterr().out


def test_cli_out_env_and_unknown_scenario(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "env.json"
    monkeypatch.setenv("SCALECOM_TORCH_SCENARIOS_JSON", str(out))
    assert tcli.run_cli(["--device", "cpu", "--scenarios", "baseline", "--workers", "8",
                         "--steps", "4", "--no-buildup", "--flat-only", "-q"]) == 0
    assert json.loads(out.read_text())["passed"]
    assert tcli.run_cli(["--device", "cpu", "--scenarios", "baseline,meteor"]) == 2
    assert tcli.run_cli(["--list"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["env.json"]


def test_cli_exits_1_on_a_violation(tmp_path, monkeypatch):
    monkeypatch.setattr(tinv, "check_trajectory", lambda *a, **k: "forced violation")
    events = tmp_path / "events.jsonl"
    rc = tcli.run_cli(["--device", "cpu", "--scenarios", "baseline", "--workers", "8",
                       "--steps", "4", "--no-buildup", "--flat-only", "-q",
                       "--out", str(tmp_path / "o.json"), "--events-out", str(events)])
    assert rc == 1
    assert any(json.loads(line)["type"] == "violation" for line in events.read_text().splitlines())


@pytest.mark.parametrize("spec,want", [
    ("all", list(tsc.SCENARIOS)),
    ("drop, stale,", ["drop", "stale"]),
    ("corrupt", ["corrupt"]),
])
def test_scenario_names(spec, want):
    assert tsc.scenario_names(spec) == want


def test_preflight_passes_then_trains(capsys):
    history = train_cli.main(["--device", "cpu", "--preflight-scenarios", "all", "--workers", "8",
                              "--steps", "2", "--warmup-steps", "1", "--local-batch", "2",
                              "--seq", "16"])
    out = capsys.readouterr().out
    for name in tsc.SCENARIOS:
        assert f"[launch.train] preflight {name}: " in out
    assert "VIOLATION" not in out
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)


def test_preflight_violation_aborts_the_launch(monkeypatch, capsys):
    monkeypatch.setattr(tinv, "check_trajectory", lambda *a, **k: "forced violation")
    with pytest.raises(SystemExit, match="preflight scenario 'straggler' failed"):
        train_cli.main(["--device", "cpu", "--preflight-scenarios", "straggler", "--workers", "8",
                        "--steps", "2"])
    out = capsys.readouterr().out
    assert "VIOLATION" in out and "[launch.train]   forced violation" in out
