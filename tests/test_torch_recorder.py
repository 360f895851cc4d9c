"""repro_torch's telemetry recorder (``repro_torch.obs``) against ``repro.obs``.

One 4-step CPU run (2 dense warm-up steps, then clt_k with the taps on and
``metrics_every`` 2) from a carried-across TrainState, once through each
package's ``run_training(telemetry=TelemetryRun(...))``. The two event logs
hold the same event types in the same order and the same metric keys at
every step; losses agree to rtol 1e-3, as in the 6-step training parity.
The port's ``summarize`` of either log equals the reference's, and its
``MetricRegistry`` summary equals the reference's on the same metrics. The
CLI writes the trace, the event log and a checkpoint with ``--device cpu``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import registry as jregistry
from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.data import make_batches as jmake_batches
from repro.models import build_model as jbuild
from repro.obs import report as jreport
from repro.optim import make_optimizer as jmake_opt
from repro.optim import schedule as jschedule
from repro.training import TrainLoop as JLoop
from repro.training import init_train_state as jinit
from repro.training import run_training as jrun
from repro_torch import checkpoint, obs
from repro_torch.backends import resolve_fused
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.data import make_batches
from repro_torch.launch import train as cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.obs import report
from repro_torch.optim import make_optimizer, schedule
from repro_torch.training import TrainLoop, TrainState, init_train_state, run_training

ARCH = "paper-transformer-base"
N, LOCAL_B, SEQ, CHUNK, MIN_SIZE, LR, STEPS = 4, 2, 32, 16, 512, 0.05, 4
EXTRA = {"arch": ARCH, "compressor": "clt_k", "workers": N}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' telemetry runs of the same configuration, made once."""
    root = tmp_path_factory.mktemp("recorder")
    kw = dict(beta=0.1, min_size=MIN_SIZE, warmup_steps=2, telemetry=True, metrics_every=2)
    jcfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), backend="jnp", fused=False, **kw)
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), backend="torch",
                          **kw)
    jmodel = jbuild(jregistry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    tmodel = build_model(registry.smoke(ARCH), compute_dtype="float32", loss_chunk=16)
    jopt = jmake_opt("sgdm")
    js, _ = jinit(jmodel, jopt, jcfg, jax.random.PRNGKey(0), n_workers=N)
    ts = TrainState(params=params_from_jax(js.params, "cpu"),
                    opt_state={"m": params_from_jax(js.opt_state["m"], "cpu")},
                    sc_state=state_from_jax(js.sc_state, "cpu"), step=0)
    jloop = JLoop(model=jmodel, optimizer=jopt, schedule=jschedule.constant(LR), sc_cfg=jcfg,
                  n_workers=N, log_every=1)
    tloop = TrainLoop(model=tmodel, optimizer=make_optimizer("sgdm"),
                      schedule=schedule.constant(LR), sc_cfg=tcfg, n_workers=N, log_every=1)
    jrec = jobs.TelemetryRun(str(root / "jax"), backend_name="jnp", extra_provenance=EXTRA)
    _, jh = jrun(jloop, js, jmake_batches(512, N, LOCAL_B, SEQ, seed=0), STEPS, log=None,
                 telemetry=jrec)
    jrec.close()
    with obs.TelemetryRun(str(root / "torch"), backend_name="torch",
                          extra_provenance=EXTRA) as trec:
        _, th = run_training(tloop, ts, make_batches(512, N, LOCAL_B, SEQ, seed=0), STEPS,
                             log=None, telemetry=trec)
    return {"root": root, "jax": root / "jax" / "events.jsonl",
            "torch": root / "torch" / "events.jsonl", "jh": jh, "th": th, "trec": trec}


def _events(path):
    return obs.read_events(str(path))


def test_event_types_match_jax(runs):
    types = [e["type"] for e in _events(runs["torch"])]
    assert types == [e["type"] for e in _events(runs["jax"])]
    assert types == ["provenance"] + ["step"] * STEPS + ["span"] * STEPS + ["summary"]


def test_step_metric_keys_match_jax(runs):
    tsteps = [e for e in _events(runs["torch"]) if e["type"] == "step"]
    jsteps = [e for e in _events(runs["jax"]) if e["type"] == "step"]
    assert [e["step"] for e in tsteps] == list(range(STEPS))
    for te, je in zip(tsteps, jsteps):
        assert sorted(te["metrics"]) == sorted(je["metrics"]), te["step"]
    assert any(k.startswith("obs/") for k in tsteps[-1]["metrics"])


def test_losses_match_jax(runs):
    losses = lambda p: [e["metrics"]["loss"] for e in _events(p) if e["type"] == "step"]
    np.testing.assert_allclose(losses(runs["torch"]), losses(runs["jax"]), rtol=1e-3)
    np.testing.assert_allclose([h["loss"] for h in runs["th"]], losses(runs["torch"]),
                               rtol=1e-7)


@pytest.mark.parametrize("log", ["torch", "jax"])
def test_summarize_matches_jax(runs, log):
    assert report.summarize(str(runs[log])) == jreport.summarize(str(runs[log]))


def test_summary_event_matches_jax_registry(runs):
    """The port's registry summary of the port's step metrics equals the
    reference registry's summary of the same metrics."""
    jreg = jobs.MetricRegistry()
    for e in _events(runs["torch"]):
        if e["type"] == "step":
            jreg.record_stats(e["metrics"])
    summary = [e for e in _events(runs["torch"]) if e["type"] == "summary"][0]
    assert summary["metrics"] == json.loads(json.dumps(jreg.summary()))


def test_trace_is_a_chrome_trace_of_the_steps(runs):
    with open(runs["root"] / "torch" / "trace.json") as f:
        trace = json.load(f)
    steps = [e for e in trace["traceEvents"] if e["name"] == "step"]
    assert [e["args"]["step"] for e in steps] == list(range(STEPS))
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in steps)
    assert trace["metadata"]["workers"] == N


def test_provenance_names_torch_and_the_device(runs):
    prov = _events(runs["torch"])[0]
    assert prov["type"] == "provenance"
    assert prov["torch_version"] and prov["python_version"]
    assert prov["device_kind"] == "cpu" and prov["card_name"] is None
    assert prov["power_limit"] is None and prov["cuda_version"] is None
    assert prov["backend"] == "torch" and prov["fused"] == resolve_fused("auto")
    assert {k: prov[k] for k in EXTRA} == EXTRA


def test_close_is_idempotent(runs):
    before = _events(runs["torch"])
    paths = runs["trec"].close()
    assert paths == {"trace": str(runs["root"] / "torch" / "trace.json"),
                     "events": str(runs["torch"])}
    assert _events(runs["torch"]) == before


def test_violation_is_an_event_and_an_instant(tmp_path):
    run = obs.TelemetryRun(str(tmp_path))
    run.violation("build-up above 1", step=3)
    run.close()
    ev = [e for e in obs.read_events(run.events_path) if e["type"] == "violation"]
    assert ev[0]["message"] == "build-up above 1" and ev[0]["step"] == 3
    assert report.main([run.events_path]) == 1  # a violation fails the report


def test_report_cli_json(runs, capsys):
    assert report.main([str(runs["torch"]), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps"] == STEPS and out["violations"] == []


def test_logger_root_is_repro_torch():
    assert obs.get_logger("training").name == "repro_torch.training"
    logger = obs.enable_console_logging()
    n = len(logger.handlers)
    assert obs.enable_console_logging() is logger and len(logger.handlers) == n


def test_cli_writes_trace_events_and_checkpoint(tmp_path, capsys):
    trace, ck = tmp_path / "trace", tmp_path / "ck"
    history = cli.main(["--device", "cpu", "--workers", "2", "--local-batch", "2", "--seq", "16",
                        "--steps", "4", "--warmup-steps", "2", "--log-every", "1",
                        "--trace-dir", str(trace), "--metrics-every", "1",
                        "--checkpoint-dir", str(ck)])
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert f"events -> {trace / 'events.jsonl'}" in capsys.readouterr().out
    summary = report.summarize(str(trace / "events.jsonl"))
    assert summary["steps"] == 4 and summary["provenance"]["workers"] == 2
    assert summary["similarity"]["spearman_rho"]  # metrics_every 1 sampled the compressed steps
    assert json.load(open(trace / "trace.json"))["traceEvents"]
    # checkpoint_every = steps // 2: saved after step 2
    assert checkpoint.latest_step(str(ck)) == 2 and os.path.exists(ck / "ckpt_00000002.npz")
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=64), min_size=1024)
    like = init_train_state(build_model(registry.smoke(ARCH), compute_dtype="float32",
                                        loss_chunk=64),
                            make_optimizer("sgdm"), cfg, torch.Generator(),
                            n_workers=2, device="cpu")
    restored = checkpoint.restore(str(ck), like)
    assert restored.step == 3 and restored.sc_state.t == 3


def test_cli_metrics_every_needs_trace_dir(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", "--metrics-every", "2"])
    assert exc.value.code == 2
    assert "--metrics-every requires --trace-dir" in capsys.readouterr().err
