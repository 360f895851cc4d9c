"""repro_torch.obs.tracing.measured_bucket_timeline against the reference's
repro.obs.tracing.measured_bucket_timeline, on the CPU.

The tree is the reference's own test tree (tests/test_obs.py:_TREE_SIZES,
4 workers, chunk 8, min_size 1) at 1024-byte buckets, and unbucketed. The
bucket rows (count, leaves, dense and payload bytes) equal the reference's,
the modeled overlap timeline equals it to rtol 1e-12 (the same pure-Python
model), and the spans run plan, bucket[i] on track i + 1, reduce/full, each
with a positive time. Times are host times of the CPU and are not compared.
The reference's results are computed once for the module.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.compressors import CompressorConfig as JComp
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.obs.tracing import measured_bucket_timeline as jtimeline
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.scalecom import ScaleComConfig
from repro_torch.obs.tracing import Tracer, measured_bucket_timeline

TREE_SIZES = {"a": (96,), "b": (24, 16), "c": (520,), "tiny": (16,)}  # tests/test_obs.py
N, CHUNK = 4, 8
SPECS = {"1024 B buckets": 1024, "unbucketed": False}


def _grads():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in TREE_SIZES.items()}


@pytest.fixture(scope="module")
def runs():
    g = _grads()
    jcfg = JCfg(compressor=JComp("clt_k", chunk=CHUNK), beta=0.25, min_size=1)
    tcfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=0.25,
                          min_size=1)
    out = {}
    for label, spec in SPECS.items():
        ref = jtimeline(jax.tree.map(jax.numpy.asarray, g), jcfg, buckets=spec)
        got = measured_bucket_timeline({k: torch.from_numpy(v) for k, v in g.items()}, tcfg,
                                       buckets=spec)
        out[label] = (ref, got)
    return out


@pytest.mark.parametrize("label", list(SPECS))
def test_bucket_rows_are_the_reference_rows(runs, label):
    ref, got = runs[label]
    assert len(got["buckets"]) == len(ref["buckets"])
    if label == "1024 B buckets":
        assert len(got["buckets"]) >= 2
    for a, b in zip(got["buckets"], ref["buckets"]):
        assert a["bucket"] == b["bucket"]
        assert a["bytes_dense"] == b["bytes_dense"]
        assert a["bytes_payload"] == b["bytes_payload"]
        assert a["measured_us"] > 0


@pytest.mark.parametrize("label", list(SPECS))
def test_leaves_per_bucket_are_the_reference_leaves(runs, label):
    ref, got = runs[label]

    def leaves(out):
        return [s.args["n_leaves"] for s in out["tracer"].spans if s.name.startswith("bucket[")]

    assert leaves(got) == leaves(ref)


@pytest.mark.parametrize("label", list(SPECS))
def test_modeled_timeline_is_the_reference_model(runs, label):
    ref, got = runs[label]
    if ref["modeled"] is None:
        assert got["modeled"] is None
        return
    assert set(got["modeled"]) == set(ref["modeled"])
    for key, want in ref["modeled"].items():
        np.testing.assert_allclose(got["modeled"][key], want, rtol=1e-12, err_msg=key)


@pytest.mark.parametrize("label", list(SPECS))
def test_spans_run_plan_buckets_then_the_full_reduce(runs, label):
    ref, got = runs[label]
    names = [s.name for s in got["tracer"].spans]
    assert names == [s.name for s in ref["tracer"].spans]
    k = len(got["buckets"])
    assert names == ["plan"] + [f"bucket[{i}]" for i in range(k)] + ["reduce/full"]
    spans = got["tracer"].spans
    assert [s.tid for s in spans] == [0] + [i + 1 for i in range(k)] + [0]
    assert all(s.dur_us > 0 for s in spans)
    assert got["full_us"] > 0 and spans[-1].args["bucketed"] == (k > 0)
    assert got["device_kind"] == "cpu"
    assert all(a.ts_us <= b.ts_us for a, b in zip(spans, spans[1:]))


def test_spans_land_on_the_given_tracer():
    tracer = Tracer()
    g = {k: torch.from_numpy(v) for k, v in _grads().items()}
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), min_size=1)
    out = measured_bucket_timeline(g, cfg, buckets=1024, tracer=tracer)
    assert out["tracer"] is tracer and tracer.spans[0].name == "plan"
    assert tracer.chrome_trace()["traceEvents"][-1]["name"] == "reduce/full"
