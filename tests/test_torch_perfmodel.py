"""``repro_torch.analysis.perfmodel`` against ``repro.analysis.perfmodel``.

Both are pure Python, so every public function must give exactly the
reference's numbers on the same inputs.
"""

import dataclasses
import itertools

import pytest

from repro.analysis import perfmodel as jpm
from repro_torch.analysis import perfmodel as tpm

SCHEMES = ("none", "local_topk", "scalecom")
CONFIGS = [
    dict(),
    dict(topology="ring"),
    dict(workers=32, minibatch=32),
    dict(workers=128, topology="ring", compression=64.0, peak_flops=300e12),
    dict(workers=1, params=1e6, bandwidth=1e9, hbm_bw=3.35e12),
]


def _pair(**kw):
    return jpm.PerfConfig(**kw), tpm.PerfConfig(**kw)


def test_public_names_are_the_reference_names():
    assert tpm.__all__ == jpm.__all__
    assert tpm.GRAD_BYTES == jpm.GRAD_BYTES
    assert dataclasses.asdict(tpm.PerfConfig()) == dataclasses.asdict(jpm.PerfConfig())


@pytest.mark.parametrize("kw,scheme", list(itertools.product(CONFIGS, SCHEMES)))
def test_step_time(kw, scheme):
    j, t = _pair(**kw)
    assert tpm.step_time(t, scheme) == jpm.step_time(j, scheme)


@pytest.mark.parametrize("kw", CONFIGS)
def test_unknown_scheme_raises_as_the_reference(kw):
    j, t = _pair(**kw)
    with pytest.raises(ValueError, match="bogus"):
        jpm.step_time(j, "bogus")
    with pytest.raises(ValueError, match="bogus"):
        tpm.step_time(t, "bogus")


@pytest.mark.parametrize("fused,workers,chunk,topm",
                         list(itertools.product((False, True), (1, 8, 64), (16, 64), (1, 2))))
def test_reduce_hbm_passes(fused, workers, chunk, topm):
    assert (tpm.reduce_hbm_passes(fused, workers, chunk, topm)
            == jpm.reduce_hbm_passes(fused, workers, chunk, topm))


@pytest.mark.parametrize("size,workers,dtype_bytes", [(2304, 8, 4), (18_944_000, 64, 2), (1, 1, 1)])
def test_fused_hbm_report(size, workers, dtype_bytes):
    assert (tpm.fused_hbm_report(size, workers, dtype_bytes, 64, 2)
            == jpm.fused_hbm_report(size, workers, dtype_bytes, 64, 2))


@pytest.mark.parametrize("workers,chunk,topm",
                         list(itertools.product((1, 8, 16, 63, 64, 128), (16, 64), (1, 2, 8))))
def test_buildup_ratio_model(workers, chunk, topm):
    assert (tpm.buildup_ratio_model(workers, chunk, topm)
            == jpm.buildup_ratio_model(workers, chunk, topm))


def test_buildup_ratio_model_rejects_no_workers():
    for mod in (jpm, tpm):
        with pytest.raises(ValueError, match="workers must be >= 1"):
            mod.buildup_ratio_model(0, 16)


@pytest.mark.parametrize("workers_list,chunk,topm",
                         [((8, 16, 32, 64), 64, 1), ((8, 64), 16, 2), ((1,), 16, 1)])
def test_buildup_curve(workers_list, chunk, topm):
    assert (tpm.buildup_curve(workers_list, chunk, topm)
            == jpm.buildup_curve(workers_list, chunk, topm))


@pytest.mark.parametrize("overrides", [dict(), dict(workers=64), dict(params=1e6, minibatch=1)])
def test_reference_transformer_perf(overrides):
    assert (dataclasses.asdict(tpm.reference_transformer_perf(**overrides))
            == dataclasses.asdict(jpm.reference_transformer_perf(**overrides)))


@pytest.mark.parametrize("scheme,bucket_bytes",
                         list(itertools.product(SCHEMES, (4 << 20, 25 << 20, 1e12))))
def test_overlap_timeline_and_report(scheme, bucket_bytes):
    j, t = jpm.reference_transformer_perf(), tpm.reference_transformer_perf()
    assert (tpm.overlap_timeline(t, scheme, bucket_bytes)
            == jpm.overlap_timeline(j, scheme, bucket_bytes))
    assert tpm.overlap_report(t, scheme, bucket_bytes) == jpm.overlap_report(j, scheme, bucket_bytes)


def test_overlap_timeline_rejects_empty_buckets():
    for mod in (jpm, tpm):
        with pytest.raises(ValueError, match="bucket_bytes must be positive"):
            mod.overlap_timeline(mod.PerfConfig(), "scalecom", 0)


def test_fig6_sweep():
    assert tpm.fig6_sweep() == jpm.fig6_sweep()
