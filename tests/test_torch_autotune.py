"""repro_torch.backends.autotune and introspect against the reference's
repro.backends.autotune, on the CPU.

Here the sweep times the plain versions (``device="cpu"``), so only the
cache plumbing is under test: the keys, the fallback chain, corrupt and
stale files, the atomic publish, the size buckets and the set of (op, size)
keys ``autotune_params`` sweeps. The reference's ``autotune_params`` is run
with its ``autotune`` stubbed, so no Pallas sweep runs. The block sizes the
card takes are read back from ``csrc/common.cuh``.
"""

import json
import os
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.backends import autotune as jat
from repro.configs import registry as jregistry
from repro.models import build_model as jbuild
from repro_torch import kernels
from repro_torch import tree
from repro_torch.backends import autotune, cuda_backend, introspect
from repro_torch.configs import registry
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.plan import plan_tensors
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import init_state
from repro_torch.kernels import build, chunk_topk, ef_update, fused_reduce
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model

CSRC = pathlib.Path(build.CSRC)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("SCALECOM_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_cache()
    yield path
    autotune.clear_cache()  # drop the tmp-path mirror for later tests


def test_cache_path_reads_its_own_env_var(monkeypatch):
    monkeypatch.delenv("SCALECOM_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("SCALECOM_AUTOTUNE_CACHE", "/reference/only.json")
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "scalecom_torch", "autotune.json")
    monkeypatch.setenv("SCALECOM_TORCH_AUTOTUNE_CACHE", "/port/cache.json")
    assert autotune.cache_path() == "/port/cache.json"


def test_cache_roundtrip_on_cpu(cache):
    best = autotune.autotune("select", 1024, 16, candidates=(64, 128), iters=1, device="cpu")
    assert best in (64, 128)
    assert json.loads(cache.read_text()) == {"cpu|select|c16|float32|nr64": best}
    # the read path the wrappers use returns the winner, for 33..64 rows
    assert autotune.best_threads("select", 64, 16, "cpu") == best
    assert autotune.best_threads("select", 33, 16, "cpu") == best
    # a miss (another op, chunk or bucket) is the default
    assert autotune.best_threads("ef_update", 64, 16, "cpu") == build.DEFAULT_THREADS
    assert autotune.best_threads("select", 64, 32, "cpu") == build.DEFAULT_THREADS
    assert autotune.best_threads("select", 65, 16, "cpu") == build.DEFAULT_THREADS
    # a new process reads the file
    autotune.clear_cache()
    assert autotune.best_threads("select", 64, 16, "cpu") == best


@pytest.mark.parametrize("op", ["select", "ef_update", "fused_reduce"])
def test_each_op_sweeps_on_cpu(cache, op):
    best = autotune.autotune(op, 256, 16, candidates=(512,), iters=1, device="cpu")
    assert best == 512
    # fused_reduce runs on a 4-worker stack and is keyed by all its rows
    rows = 4 * 16 if op == "fused_reduce" else 16
    assert json.loads(cache.read_text()) == {f"cpu|{op}|c16|float32|nr{rows}": 512}
    assert autotune.best_threads(op, rows, 16, "cpu") == 512


def test_autotune_needs_a_card_unless_cpu_is_asked_for(cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune("select", 256, 16, candidates=(64,), iters=1)
    assert not cache.exists()


@pytest.mark.parametrize("entry", ["autotune", "best_threads"])
def test_unknown_op_raises(cache, entry):
    with pytest.raises(ValueError, match="select"):
        if entry == "autotune":
            autotune.autotune("softmax", 64, 16, device="cpu")
        else:
            autotune.best_threads("softmax", 64, 16, "cpu")


def test_fused_reduce_falls_back_to_ef_update(cache):
    key = autotune._key
    assert autotune.best_threads("fused_reduce", 64, 16, "cpu") == 256
    cache.write_text(json.dumps({key("ef_update", 16, 64, "cpu"): 128}))
    autotune.clear_cache()
    assert autotune.best_threads("fused_reduce", 64, 16, "cpu") == 128
    # its own entry wins once a fused sweep ran
    cache.write_text(json.dumps({key("ef_update", 16, 64, "cpu"): 128,
                                 key("fused_reduce", 16, 64, "cpu"): 1024}))
    autotune.clear_cache()
    assert autotune.best_threads("fused_reduce", 64, 16, "cpu") == 1024
    # the chain goes no further, and select borrows from nobody
    cache.write_text(json.dumps({key("select", 16, 64, "cpu"): 64}))
    autotune.clear_cache()
    assert autotune.best_threads("fused_reduce", 64, 16, "cpu") == 256
    assert autotune.best_threads("ef_update", 64, 16, "cpu") == 256


@pytest.mark.parametrize("value", [7, 2048, 0, -256])
def test_stale_value_reads_as_the_default(cache, value):
    cache.write_text(json.dumps({autotune._key("ef_update", 16, 64, "cpu"): value}))
    autotune.clear_cache()
    assert autotune.best_threads("ef_update", 64, 16, "cpu") == build.DEFAULT_THREADS
    # nor does the fallback launder it
    assert autotune.best_threads("fused_reduce", 64, 16, "cpu") == build.DEFAULT_THREADS


@pytest.mark.parametrize("garbage", ['{"k": 128', "", "[1, 2, 3]", '"a bare string"', "\x00\x01",
                                     '{"k": "x"}'])
def test_corrupt_cache_reads_as_empty(cache, garbage):
    cache.write_text(garbage)
    assert autotune.best_threads("select", 64, 16, "cpu") == build.DEFAULT_THREADS
    # the write path sweeps again and publishes a valid file
    assert autotune.autotune("select", 256, 16, candidates=(64,), iters=1, device="cpu") == 64
    assert isinstance(json.loads(cache.read_text()), dict)


def test_store_is_atomic_and_leaves_no_temp_file(cache, monkeypatch):
    replaced = []
    real_replace = os.replace

    def spy(src, dst):
        assert isinstance(json.loads(pathlib.Path(src).read_text()), dict)  # whole at replace time
        replaced.append((src, dst))
        real_replace(src, dst)

    monkeypatch.setattr(autotune.os, "replace", spy)
    autotune.autotune("select", 256, 16, candidates=(64,), iters=1, device="cpu")
    autotune.autotune("ef_update", 256, 16, candidates=(128,), iters=1, device="cpu")
    assert len(replaced) == 2 and all(dst == str(cache) for _, dst in replaced)
    assert len(json.loads(cache.read_text())) == 2
    assert os.listdir(cache.parent) == ["autotune.json"]


def test_read_only_file_system_keeps_the_mirror(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv("SCALECOM_TORCH_AUTOTUNE_CACHE", str(blocker / "autotune.json"))
    autotune.clear_cache()
    try:
        assert autotune.autotune("select", 256, 16, candidates=(1024,), iters=1,
                                 device="cpu") == 1024
        assert autotune.best_threads("select", 16, 16, "cpu") == 1024
    finally:
        autotune.clear_cache()


def test_bucket_is_the_reference_bucket():
    assert [autotune._bucket(n) for n in range(4097)] == [jat._bucket(n) for n in range(4097)]


def test_autotune_params_sweeps_the_reference_keys(cache, monkeypatch):
    """The (op, size) keys over the SMOKE paper transformer, at min_size 1024
    and 16, equal the reference's with both sweeps stubbed."""
    arch = "paper-transformer-base"
    jparams, _ = jbuild(jregistry.smoke(arch), compute_dtype="float32").init(
        jax.random.PRNGKey(0))
    tparams = build_model(registry.smoke(arch), compute_dtype="float32").init(
        torch.Generator().manual_seed(0), "cpu")
    calls = []
    monkeypatch.setattr(jat, "autotune", lambda op, size, chunk, dtype, **kw: 128)
    monkeypatch.setattr(autotune, "autotune",
                        lambda op, size, chunk, **kw: calls.append((op, size, kw)) or 128)
    for min_size in (1024, 16):
        want = jat.autotune_params(jparams, 64, min_size=min_size)
        got = autotune.autotune_params(tparams, 64, min_size=min_size, device="cpu")
        assert got == want and len(got) > 3
    assert {kw["device"] for _, _, kw in calls} == {"cpu"}


@pytest.mark.parametrize("layout", ["flat", "rowwise"])
@pytest.mark.parametrize("workers", [3, 8])
def test_autotune_params_writes_the_keys_the_launches_read(cache, workers, layout):
    """At the run's worker count the sweep writes, for every compressed tensor
    of the SMOKE paper transformer, the key its stacked launches look up:
    all the launch's rows, workers x the plan's chunk rows."""
    tparams = build_model(registry.smoke("paper-transformer-base"), compute_dtype="float32").init(
        torch.Generator().manual_seed(0), "cpu")
    wins = autotune.autotune_params(tparams, 64, min_size=1024, workers=workers,
                                    candidates=(128,), iters=1, device="cpu")
    assert set(wins.values()) == {128}
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=64), min_size=1024,
                         layout=layout)
    plans = plan_tensors(tuple((p, tuple(v.shape), workers)
                               for p, v in tree.flatten_with_path(tparams)),
                         cfg, [p for p, _ in tree.flatten_with_path(tparams)])
    compressed = [p for p in plans if not p.dense]
    assert len(compressed) > 3
    entries = json.loads(cache.read_text())
    for p in compressed:
        for op in ("select", "ef_update", "fused_reduce"):
            assert entries[autotune._key(op, 64, workers * p.n_chunks, "cpu")] == 128, (p, op)
    # nothing swept that no launch reads
    read = {autotune._key(op, 64, workers * p.n_chunks, "cpu")
            for p in compressed for op in ("select", "ef_update", "fused_reduce")}
    assert set(entries) == read


def test_kernels_know_nothing_of_the_cache():
    """The CUDA backend picks the tuned block sizes; the kernel wrappers
    import nothing of the backends, and take the default when given none."""
    for path in pathlib.Path(build.__file__).parent.glob("*.py"):
        assert not re.search(r"^\s*(from|import) repro_torch\.backends", path.read_text(),
                             re.M), path
    assert cuda_backend._threads("select", torch.zeros(4, 16), 4, 16) is None


def _cuh(name):
    return (CSRC / name).read_text()


def test_candidates_and_default_are_the_sources():
    seq = re.search(r"using TunedThreads = std::integer_sequence<int, ([\d, ]+)>;",
                    _cuh("common.cuh"))
    default = re.search(r"constexpr int kDefaultThreads = (\d+);", _cuh("common.cuh"))
    assert tuple(int(v) for v in seq.group(1).split(",")) == build.CANDIDATE_THREADS
    assert autotune.CANDIDATE_THREADS == build.CANDIDATE_THREADS == (64, 128, 256, 512, 1024)
    assert int(default.group(1)) == build.DEFAULT_THREADS == 256
    # the reference sweeps five tile heights; the port five block sizes
    assert len(build.CANDIDATE_THREADS) == len(jat.CANDIDATE_BLOCKS)
    # the tuned kernels' default sizes are that default
    assert "constexpr int kSelectThreads = kDefaultThreads;" in _cuh("chunk_select.cuh")
    assert "constexpr int kFusedThreads = kDefaultThreads;" in _cuh("fused_reduce_vec4.cuh")


def _small(seed=0, G=3, rows=5, chunk=16):
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.standard_normal((G, rows, chunk)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((G, rows, chunk)).astype(np.float32))
    return m, g


@pytest.mark.parametrize("threads", [100, 2048, 0, 256.0, True])
def test_wrappers_refuse_a_size_outside_the_candidates(threads):
    m, g = _small()
    idx = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="threads"):
        chunk_topk.chunk_argmax(m[0], threads=threads)
    with pytest.raises(ValueError, match="threads"):
        ef_update.ef_update(m[0], g[0], idx, 0.1, threads=threads)
    with pytest.raises(ValueError, match="threads"):
        fused_reduce.fused_reduce(m, g, 0.1, 1, "clt_k", 0, threads=threads)


@pytest.mark.parametrize("threads", build.CANDIDATE_THREADS)
def test_every_candidate_is_the_plain_version_on_cpu(threads):
    m, g = _small(seed=threads)
    idx = torch.arange(5, dtype=torch.int32) % 16
    for got, want in (
        (chunk_topk.chunk_argmax(m[1], threads=threads), chunk_topk.chunk_argmax_plain(m[1])),
        (ef_update.ef_update(m[1], g[1], idx, 0.1, threads=threads),
         ef_update.ef_update_plain(m[1], g[1], idx, 0.1)),
        (fused_reduce.fused_reduce(m, g, 0.1, 1, "clt_k", 2, threads=threads),
         fused_reduce.fused_reduce_plain(m, g, 0.1, 1, "clt_k", 2)),
    ):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_reset_launches_zeroes_the_block_size_counts():
    for k in (chunk_topk.chunk_argmax, ef_update.ef_update, fused_reduce.fused_reduce):
        assert set(k.threads) == set(build.CANDIDATE_THREADS)
        k.threads[512] += 3
    kernels.reset_launches()
    for k in (chunk_topk.chunk_argmax, ef_update.ef_update, fused_reduce.fused_reduce):
        assert k.threads == dict.fromkeys(build.CANDIDATE_THREADS, 0)


@pytest.mark.parametrize("fused", [False, True])
def test_count_launches_is_zero_on_cpu_tensors(fused):
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.standard_normal((4, 8, 64)).astype(np.float32))}
    cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=16), min_size=1,
                         backend="cuda", fused=fused)
    state = init_state({"w": g["w"][0]}, 4, min_size=1)
    got = introspect.count_launches(scalecom_reduce, g, state, cfg)
    assert got == dict.fromkeys(kernels.launches(), 0)


def test_cli_autotune_on_cpu_skips_and_trains(cache, capsys):
    history = train_cli.main(["--device", "cpu", "--workers", "2", "--steps", "2",
                              "--warmup-steps", "1", "--local-batch", "1", "--seq", "16",
                              "--autotune"])
    out = capsys.readouterr().out
    assert ("[launch.train] --autotune skipped: backend=torch never consults the CUDA "
            "launch cache") in out
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    assert not cache.exists()
