"""The group step's bucketed, telemetry, fused and exact configurations, on
gloo between processes.

Four rank processes (``_torch_ring_group_path_ranks.rank_main``, spawned
once for the module, one torch thread each, rendezvous through a
``file://`` store under the test's temporary directory) each hold one
ScaleCom worker and run ``train_step._group_reduce`` on its row of a small
tree (four compressed tensors of distinct sizes, one off the chunk, and one
dense) at t = 0..3, each rank leading once. The test process computes the
references meanwhile: JAX's single-device ``scalecom_reduce`` run eagerly
(jitted, XLA's CPU contracts Eq. 5 into an FMA) with JAX's ``select_indices``
or exact ``compress`` for the offsets, and the port's stacked reduce with
telemetry for the taps.

- Each configuration against JAX: offsets bitwise, m' and ĝ to rtol 1e-6 /
  atol 1e-7, ĝ bitwise the same on every rank; the payload each rank counts
  averages to the plan's bytes.
- Buckets (16 KB and 40 KB, overlap on and off, $SCALECOM_TORCH_BUCKET_MB=4;
  true_topk, ``groups=2``, fused and exact at 40 KB): offsets and m' bitwise the unbucketed step's,
  ĝ within rtol 1e-6 / atol 1e-7 (the values are packed); every rank issues
  the same calls in the same order, async, fewer than unbucketed.
- Telemetry (bf16 residues, metrics_every 1; bucketed with compute_stats):
  ĝ, m' and offsets bitwise telemetry off; the taps' keys the stacked
  step's, their values the same on every rank and within tolerance of the
  stacked step's (the rank taps: near ties counted); the bytes under
  ``sent["telemetry"]``.
- Fused (clt_k and true_topk through the "cuda" backend, whose wrapper runs
  ``fused_select_update_plain`` on CPU tensors; $SCALECOM_TORCH_FUSED=1):
  offsets, m' and ĝ bitwise the unfused step's, the plain twin called on
  the leader alone, once a compressed tensor.
- Exact, clt_k and true_topk: against JAX's exact path.
"""

import concurrent.futures
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ring_group_path_ranks as ranks
from repro.backends import resolve_backend as jresolve
from repro.core.compressors import CompressorConfig as JComp
from repro.core.compressors import compress as jcompress
from repro.core.compressors import select_indices as jselect
from repro.core.scalecom import ScaleComConfig as JCfg
from repro.core.scalecom import scalecom_reduce as jreduce
from repro.core.state import ScaleComState as JState
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.plan import plan_buckets, plan_tensors
from repro_torch.core.scalecom import ScaleComConfig, scalecom_reduce
from repro_torch.core.state import CODECS, ScaleComState

N = 4
TS = (0, 1, 2, 3)
CHUNK, BETA, MIN_SIZE = 16, 0.3, 512
# four compressed tensors of distinct sizes (the ranks key offsets by size),
# one off the chunk, and one dense
TREE = {"a": (4133,), "b": (4096,), "c": (100,), "d": (2048,), "e": (3072,)}
COMPRESSED = {k: s[0] for k, s in TREE.items() if s[0] >= MIN_SIZE}
BUCKET_BYTES = 16 << 10
RING_TOL = dict(rtol=1e-6, atol=1e-7)
SCALE = 0.01  # of the gradients and residues: a 4-term sum in another order
# then moves ĝ by at most 3u * sum|v| (~1.4e-8), within RING_TOL's atol
TIMEOUT_S = 240

# label: the case's settings (ScaleComConfig fields, buckets, env, stats) and
# the JAX reference it is held to, or None
CASES = {
    "plain": dict(),
    "true_topk": dict(compressor="true_topk"),
    "groups2": dict(groups=2),
    "buckets_16k": dict(buckets=16 << 10),
    "buckets_16k_no_overlap": dict(buckets=16 << 10, overlap=False),
    "buckets_40k": dict(buckets=40 << 10),
    "buckets_40k_no_overlap": dict(buckets=40 << 10, overlap=False),
    "buckets_env": dict(buckets=None, env={"SCALECOM_TORCH_BUCKET_MB": "4"}),
    "buckets_true_topk": dict(compressor="true_topk", buckets=40 << 10),
    "buckets_groups2": dict(groups=2, buckets=40 << 10),
    "buckets_fused": dict(backend="cuda", fused=True, buckets=40 << 10),
    "buckets_exact": dict(exact=True, buckets=40 << 10),
    "bf16": dict(codec="bf16"),
    "telemetry": dict(codec="bf16", telemetry=True, metrics_every=1),
    "telemetry_buckets_stats": dict(codec="bf16", telemetry=True, metrics_every=2,
                                    buckets=True, stats=True),
    "unfused_cuda": dict(backend="cuda"),
    "fused": dict(backend="cuda", fused=True),
    "fused_env": dict(backend="cuda", fused="auto", env={"SCALECOM_TORCH_FUSED": "1"}),
    "true_topk_cuda": dict(compressor="true_topk", backend="cuda"),
    "fused_true_topk": dict(compressor="true_topk", backend="cuda", fused=True),
    "exact": dict(exact=True),
    "exact_true_topk": dict(compressor="true_topk", exact=True),
}
# a bucketed case: the unbucketed case it is held to bitwise
BUCKETED = {
    "buckets_16k": "plain", "buckets_16k_no_overlap": "plain", "buckets_40k": "plain",
    "buckets_40k_no_overlap": "plain", "buckets_env": "plain", "buckets_true_topk": "true_topk",
    "buckets_groups2": "groups2", "buckets_fused": "plain", "buckets_exact": "exact",
}
# a fused, telemetry or backend case: the case it is bitwise
BITWISE = {
    "telemetry": "bf16", "telemetry_buckets_stats": "bf16", "unfused_cuda": "plain",
    "fused": "plain", "fused_env": "plain", "true_topk_cuda": "true_topk",
    "fused_true_topk": "true_topk",
}
# the cases held against JAX directly: label -> (compressor, exact, groups, codec)
JAX_CASES = {
    "plain": ("clt_k", False, None, "fp32"), "true_topk": ("true_topk", False, None, "fp32"),
    "groups2": ("clt_k", False, 2, "fp32"), "exact": ("clt_k", True, None, "fp32"),
    "exact_true_topk": ("true_topk", True, None, "fp32"),
}
# rank taps whose values may move where the worker mean's rounding moves a
# near tie
RANK_TAPS = ("hamming_d_over_k", "topk_energy_overlap", "spearman_rho")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _inputs():
    """The worker-stacked tree, and its fp32 residue rows encoded by each
    codec the cases use (N rows, and 2 for groups=2)."""
    rng = np.random.default_rng(0)
    grads = {k: (SCALE * rng.standard_normal((N,) + s)).astype(np.float32)
             for k, s in TREE.items()}
    rows = {G: {f"['{k}']": (SCALE * rng.standard_normal((G, size))).astype(np.float32)
                for k, size in COMPRESSED.items()} for G in (N, 2)}
    residues = {}
    for codec, G in (("fp32", None), ("fp32", 2), ("bf16", None)):
        residues[codec, G] = {p: CODECS[codec].encode(torch.from_numpy(x), (x.shape[1],))
                              for p, x in rows[G or N].items()}
    return grads, rows, residues


def _jax_reference(grads, rows) -> dict:
    """JAX's stacked reduce of each JAX_CASES case at each t, eagerly, with
    the offsets of each compressed tensor."""
    be = jresolve("jnp")
    tree = {k: jnp.asarray(v) for k, v in grads.items()}
    out = {}
    for label, (name, exact, groups, codec) in JAX_CASES.items():
        comp = JComp(name, chunk=CHUNK, exact=exact)
        cfg = JCfg(compressor=comp, beta=BETA, min_size=MIN_SIZE, residue_dtype=codec,
                   groups=groups, backend="jnp", fused=False, layout="flat")
        res = {p: {"q": jnp.asarray(x)} for p, x in rows[groups or N].items()}
        for t in TS:
            ghat, st, _ = jreduce(tree, JState(res, jnp.int32(t)), cfg)
            offsets = {}
            if groups is None:
                for k, size in COMPRESSED.items():
                    ef = res[f"['{k}']"]["q"] + tree[k]
                    idx = (jcompress(ef, jnp.int32(t), comp)[1] if exact else
                           jselect(ef, jnp.int32(t), comp, be))
                    offsets[size] = np.asarray(idx)
            out[label, t] = ({k: np.asarray(v) for k, v in ghat.items()},
                             {p: np.asarray(e["q"]) for p, e in st.residues.items()}, offsets)
    return out


def _stacked_taps(grads, residues) -> dict:
    """The port's stacked reduce of the telemetry cases (same settings, the
    whole stack) at each t: its stats, taps included."""
    out = {}
    stacked = {k: torch.from_numpy(v) for k, v in grads.items()}
    for label in ("telemetry", "telemetry_buckets_stats"):
        case = CASES[label]
        cfg = ScaleComConfig(compressor=CompressorConfig("clt_k", chunk=CHUNK), beta=BETA,
                             min_size=MIN_SIZE, residue_dtype=case["codec"], backend="torch",
                             fused=False, layout="flat", telemetry=True,
                             metrics_every=case["metrics_every"], bucket_bytes=BUCKET_BYTES)
        for t in TS:
            _, _, stats = scalecom_reduce(stacked, ScaleComState(residues["bf16", None], t), cfg,
                                          compute_stats=case.get("stats", False),
                                          buckets=case.get("buckets", False))
            out[label, t] = {k: float(v) for k, v in stats.items()}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_group_paths")
    grads, rows, residues = _inputs()
    job = {"tree": grads, "residues": residues, "cases": CASES, "chunk": CHUNK, "beta": BETA,
           "min_size": MIN_SIZE, "bucket_bytes": BUCKET_BYTES, "ts": TS}
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(N)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, N, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(N)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()  # a rank that dies then breaks its pipe: no send waits on it
    try:
        for parent, _ in pipes:
            parent.send(job)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            taps = pool.submit(_stacked_taps, grads, residues)
            jax_ref = _jax_reference(grads, rows)
            stacked = taps.result(TIMEOUT_S)
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
    return {"ranks": results, "jax": jax_ref, "stacked": stacked}


def _row(label: str, rank: int) -> int:
    groups = CASES[label].get("groups")
    return rank if groups is None else rank // (N // groups)


def _jax_label(label: str) -> str:
    """The JAX case a label is held to, through the case it is bitwise."""
    label = BUCKETED.get(label, label)
    return BITWISE.get(label, label)


@pytest.mark.parametrize("label", [k for k in CASES if _jax_label(k) in JAX_CASES])
def test_group_reduce_matches_jax(world, label):
    ref = _jax_label(label)
    for t in TS:
        jghat, jres, joffsets = world["jax"][ref, t]
        ghats = []
        for r, res in enumerate(world["ranks"]):
            got = res[label, t]
            assert got["t"] == t + 1
            for size, want in joffsets.items():
                np.testing.assert_array_equal(got["offsets"][size], want,
                                              err_msg=f"offsets {size} t={t} rank {r}")
            for path, want in jres.items():
                np.testing.assert_allclose(got["residues"][path]["q"][0].view(np.float32),
                                           want[_row(label, r)], err_msg=f"m' {path} t={t}",
                                           **RING_TOL)
            for k, want in jghat.items():
                np.testing.assert_allclose(got["ghat"][k], want, err_msg=f"ghat {k} t={t}",
                                           **RING_TOL)
            ghats.append(got["ghat"])
        for ghat in ghats[1:]:
            for k, x in ghat.items():
                np.testing.assert_array_equal(_bits(x), _bits(ghats[0][k]))


@pytest.mark.parametrize("label", list(CASES))
def test_group_reduce_counts_the_plans_bytes(world, label):
    """The payload's mean over the ranks is the plan's comm_bytes_per_worker;
    telemetry's bytes stand apart under "telemetry", each rank's its own:
    the worker-mean EF's all-reduce (when compute_stats does not make it),
    the roundtrip error's two floats, and on sampled steps the unit EF's
    all-reduce and rank 0's broadcast of its three taps."""
    case = CASES[label]
    for t in TS:
        sent = [res[label, t]["sent"] for res in world["ranks"]]
        planned = world["ranks"][0][label, t]["stats"]["comm_bytes_per_worker"]
        assert sum(c["values"] + c["indices"] + c["dense"] for c in sent) / N == planned
        compressed = sum(COMPRESSED.values())
        for r, c in enumerate(sent):
            assert c["stats"] == (4 * compressed if case.get("stats") else 0)
            assert c["oracle"] == (4 * compressed if case.get("compressor") == "true_topk" else 0)
            assert c["intra"] == (4 * sum(s[0] for s in TREE.values()) if case.get("groups")
                                  else 0)
            want = 0
            if case.get("telemetry"):
                every = case["metrics_every"]
                sampled = every > 0 and t % every == 0
                for size in COMPRESSED.values():
                    want += 0 if case.get("stats") else 4 * size
                    want += 8
                    if sampled:
                        want += 4 * (size + 1) + (12 if r == 0 else 0)
            assert c["telemetry"] == want, (label, t, r, c)


def _bucket_calls(label: str) -> int:
    """The calls a bucketed step makes: per bucket of the plan's schedule one
    packed broadcast of offsets, one all-reduce of values and one of the
    dense tensors (each where the bucket holds such a tensor), one packed
    intra-group gather under ``groups``, and true_topk's oracle all-reduce
    per compressed tensor, unpacked."""
    case = CASES[label]
    cfg = ranks.sc_config({"chunk": CHUNK, "beta": BETA, "min_size": MIN_SIZE,
                           "bucket_bytes": BUCKET_BYTES}, case)
    plans = plan_tensors(tuple((f"['{k}']", s, N) for k, s in TREE.items()), cfg,
                         frozenset(f"['{k}']" for k in COMPRESSED))
    spec = case["buckets"]
    schedule = plan_buckets(plans, 4 << 20 if spec is None else
                            (BUCKET_BYTES if spec is True else spec))
    calls = 0
    for b in schedule:
        dense = sum(plans[i].dense for i in b.leaf_ids)
        compressed = len(b.leaf_ids) - dense
        calls += (dense > 0) + 2 * (compressed > 0) + bool(case.get("groups"))
        calls += compressed if case.get("compressor") == "true_topk" else 0
    return calls


@pytest.mark.parametrize("label", list(BUCKETED))
def test_buckets_are_the_unbucketed_step(world, label):
    """Offsets and m' bitwise the unbucketed group step's, ĝ within rtol
    1e-6 / atol 1e-7 (printed: how many of its elements are not bitwise);
    every call async, in the same order on every rank, as many as the
    schedule packs them into (``_bucket_calls``), no more than unbucketed."""
    plain = BUCKETED[label]
    differ = total = 0
    for t in TS:
        for r, res in enumerate(world["ranks"]):
            got, want = res[label, t], res[plain, t]
            for size, idx in want["offsets"].items():
                np.testing.assert_array_equal(got["offsets"][size], idx)
            for path, enc in want["residues"].items():
                for field, bits in enc.items():
                    np.testing.assert_array_equal(got["residues"][path][field], bits,
                                                  err_msg=f"{path} t={t} rank {r}")
            for k, x in want["ghat"].items():
                np.testing.assert_allclose(got["ghat"][k], x, err_msg=f"ghat {k} t={t}",
                                           **RING_TOL)
                differ += int(np.sum(_bits(got["ghat"][k]) != _bits(x)))
                total += x.size
            assert all(call[3] for call in got["calls"]), got["calls"]
            assert not any(call[3] for call in want["calls"])
            assert len(got["calls"]) == _bucket_calls(label) <= len(want["calls"])
            assert got["calls"] == world["ranks"][0][label, t]["calls"]
    print(f"{label}: {differ} of {total} ghat elements not bitwise the unbucketed step's")


@pytest.mark.parametrize("label", list(BITWISE))
def test_fused_telemetry_and_backend_cases_are_bitwise(world, label):
    """Telemetry, the fused path and the "cuda" backend's plain versions
    change no bit of the offsets, m' or ĝ."""
    for t in TS:
        for r, res in enumerate(world["ranks"]):
            got, want = res[label, t], res[BITWISE[label], t]
            for size, idx in want["offsets"].items():
                np.testing.assert_array_equal(got["offsets"][size], idx)
            for path, enc in want["residues"].items():
                for field, bits in enc.items():
                    np.testing.assert_array_equal(got["residues"][path][field], bits)
            for k, x in want["ghat"].items():
                np.testing.assert_array_equal(_bits(got["ghat"][k]), _bits(x), err_msg=k)


@pytest.mark.parametrize("label", ["fused", "fused_env", "fused_true_topk"])
def test_fused_leader_runs_the_plain_twin(world, label):
    """The leader (rank t mod 4) selects and updates through the wrapper,
    which on CPU tensors runs ``fused_select_update_plain``, once a
    compressed tensor; no other rank calls it."""
    for t in TS:
        for r, res in enumerate(world["ranks"]):
            n = len(COMPRESSED) if r == t % N else 0
            assert res[label, t]["fused"] == {"wrapper": n, "plain": n}, (t, r)
            assert res["unfused_cuda", t]["fused"] == {"wrapper": 0, "plain": 0}


@pytest.mark.parametrize("label", ["telemetry", "telemetry_buckets_stats"])
def test_telemetry_taps_match_the_stacked_step(world, label):
    """The same keys as the stacked reduce's; every rank the same values;
    the values within tolerance of the stacked step's (the rank-based taps
    counted where they move)."""
    moved = checked = 0
    for t in TS:
        want = world["stacked"][label, t]
        first = world["ranks"][0][label, t]["stats"]
        taps = {k for k in want if k.startswith("obs/")}
        assert taps and {k for k in first if k.startswith("obs/")} == taps
        for res in world["ranks"][1:]:
            assert res[label, t]["stats"] == first
        for key in sorted(taps):
            got, ref = first[key], want[key]
            if any(f"obs/{name}{{" in key for name in RANK_TAPS):
                checked += 1
                moved += not np.isclose(got, ref, rtol=1e-5, atol=1e-6)
                assert abs(got - ref) <= 0.01, (key, got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=key)
        if CASES[label].get("stats"):
            np.testing.assert_allclose(first["contraction_gamma"], want["contraction_gamma"],
                                       rtol=1e-5)
    print(f"{label}: {moved} of {checked} rank-based tap values moved beyond rtol 1e-5")
    assert moved <= checked // 4
