"""The tensor-parallel train step (``build_train_step(mesh=...)``) on the
hybrid (RecurrentGemma) and the encoder-decoder (Whisper) families, on gloo
between processes, against the reference's unsharded step.

Four rank processes (``_torch_tp_hybrid_encdec_ranks.rank_main``, spawned
once for the module, one torch thread each, rendezvous through a
``file://`` store under the test's temporary directory) form a (2 data,
2 model) grid and run ``_torch_tp_family_ranks``' runs. The reference runs
in threads of the test process meanwhile, one case and codec a thread.

- recurrentgemma SMOKE at 4 layers (one ``rec, rec, attn`` unit and a tail
  ``rec`` layer) over 80 positions, past its ``local_window`` of 64: the
  RG-LRU's 128 channels 64 a rank, 4 q heads 2 a rank beside half of the
  one kv head (the gather route), the vocabulary split;
- whisper SMOKE: 4 heads and 4 kv heads, 2 a rank (the local route) in the
  encoder's, the decoder's self- and cross-attention, the vocabulary split;
- a whisper SMOKE variant with ``d_model`` 96, 3 heads and a vocabulary of
  511: a rank holds one and a half heads (the gather route, self and
  cross), and the odd vocabulary stays whole on every rank.

Every constant-initialised leaf is perturbed
(``tests/_torch_arch_parity.py:perturb_constants``). Each case runs
1 dense + 2 compressed steps (CLT-k chunk 16, min_size 512, beta 0.1,
SGD-momentum) from JAX's init, unfused and fused, the hybrid also with fp8
residues. Held: each rank's parameter slices within rtol 2e-4 / atol 1e-5
(``STEP_TOL``, ``tests/test_distributed.py:75-76``) of the reference's
step outside counted near-tie chunks, the loss within 1e-3, fused bitwise
the plain run; the first compressed step's per-worker gradients of every
slice within ``_torch_arch_parity.TOL`` of the reference's and every
compressed step's within ``UNSPLIT_TOL`` of the unsplit pass on the
gathered parameters (whole and in 2 microbatches); the gradients of every
replicated leaf (computed whole on every rank: the norms, the biases added
after a reduce, whisper's ``ln_enc_final`` and the odd vocabulary's
``tok_embed`` and ``lm_head``) bitwise the same on every model rank; the
model-axis collectives the same, in the same order, on every rank; each
data group's payload the plan's share; ``shard_train_state(mesh=)`` ->
``train_state_from_shard`` bitwise for the ``units``/``tail`` and the
``encoder``/``decoder`` trees in every codec.

Beside them, in pure functions: ``distributed.slices``' flat fp8 encode and
decode of a slice made of whole 512-element blocks (a (1, blocks, 512)
view, no per-element block ids: what lets the hybrid's 327,680,000-element
vocabulary slices code within a rank's memory on the card) bitwise the
per-element path's, NaNs and zeros included, and the stacked codec's
encoding of the logical row cut to each slice.
"""

import concurrent.futures
import multiprocessing

import numpy as np
import pytest
import torch

import _torch_arch_parity as parity
import _torch_tp_family_ranks as fam
import _torch_tp_hybrid_encdec_ranks as ranks
from _torch_tp_refs import CHUNK, MODES, arch_job, flips, specs_of, take_slice, whole
from repro_torch.core import state as cstate
from repro_torch.distributed import slices

GRID = (2, 2)
WORLD = 4
STEP_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_distributed.py:75-76
GRAD_TOL = parity.TOL
UNSPLIT_TOL = dict(rtol=1e-4, atol=1e-6)
MAX_FLIPS = 8
TIMEOUT_S = 300
# case: (arch, config overrides, positions a row, runs)
CASES = {
    "recurrentgemma": ("recurrentgemma-2b", {"n_layers": 4}, 80, ("plain", "fused", "fp8")),
    "whisper": ("whisper-medium", {}, 32, ("plain", "fused")),
    "whisper-odd": ("whisper-medium", {"d_model": 96, "n_heads": 3, "n_kv_heads": 3,
                                       "vocab": 511}, 32, ("plain", "fused")),
}
RUNS = [(c, r) for c, (_, _, _, runs) in CASES.items() for r in runs]
HELD = [x for x in RUNS if x[1] in ("plain", "fp8")]
TWINS = [x for x in RUNS if x[1] == "fused"]
LAYOUTS = {"recurrentgemma": ["heads", "kv", "mlp", "vocab"],
           "whisper": ["heads", "kv", "mlp", "vocab"],
           "whisper-odd": ["heads", "kv", "mlp"]}
# leaves that every rank computes whole, by case (among the replicated ones held)
WHOLE = {"recurrentgemma": ("['ln_final_scale']", "['tail']['layer_0_rec']['ln_rec_scale']",
                            "['units']['u2_attn']['ln_attn_scale']"),
         "whisper": ("['ln_final_scale']", "['encoder']['ln_enc_final_scale']",
                     "['encoder']['ln_enc_final_bias']", "['decoder']['ln_cross_scale']",
                     "['decoder']['mlp_down_b']"),
         "whisper-odd": ("['tok_embed']", "['lm_head']", "['encoder']['ln_enc_final_scale']",
                         "['decoder']['ln_cross_bias']")}
# a leaf of each tree that the model axis splits, and the dim it splits on
SPLIT_LEAF = {"recurrentgemma": {"['units']['u0_rec']['rec_conv']": [2],
                                 "['tail']['layer_0_rec']['rec_lambda']": [0]},
              "whisper": {"['encoder']['attn_wq']": [2], "['decoder']['cross_wk']": [2]}}


def _model(case: str):
    arch, overrides, _, _ = CASES[case]
    return fam.model_of(arch, overrides)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_hybrid_encdec")
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(WORLD)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()  # a rank that dies then breaks its pipe: no send waits on it
    try:
        def job(case):
            arch, overrides, seq, labels = CASES[case]
            codecs = ("fp32", "fp8") if "fp8" in labels else ("fp32",)
            return arch_job(arch, GRID[0], codecs, seq=seq, overrides=overrides, perturb=True)

        # the inits and, while the ranks run, the references, one case and
        # codec a thread (XLA compiles without the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(len(RUNS)) as pool:
            made = dict(zip(CASES, pool.map(job, CASES)))
            jobs = {case: {**j, "runs": CASES[case][3]} for case, (j, _) in made.items()}
            for parent, _ in pipes:
                parent.send({"cases": jobs, "round_trip": tuple(SPLIT_LEAF)})
            futures = {(case, codec): pool.submit(run, (codec,))
                       for case, (j, run) in made.items() for codec in j["residues"]}
            refs = {}
            for (case, codec), f in futures.items():
                refs.setdefault(case, {}).update(f.result(TIMEOUT_S))
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
    return {"ranks": results, "refs": refs,
            "by": {(r["coords"]["data"], r["coords"]["model"]): r for r in results}}


@pytest.mark.parametrize("case,run", HELD)
def test_tp_hybrid_encdec_step_matches_reference(world, case, run):
    specs, by = specs_of(_model(case), GRID), world["by"]
    refs = world["refs"][case]["fp8" if run == "fp8" else "fp32"]
    skip, flipped = {}, 0
    for i, (mode, ref) in enumerate(zip(MODES, refs)):
        if mode == "scalecom":
            lead = next(d for d in range(GRID[0]) if "ef" in by[(d, 0)]["runs"][(case, run)][i])
            for path, ef in ref["ef"].items():
                ghat = whole([by[(0, m)]["runs"][(case, run)][i]["ghat"][path]
                              for m in range(GRID[1])], specs[path])
                own = whole([by[(lead, m)]["runs"][(case, run)][i]["ef"][path]
                             for m in range(GRID[1])], specs[path])
                flip = flips(ghat, ef, own, ref["sel"][path])
                flipped += int(flip.sum())
                mask = np.repeat(flip, CHUNK)[:ef.size].reshape(ghat.shape)
                skip[path] = skip.get(path, np.zeros_like(mask)) | mask
        for (d, m), res in by.items():
            got = res["runs"][(case, run)][i]
            assert sorted(got["params"]) == sorted(ref["params"])
            where = {"data": d, "model": m}
            for path, want in ref["params"].items():
                keep = (~take_slice(skip[path], specs[path], where, GRID) if path in skip
                        else np.ones(got["params"][path].shape, bool))
                np.testing.assert_allclose(
                    got["params"][path][keep], take_slice(want, specs[path], where, GRID)[keep],
                    err_msg=f"{case} {run} step {i} rank {(d, m)} {path}", **STEP_TOL)
            assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) < 1e-3
    print(f"{case} {run}: {flipped} chunks selected another lane at a near tie")
    assert flipped <= MAX_FLIPS, flipped


@pytest.mark.parametrize("case,run", TWINS)
def test_tp_hybrid_encdec_fused_is_the_plain_run(world, case, run):
    """Fused: the parameters bitwise the plain run's, every step, every rank."""
    for res in world["ranks"]:
        for i, (plain, twin) in enumerate(zip(res["runs"][(case, "plain")],
                                              res["runs"][(case, run)])):
            for path, x in plain["params"].items():
                np.testing.assert_array_equal(twin["params"][path].view(np.uint32),
                                              x.view(np.uint32), err_msg=f"step {i} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_tp_hybrid_encdec_layout_splits(world, case):
    for res in world["ranks"]:
        assert res["split"][case] == LAYOUTS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_hybrid_encdec_grads_match_reference(world, case):
    """The first compressed step's per-worker gradient slices against the
    reference's on the same worker (both passes from states a dense step
    apart from the same init); every replicated leaf's gradient (computed
    whole on every rank) bitwise the same on every model rank, every
    compressed step."""
    specs, by = specs_of(_model(case), GRID), world["by"]
    refs = world["refs"][case]["fp32"]
    replicated = [p for p, s in specs.items() if "model" not in s]
    assert set(WHOLE[case]) <= set(replicated)
    first = MODES.index("scalecom")
    for i, mode in enumerate(MODES):
        if mode != "scalecom":
            continue
        for (d, m), res in by.items():
            loss, auxs, grads = res["runs"][(case, "plain")][i]["grads"]
            for path in grads if i == first else ():
                want = take_slice(refs[i]["grads"][path][d], specs[path],
                                  {"data": d, "model": m}, GRID)
                np.testing.assert_allclose(grads[path], want, **GRAD_TOL,
                                           err_msg=f"step {i} rank {(d, m)} {path}")
            for path in replicated:
                other = by[(d, 0)]["runs"][(case, "plain")][i]["grads"][2][path]
                np.testing.assert_array_equal(grads[path].view(np.uint32),
                                              other.view(np.uint32), err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_hybrid_encdec_grads_match_the_unsplit_pass(world, case):
    """Every compressed step: the split pass's gradient slices against the
    unsplit pass's on the same (gathered) parameters and worker row, whole
    and in 2 microbatches."""
    for (d, m), res in world["by"].items():
        for i, row in enumerate(res["runs"][(case, "plain")]):
            if "unsplit" not in row:
                continue
            for got, want, what in (((row["grads"][0], row["grads"][2]), row["unsplit"], ""),
                                    (row["micro"], row["micro_unsplit"], "microbatched ")):
                assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
                for path, g in got[1].items():
                    np.testing.assert_allclose(g, want[1][path], **UNSPLIT_TOL,
                                               err_msg=f"{what}step {i} rank {(d, m)} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_tp_hybrid_encdec_collectives_in_one_order(world, case):
    """Every rank issues the model axis's collectives of a step (the pass,
    remat's replays and the reduce) in the same order with the same
    shapes; the reduce consumes the step's gradients."""
    for i, mode in enumerate(MODES):
        logs = [res["runs"][(case, "plain")][i]["ops"] for res in world["ranks"]]
        assert logs[0] and all(log == logs[0] for log in logs), f"step {i}"
        if mode == "scalecom":
            assert all(res["runs"][(case, "plain")][i]["consumed"] for res in world["ranks"])


@pytest.mark.parametrize("case", list(CASES))
def test_tp_hybrid_encdec_bytes_are_the_plans(world, case):
    by = world["by"]
    refs = world["refs"][case]["fp32"]
    for i, mode in enumerate(MODES):
        if mode != "scalecom":
            continue
        shares = []
        for m in range(GRID[1]):
            runs = [by[(d, m)]["runs"][(case, "plain")][i] for d in range(GRID[0])]
            share = runs[0]["metrics"]["comm_bytes_per_shard"]
            assert sum(r["payload"] for r in runs) / GRID[0] == share
            shares.append(share)
        total = runs[0]["metrics"]["comm_bytes_per_worker"]
        assert sum(shares) == total
        assert np.float32(total) == np.float32(refs[i]["metrics"]["comm_bytes_per_worker"])


@pytest.mark.parametrize("codec", ["fp32", "bf16", "fp8", "fp8_ec"])
@pytest.mark.parametrize("case", list(SPLIT_LEAF))
def test_tp_hybrid_encdec_share_round_trip(world, case, codec):
    for res in world["ranks"]:
        got = res["round_trip"][case][codec]
        for leaf, dims in SPLIT_LEAF[case].items():
            assert got["split"][leaf] == dims, (leaf, got["split"][leaf])
        assert got["params"] and got["momentum"] and got["residues"]


def _slice_encodings(name: str, logical: torch.Tensor, dim, parts: int):
    """Each model rank's encoding of its slice of ``logical`` (flat layout),
    the crossing blocks' partial amaxes gathered as the model axis would
    gather them."""
    sls = [slices.Slice(tuple(logical.shape), [(dim, "model", parts, j)]) for j in range(parts)]
    ms = [sl.cut(logical).reshape(1, -1) for sl in sls]
    gens = [slices.encode_steps(name, m, sl, "flat") for m, sl in zip(ms, sls)]
    firsts = [next(g) for g in gens]
    rows = torch.stack([c.tensor for (c,) in firsts])
    out = []
    for g in gens:
        try:
            g.send((rows,))
        except StopIteration as stop:
            out.append(stop.value)
    return sls, out


# (logical shape, split dim, parts, whether the slices are whole blocks)
WHOLE_BLOCKS = [((64, 1024), 0, 2, True), ((16, 4096), 1, 4, True), ((8192,), 0, 2, True),
                ((40, 1000), 1, 2, False), ((3, 2600), 0, 3, False)]


@pytest.mark.parametrize("name", ["fp8", "fp8_ec"])
@pytest.mark.parametrize("shape,dim,parts,whole_blocks", WHOLE_BLOCKS)
def test_fp8_whole_block_slices_code_as_the_per_element_path(monkeypatch, shape, dim, parts,
                                                             whole_blocks, name):
    gen = torch.Generator().manual_seed(3)
    logical = torch.randn(shape, generator=gen) * torch.exp(torch.randn(shape, generator=gen))
    flat = logical.view(-1)
    flat[7], flat[700] = float("nan"), float("-inf")
    flat[1024:1536] = 0.0  # an all-zero block: scale 1
    flat[2048] = -0.0
    ids = slices._whole_blocks(slices.Slice(shape, [(dim, "model", parts, 0)]), "cpu")
    assert (ids is not None) == whole_blocks
    sls, fast = _slice_encodings(name, logical, dim, parts)
    fast_dec = [slices.decode(name, a, sl, "flat") for sl, a in zip(sls, fast)]
    # the stacked codec's encoding of the logical row, cut to each slice
    row = cstate.CODECS[name].encode(logical.reshape(1, -1), (logical.numel(),))
    stacked = [slices.cut(name, row, sl, "flat") for sl in sls]
    monkeypatch.setattr(slices, "_whole_blocks", lambda sl, device: None)
    _, plain = _slice_encodings(name, logical, dim, parts)
    for sl, a, b, want, dec in zip(sls, fast, plain, stacked, fast_dec):
        assert sorted(a) == sorted(b) == sorted(want)
        for field in a:
            for other in (b[field], want[field]):
                assert a[field].dtype == other.dtype and a[field].shape == other.shape
                assert torch.equal(a[field].view(torch.uint8), other.view(torch.uint8)), field
        assert torch.equal(dec.view(torch.int32),
                           slices.decode(name, a, sl, "flat").view(torch.int32))
