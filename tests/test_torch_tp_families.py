"""The tensor-parallel train step (``build_train_step(mesh=...)``) on the MoE
and RWKV-6 families, on gloo between processes, against the reference's
unsharded step.

Four rank processes (``_torch_tp_family_ranks.rank_main``, spawned once for
the module, one torch thread each, rendezvous through a ``file://`` store
under the test's temporary directory) form a (2 data, 2 model) grid, then
the first three a (1 data, 3 model) one. The reference runs in threads of
the test process meanwhile, one arch a thread.

- phi3.5-moe and kimi-k2 SMOKE on (2, 2): 4 experts, 2 a model rank
  (``experts`` split); rwkv6 SMOKE on (2, 2): 4 heads of 32, 2 a rank, its
  ``cm_wk`` columns and ``cm_wv`` rows too, with every constant-initialised
  leaf perturbed (``tests/_torch_arch_parity.py:perturb_constants``);
  phi3.5-moe SMOKE on (1, 3): 4 experts do not divide into 3, so each
  expert's 192 hidden columns split 64 a rank (``mlp``), and everything
  else runs whole.
- Each runs 1 dense + 2 compressed steps (CLT-k chunk 16, min_size 512,
  beta 0.1, SGD-momentum) from JAX's init, unfused and fused; phi3.5-moe
  and rwkv6 on (2, 2) also with fp8 residues and with 256 KB buckets (one
  lossy codec and one bucketed run a family). Each rank's
  parameter slices within rtol 2e-4 / atol 1e-5 (``STEP_TOL``,
  ``tests/test_distributed.py:75-76``) of the reference's unsharded step
  (fp32 or fp8 residues) outside chunks that selected another lane at a
  near tie of the reference's leader EF (counted); the loss within 1e-3;
  fused and bucketed bitwise the plain run.
- The per-worker gradients of each compressed step, every slice, within
  rtol 1e-4 / atol 1e-5 of the reference's (``_torch_arch_parity.TOL``);
  the replicated leaves that a rank reads in part (the router; RWKV-6's
  ``tm_w0``, ``tm_wd_a``, ``tm_wd_b``, ``tm_gn``) bitwise the same on
  every model rank; the microbatched pass (2 microbatches) against the
  unsplit one; the model-axis collectives the same, in the same order, on
  every rank.
- The MoE aux: ``moe_lb_loss`` and ``moe_z_loss`` against the reference's
  metrics, ``moe_dropped_frac`` as drop counts (compiled XLA folds the
  division: ROADMAP Queue 3, "XLA's folding"). Router near ties (a token
  whose K-th and (K+1)-th probabilities are within ``NEAR_TIE_PROB``) are
  counted and printed.
- The payload: each data group's share of the plan, the shares summing to
  the reference's bytes.
- ``shard_train_state(mesh=)`` -> ``train_state_from_shard`` of a stacked
  state with random residues in every codec, bitwise, for phi3.5-moe
  (expert leaves split on dim 1) and rwkv6 (``tm_u`` split on dim 1).
- Pure spec logic, no processes: ``split_axes`` at full width for
  phi3.5-moe, kimi-k2 and rwkv6-3b at model 2, 4 and 8, and the leaf it
  names where RWKV-6's heads would split inside a head.
"""

import concurrent.futures
import multiprocessing

import numpy as np
import pytest

import _torch_arch_parity as parity
import _torch_tp_family_ranks as ranks
from _torch_tp_refs import arch_job as _arch_job
from _torch_tp_refs import flips as _flips
from _torch_tp_refs import specs_of
from _torch_tp_refs import take_slice as _slice
from _torch_tp_refs import whole as _whole
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.distributed.sharding import specs_for_axes, split_axes
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model

MOE = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
ARCHS = MOE + ("rwkv6-3b",)
GRID, LINE = (2, 2), (1, 3)
LINE_ARCH = MOE[0]
WORLD = 4
MODES = ranks.MODES
CHUNK, LR = ranks.CHUNK, ranks.LR
STEP_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_distributed.py:75-76
GRAD_TOL = parity.TOL
UNSPLIT_TOL = dict(rtol=1e-4, atol=1e-6)
MAX_FLIPS = 8
TIMEOUT_S = 300
# the runs of each (arch, grid): fp8 residues and buckets once a family
RUNS = {(MOE[0], GRID): tuple(ranks.RUNS), (MOE[1], GRID): ("plain", "fused"),
        ("rwkv6-3b", GRID): tuple(ranks.RUNS), (LINE_ARCH, LINE): ("plain", "fused")}
# (arch, grid, run) of every whole-step case
CASES = [(a, g, r) for (a, g), runs in RUNS.items() for r in runs]
HELD = [c for c in CASES if c[2] in ("plain", "fp8")]
TWINS = [c for c in CASES if c[2] in ("fused", "buckets")]
# the replicated leaves that a rank's pass reads in part: their gradients
# must be whole, and the same, on every model rank
REPLICATED = ("['blocks']['router']", "['blocks']['tm_w0']", "['blocks']['tm_wd_a']",
              "['blocks']['tm_wd_b']", "['blocks']['tm_gn']")
LAYOUTS = {(MOE[0], GRID): ["experts", "heads", "kv", "vocab"],
           (MOE[1], GRID): ["experts", "heads", "kv", "vocab"],
           ("rwkv6-3b", GRID): ["heads", "mlp", "vocab"],
           (LINE_ARCH, LINE): ["mlp"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families")
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(WORLD)]
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, str(tmp / "store"), pipes[r][1]),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    for _, child in pipes:
        child.close()  # a rank that dies then breaks its pipe: no send waits on it
    try:
        jobs, runs = {}, {}
        for (arch, grid), labels in RUNS.items():
            codecs = ("fp32", "fp8") if "fp8" in labels else ("fp32",)
            jobs[(arch, grid)], runs[(arch, grid)] = _arch_job(arch, grid[0], codecs)
            jobs[(arch, grid)]["runs"] = labels
        # one row of 32 tokens a worker: 128 tokens in all, where the capacity binds
        jobs["group"], runs["group"] = _arch_job(MOE[0], WORLD, ("fp32",), MODES[:1], 1)
        job = {"grid": {a: jobs[(a, GRID)] for a in ARCHS},
               "line": {LINE_ARCH: jobs[(LINE_ARCH, LINE)]},
               "round_trip": (MOE[0], "rwkv6-3b"), "group": jobs["group"]}
        for parent, _ in pipes:
            parent.send(job)
        # the references while the ranks run, one arch a thread (XLA
        # compiles without the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
            futures = {key: pool.submit(run) for key, run in runs.items()}
            refs = {key: f.result(TIMEOUT_S) for key, f in futures.items()}
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
    return {"ranks": results, "refs": refs, "jobs": jobs}


def _specs(arch: str, grid) -> dict:
    return specs_of(build_model(registry.smoke(arch)), grid)


def _by_coords(world, grid) -> dict:
    """(data, model) -> the rank's result, for the ranks of ``grid``."""
    if grid == GRID:
        return {(r["coords"]["data"], r["coords"]["model"]): r for r in world["ranks"]}
    return {(r["line"]["data"], r["line"]["model"]): r for r in world["ranks"] if "line" in r}


@pytest.mark.parametrize("arch,grid,run", HELD)
def test_tp_family_step_matches_reference(world, arch, grid, run):
    specs, by = _specs(arch, grid), _by_coords(world, grid)
    refs = world["refs"][(arch, grid)]["fp8" if run == "fp8" else "fp32"]
    skip, flipped = {}, 0
    for i, (mode, ref) in enumerate(zip(MODES, refs)):
        if mode == "scalecom":
            lead = next(d for d in range(grid[0])
                        if "ef" in by[(d, 0)]["runs"][(arch, grid, run)][i])
            for path, ef in ref["ef"].items():
                ghat = _whole([by[(0, m)]["runs"][(arch, grid, run)][i]["ghat"][path]
                               for m in range(grid[1])], specs[path])
                own = _whole([by[(lead, m)]["runs"][(arch, grid, run)][i]["ef"][path]
                              for m in range(grid[1])], specs[path])
                flip = _flips(ghat, ef, own, ref["sel"][path])
                flipped += int(flip.sum())
                mask = np.repeat(flip, CHUNK)[:ef.size].reshape(ghat.shape)
                skip[path] = skip.get(path, np.zeros_like(mask)) | mask
        for (d, m), res in by.items():
            got = res["runs"][(arch, grid, run)][i]
            assert sorted(got["params"]) == sorted(ref["params"])
            where = {"data": d, "model": m}
            for path, want in ref["params"].items():
                keep = (~_slice(skip[path], specs[path], where, grid) if path in skip
                        else np.ones(got["params"][path].shape, bool))
                np.testing.assert_allclose(
                    got["params"][path][keep], _slice(want, specs[path], where, grid)[keep],
                    err_msg=f"{arch} {run} step {i} rank {(d, m)} {path}", **STEP_TOL)
            assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) < 1e-3
    print(f"{arch} {grid} {run}: {flipped} chunks selected another lane at a near tie")
    assert flipped <= MAX_FLIPS, flipped


@pytest.mark.parametrize("arch,grid,run", TWINS)
def test_tp_family_twin_is_the_plain_run(world, arch, grid, run):
    """Fused and bucketed: the parameters bitwise the plain run's, every
    step, every rank."""
    for res in _by_coords(world, grid).values():
        for i, (plain, twin) in enumerate(zip(res["runs"][(arch, grid, "plain")],
                                              res["runs"][(arch, grid, run)])):
            for path, x in plain["params"].items():
                np.testing.assert_array_equal(twin["params"][path].view(np.uint32),
                                              x.view(np.uint32), err_msg=f"step {i} {path}")


@pytest.mark.parametrize("arch,grid", list(LAYOUTS))
def test_tp_family_layout_splits(world, arch, grid):
    for res in _by_coords(world, grid).values():
        assert res["split"][(arch, grid)] == LAYOUTS[(arch, grid)]


@pytest.mark.parametrize("arch,grid", list(LAYOUTS))
def test_tp_family_grads_match_reference(world, arch, grid):
    """The first compressed step's per-worker gradient slices against the
    reference's on the same worker (both passes from states a dense step
    apart from the same init); the replicated leaves read in part bitwise
    the same on every model rank, every compressed step."""
    specs, by = _specs(arch, grid), _by_coords(world, grid)
    refs = world["refs"][(arch, grid)]["fp32"]
    replicated = [p for p in REPLICATED if p in specs]
    assert replicated
    first = MODES.index("scalecom")
    for i, mode in enumerate(MODES):
        if mode != "scalecom":
            continue
        for (d, m), res in by.items():
            loss, auxs, grads = res["runs"][(arch, grid, "plain")][i]["grads"]
            for path in grads if i == first else ():
                want = _slice(refs[i]["grads"][path][d], specs[path], {"data": d, "model": m},
                              grid)
                np.testing.assert_allclose(grads[path], want, **GRAD_TOL,
                                           err_msg=f"step {i} rank {(d, m)} {path}")
            for path in replicated:
                assert specs[path].count("model") == 0
                other = by[(d, 0)]["runs"][(arch, grid, "plain")][i]["grads"][2][path]
                np.testing.assert_array_equal(grads[path].view(np.uint32),
                                              other.view(np.uint32), err_msg=path)


def _held_unsplit(got: dict, want: dict, what: str, worst: dict):
    for path, g in got.items():
        err = float(np.max(np.abs(g - want[path]))) / max(float(np.max(np.abs(want[path]))), 1e-30)
        worst[path] = max(worst.get(path, 0.0), err)
        np.testing.assert_allclose(g, want[path], **UNSPLIT_TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch,grid", list(LAYOUTS))
def test_tp_family_grads_match_the_unsplit_pass(world, arch, grid):
    """Every compressed step: the split pass's gradient slices against the
    unsplit pass's on the same (gathered) parameters and worker row, whole
    and in 2 microbatches (the microbatches route MoE tokens apart, so
    each is held to its own unsplit pass)."""
    worst = {}
    for (d, m), res in _by_coords(world, grid).items():
        for i, row in enumerate(res["runs"][(arch, grid, "plain")]):
            if "unsplit" not in row:
                continue
            loss, _, grads = row["grads"]
            want_loss, want = row["unsplit"]
            assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
            _held_unsplit(grads, want, f"step {i} rank {(d, m)}", worst)
            loss, grads = row["micro"]
            want_loss, want = row["micro_unsplit"]
            assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
            _held_unsplit(grads, want, f"microbatched step {i} rank {(d, m)}", worst)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"{arch} {grid}: largest split-unsplit gradient gaps, of the leaf's max: {top}")


@pytest.mark.parametrize("arch,grid", list(LAYOUTS))
def test_tp_family_reduce_consumes_the_step_gradients(world, arch, grid):
    """The step hands its gradient tree to the reduce, which drops each
    leaf once it holds it (so each slice is freed once reduced): after a
    compressed step no leaf is left."""
    for res in _by_coords(world, grid).values():
        for i, mode in enumerate(MODES):
            if mode == "scalecom":
                assert res["runs"][(arch, grid, "plain")][i]["consumed"], f"step {i}"


@pytest.mark.parametrize("arch,grid", list(LAYOUTS))
def test_tp_family_collectives_in_one_order(world, arch, grid):
    """Every rank issues the model axis's collectives of a step (the pass,
    remat's replays and the reduce) in the same order with the same
    shapes."""
    by = _by_coords(world, grid)
    for i in range(len(MODES)):
        logs = [res["runs"][(arch, grid, "plain")][i]["ops"] for res in by.values()]
        assert logs[0] and all(log == logs[0] for log in logs), f"step {i}"


def _drops(frac: float, choices: int) -> int:
    n = frac * choices
    assert abs(n - round(n)) < 1e-3, n
    return round(n)


@pytest.mark.parametrize("arch,grid", [k for k in LAYOUTS if k[0] in MOE])
def test_tp_family_moe_aux_matches_reference(world, arch, grid):
    cfg = registry.smoke(arch)
    refs = world["refs"][(arch, grid)]["fp32"]
    choices = cfg.n_layers * 2 * 32 * cfg.moe_topk  # per worker; the metric averages workers
    near, least, drops = 0, np.inf, 0
    for res in _by_coords(world, grid).values():
        for i, (row, ref) in enumerate(zip(res["runs"][(arch, grid, "plain")], refs)):
            for k in ("moe_lb_loss", "moe_z_loss"):
                np.testing.assert_allclose(row["metrics"][k], ref["metrics"][k], rtol=1e-5,
                                           err_msg=f"step {i} {k}")
            assert (_drops(row["metrics"]["moe_dropped_frac"], choices * grid[0])
                    == _drops(ref["metrics"]["moe_dropped_frac"], choices * grid[0]))
            near += sum(n for n, _ in row["margins"])
            least = min([least] + [g for _, g in row["margins"]])
            drops += _drops(row["metrics"]["moe_dropped_frac"], choices * grid[0])
    print(f"{arch} {grid}: {near} router near ties (K-th and (K+1)-th probabilities within "
          f"{ranks.NEAR_TIE_PROB}); least gap {least:.3e}; {drops} choices dropped over the "
          f"ranks and steps")
    assert near == 0, near
    assert drops > 0  # the capacity binds: the global batch's routing is exercised


def test_group_dense_step_routes_the_global_batch(world):
    """The group step's dense mode (one worker a rank, each passing its row)
    routes phi3.5-moe's tokens over the global batch, as the reference's
    dense step over the folded batch does: the capacity, the drops and the
    load-balance loss are the global batch's."""
    ref = world["refs"]["group"]["fp32"][0]
    cfg = registry.smoke(MOE[0])
    choices = cfg.n_layers * 1 * 32 * cfg.moe_topk * WORLD
    assert _drops(ref["metrics"]["moe_dropped_frac"], choices) > 0
    for res in world["ranks"]:
        got = res["group_dense"]
        for path, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][path], want, err_msg=path, **STEP_TOL)
        for k in ("moe_lb_loss", "moe_z_loss", "loss"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, err_msg=k)
        assert (_drops(got["metrics"]["moe_dropped_frac"], choices)
                == _drops(ref["metrics"]["moe_dropped_frac"], choices))


@pytest.mark.parametrize("arch,grid", list(LAYOUTS))
def test_tp_family_bytes_are_the_plans(world, arch, grid):
    by = _by_coords(world, grid)
    refs = world["refs"][(arch, grid)]["fp32"]
    n = grid[0]
    for i, mode in enumerate(MODES):
        if mode != "scalecom":
            continue
        shares = []
        for m in range(grid[1]):
            runs = [by[(d, m)]["runs"][(arch, grid, "plain")][i] for d in range(n)]
            share = runs[0]["metrics"]["comm_bytes_per_shard"]
            assert sum(r["payload"] for r in runs) / n == share
            shares.append(share)
        total = runs[0]["metrics"]["comm_bytes_per_worker"]
        assert sum(shares) == total
        assert np.float32(total) == np.float32(refs[i]["metrics"]["comm_bytes_per_worker"])


@pytest.mark.parametrize("codec", ["fp32", "bf16", "fp8", "fp8_ec"])
@pytest.mark.parametrize("arch", [MOE[0], "rwkv6-3b"])
def test_tp_family_share_round_trip(world, arch, codec):
    leaf = "['blocks']['expert_gate']" if arch in MOE else "['blocks']['tm_u']"
    for res in world["ranks"]:
        got = res["round_trip"][arch][codec]
        assert got["split"][leaf] == [1], got["split"][leaf]
        assert got["params"] and got["momentum"] and got["residues"]


@pytest.mark.parametrize("model_size", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_axes_at_full_width(arch, model_size):
    """The grid a user would try first: the full-width configuration's
    specs at model 2, 4 and 8 split whole experts or whole heads."""
    model = build_model(registry.arch(arch))
    mesh = Mesh(("data", "model"), (1, model_size))
    specs = specs_for_axes(model.abstract_params(), model.logical_axes(), "tp", mesh)
    split = split_axes(specs, model.logical_axes())
    cfg = registry.arch(arch)
    if cfg.arch_type == "moe":
        assert "experts" in split and "mlp" not in split
    else:
        assert {"heads", "mlp", "vocab"} <= split
        assert (cfg.d_model // model_size) % cfg.ssm_head_dim == 0


def test_split_axes_names_the_leaf_of_half_a_head():
    """rwkv6 SMOKE at model 8: 128 channels split 16 a rank, half a head of
    32, while ``tm_u``'s 4 heads stay whole: the layout raises, naming the
    leaf."""
    model = build_model(registry.smoke("rwkv6-3b"))
    mesh = Mesh(("data", "model"), (1, 8))
    specs = specs_for_axes(model.abstract_params(), model.logical_axes(), "tp", mesh)
    with pytest.raises(ValueError, match=r"'heads'.*\['tm_u'\]"):
        split_axes(specs, model.logical_axes())


def test_kimi_experts_split_on_their_stacked_dim():
    """kimi-k2 at full width on model 8 splits its 384 experts 48 a rank,
    and on model 3 (its 2048 hidden columns do not split in 3) 128 a rank:
    the stacked (layers, experts, embed, mlp) leaf on dim 1."""
    model = build_model(registry.arch(MOE[1]))
    for size, per in ((8, 48), (3, 128)):
        mesh = Mesh(("data", "model"), (1, size))
        specs = dict(tree.flatten_with_path(specs_for_axes(
            model.abstract_params(), model.logical_axes(), "tp", mesh)))
        assert specs["['blocks']['expert_gate']"] == (None, "model", None, None)
        assert registry.arch(MOE[1]).n_experts // size == per
