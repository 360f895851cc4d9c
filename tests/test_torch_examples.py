"""``examples_torch/`` against the reference's ``examples/``.

Each reference example is imported by path as it stands; only its module
constant ``STEPS`` is set on the imported module object. The training
examples run on both sides from the reference's own initial state (its
``init_train_state(..., PRNGKey(0))``, carried across into ``init=``):
quickstart's two arms at 8 steps (5 dense + 3 compressed) and
large_batch_lowpass's three at 10 (8 + 2), their final losses held at rtol
1e-3 (matmul and worker-mean sums are ordered differently, as in
``test_torch_training.py``'s six-step run). multipod_groups' ``main`` runs
at 8 steps (4 + 4) with its assertions, printing the reference's bytes and
ratios; its logged losses (4 decimals) within 1.5e-4 of the reference's, a
rounding unit and a half (the unrounded runs differ by ~1e-6). The playground's ``table`` on the reference's own ``ef``: nnz
exactly, gamma and d/k at rtol 1e-5 (random_k given JAX's draw). The
reference's runs go to four processes started once for the module
(``_torch_examples_ref.py``); the port runs meanwhile in this one, on one
torch thread.
"""

import glob
import logging
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_examples_ref as refside
from repro_torch.core import compressors as tcomp

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SRC = os.path.join(ROOT, "src")
EXAMPLES = ("quickstart", "large_batch_lowpass", "multipod_groups", "compressor_playground",
            "serve_decode")
QUICK_STEPS, LARGE_STEPS, POD_STEPS = (refside.STEPS[name] for name in EXAMPLES[:3])
QUICK_ARMS = (("none", 64, 1.0), ("clt_k", 64, 1.0))
LARGE_ARMS = (("none", 1.0), ("clt_k", 1.0), ("clt_k", 0.1))


def port(name: str):
    return refside.load(name, "examples_torch")


# the reference's runs, grouped into processes; runs of one process that
# compile the same program (the dense step) find it in a compile cache
REF_JOBS = (("quick:none:1.0", "quick:clt_k:1.0"), ("large:none:1.0", "large:clt_k:1.0"),
            ("large:clt_k:0.1", "pod"), ("playground",))


class Ref:
    """The reference runs in their processes (``tests/_torch_examples_ref.py``);
    meanwhile here, the imported reference modules, their initial states and
    the port's training runs from them (``port``: final losses by job)."""

    def __init__(self, tmp):
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR=os.path.join(tmp, "jax_cache"),
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                   JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
        self._procs = []
        for i, jobs in enumerate(REF_JOBS):
            out = os.path.join(tmp, f"ref{i}.pkl")
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests", "_torch_examples_ref.py"), out, *jobs],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self._procs.append((jobs, out, proc))
        self._results = {}
        try:
            self._start()
        except BaseException:
            self.close()
            raise

    def _start(self):
        """The reference modules, their initial states and the port's runs."""
        self.mods = {name: refside.load(name)
                     for name in ("quickstart", "large_batch_lowpass", "multipod_groups")}
        self.inits = {"quick": refside.ref_init(self.mods["quickstart"], 8),
                      "large": refside.ref_init(self.mods["large_batch_lowpass"], 16),
                      "pod": refside.ref_init(self.mods["multipod_groups"], 8, groups=2)}
        # the port's training runs from the same states, while the reference's runs go
        quick, large = port("quickstart"), port("large_batch_lowpass")
        self.port = {f"quick:{c}:{b}": quick.train(c, chunk, b, device="cpu", steps=QUICK_STEPS,
                                                   init=refside.carry(self.inits["quick"]))
                     for c, chunk, b in QUICK_ARMS}
        self.port.update({f"large:{c}:{b}": large.train(c, b, device="cpu", steps=LARGE_STEPS,
                                                        init=refside.carry(self.inits["large"]))
                          for c, b in LARGE_ARMS})

    def result(self, job: str):
        for jobs, out, proc in self._procs:
            if job in jobs and job not in self._results:
                log = proc.communicate(timeout=600)[0]
                assert proc.returncode == 0, log
                with open(out, "rb") as f:
                    self._results.update(pickle.load(f))
        return self._results[job]

    def close(self):
        for _, _, proc in self._procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, one_thread):
    r = Ref(str(tmp_path_factory.mktemp("examples_ref")))
    yield r
    r.close()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arm", QUICK_ARMS, ids=lambda a: f"{a[0]}-beta{a[2]}")
def test_quickstart_tracks_reference(ref, arm):
    job = f"quick:{arm[0]}:{arm[2]}"
    np.testing.assert_allclose(ref.port[job], ref.result(job), rtol=1e-3)


def test_quickstart_overlap_preview_prints_the_reference_s(ref, capsys):
    ref.mods["quickstart"].overlap_preview()
    want = capsys.readouterr().out
    port("quickstart").overlap_preview()
    assert capsys.readouterr().out == want and "hidden_fraction" in want


@pytest.mark.parametrize("arm", LARGE_ARMS, ids=lambda a: f"{a[0]}-beta{a[1]}")
def test_large_batch_lowpass_tracks_reference(ref, arm):
    job = f"large:{arm[0]}:{arm[1]}"
    np.testing.assert_allclose(ref.port[job], ref.result(job), rtol=1e-3)


def _logged_losses(log: str) -> list:
    """The losses of ``run_training``'s step lines ("step     i  loss x ...")."""
    return [float(line.split("loss")[1].split()[0]) for line in log.splitlines()
            if line.lstrip().startswith("step")]


def test_multipod_main_holds_its_assertions_and_the_reference_s_bytes(ref, capsys, caplog):
    pod = ref.mods["multipod_groups"]
    jstate = ref.inits["pod"]
    caplog.set_level(logging.INFO, logger="repro_torch")
    got = port("multipod_groups").main(POD_STEPS, device="cpu", init=refside.carry(jstate))
    # the reference's main ran its assertions; both print the same bytes and
    # ratios, and log the same losses (steps 0 and 7, to 4 decimals)
    printed, logged = ref.result("pod")
    assert capsys.readouterr().out == printed
    want = _logged_losses(logged)
    assert len(want) == 2
    got_log = "\n".join(r.getMessage() for r in caplog.records)
    np.testing.assert_allclose(_logged_losses(got_log), want, rtol=0, atol=1.5e-4)
    k, up, dense = pod._payload_prediction(jstate.params)
    assert (got["k"], got["pred_up"], got["pred_dense"]) == (k, up, dense)
    np.testing.assert_allclose([got["meas_up"], got["meas_dense"]], [up, dense], rtol=1e-6)
    P = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(jstate.params))
    pm = pod.PerfConfig(params=P, compression=pod.CHUNK, workers=pod.POD_COUNT, topology="ps")
    assert got["pred_ratio"] == pod._comm_bytes(pm, "none") / pod._comm_bytes(pm, "scalecom")


def test_multipod_residue_rows_are_pods():
    pod = port("multipod_groups")
    _, state, _ = pod.setup(device="cpu")
    pod.check_pod_residues(state)
    with pytest.raises(AssertionError):
        _, flat, _ = port("quickstart").setup("clt_k", device="cpu")
        pod.check_pod_residues(flat)


def _jax_draw(t, shape, device, high=None):
    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA1EC0), t)
    if high is None:
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape)))).to(device)
    return torch.from_numpy(
        np.array(jax.random.randint(key, tuple(shape), 0, high, dtype=jnp.int32))).to(device)


def test_playground_table_matches_reference(ref, monkeypatch):
    monkeypatch.setattr(tcomp, "random_draw", _jax_draw)
    want = ref.result("playground")
    ef, want = want["ef"], want["rows"]
    got = port("compressor_playground").table(torch.from_numpy(ef), 64)
    assert list(got) == list(want)
    for name, (gamma, nnz, d_over_k) in got.items():
        assert nnz == want[name][1], name
        np.testing.assert_allclose([gamma, d_over_k], [want[name][0], want[name][2]], rtol=1e-5,
                                   err_msg=name)


def test_playground_main_prints_its_table(capsys):
    rows = port("compressor_playground").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "8 workers, 65536 elements, chunk=64" in out
    for name, (gamma, nnz, d_over_k) in rows.items():
        assert f"{name:12s} {gamma:8.4f} {nnz:8d} {d_over_k:6.3f}" in out
    # local top-k's union builds up; the shared-index compressors keep k
    assert rows["local_topk"][1] > 1024 == rows["clt_k"][1] == rows["true_topk"][1]


def test_serve_decode_runs_the_three_families_on_the_cpu(capsys):
    out = port("serve_decode").main("cpu")
    assert list(out) == ["starcoder2-3b", "rwkv6-3b", "recurrentgemma-2b"]
    for arch, toks in out.items():
        assert toks.shape == (2, 8) and toks.min() >= 0 and toks.max() < 512, arch
    assert capsys.readouterr().out.count("ms/token") == 3


def test_examples_import_no_jax_and_nothing_of_repro():
    files = sorted(glob.glob(os.path.join(ROOT, "examples_torch", "*.py")))
    assert sorted(os.path.basename(f)[:-3] for f in files) == sorted(EXAMPLES)
    code = (
        "import importlib.util, os, sys\n"
        f"for path in {files!r}:\n"
        "    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad or 'repro_torch' not in sys.modules else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}  # they find src/ themselves
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


CUDA_CALLS = {
    "quickstart": lambda m: m.train("none", steps=1),
    "large_batch_lowpass": lambda m: m.train("none", steps=1),
    "multipod_groups": lambda m: m.main(1),
    "compressor_playground": lambda m: m.correlated_ef(),
    "serve_decode": lambda m: m.main(),
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_cuda_raises_unless_cpu_is_asked_for(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        CUDA_CALLS[name](port(name))
