"""The reference's runs of ``test_torch_examples.py``, in processes of their
own (JAX traces and compiles under the interpreter lock, so threads of one
process take turns), and the helpers both sides share.

    python tests/_torch_examples_ref.py OUT JOB [JOB ...]

Each JOB names a run of a reference example, imported by path as it stands
with only its module constant ``STEPS`` set on the module object:
``quick:<compressor>:<beta>`` (quickstart's ``train``), ``large:<compressor>:
<beta>`` (large_batch_lowpass's), ``pod`` (multipod_groups' ``main``, its
printout and its step log captured) and ``playground`` (the module's
import, which computes and prints its table, then the rows unrounded by
the module's own functions and its ``ef``). The results go to OUT as a
pickle: {job: result}.
"""

import contextlib
import importlib.util
import io
import logging
import os
import pickle
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
# quickstart 5 dense + 3 compressed steps, large_batch_lowpass 8 + 2,
# multipod_groups 4 + 4 (its last loss follows two reduces of beta-filtered
# residues: beta 0.5 in place of 0.3 moves it 7e-4)
STEPS = {"quickstart": 8, "large_batch_lowpass": 10, "multipod_groups": 8}


def load(name: str, folder: str = "examples"):
    """``<folder>/<name>.py`` as a module; a reference example with its
    ``STEPS`` set."""
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}",
                                                  os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if folder == "examples" and name in STEPS:
        mod.STEPS = STEPS[name]
    return mod


def ref_init(mod, n_workers: int, groups=None):
    """A reference example's initial TrainState (params from PRNGKey(0),
    zero momentum and residues), as its ``train``/``main`` draws it."""
    import jax

    cfg = mod.registry.smoke("paper-transformer-base")
    model = mod.build_model(cfg, compute_dtype="float32", loss_chunk=16)
    sc = mod.ScaleComConfig(compressor=mod.CompressorConfig("clt_k", chunk=64), min_size=512,
                            groups=groups)
    state, _ = mod.init_train_state(model, mod.make_optimizer("sgdm"), sc,
                                    jax.random.PRNGKey(0), n_workers=n_workers)
    return state


def carry(jstate):
    """A JAX TrainState (sgdm) -> the port's, on the CPU."""
    from repro_torch.models.convert import params_from_jax, state_from_jax
    from repro_torch.training import TrainState

    return TrainState(params=params_from_jax(jstate.params, "cpu"),
                      opt_state={"m": params_from_jax(jstate.opt_state["m"], "cpu")},
                      sc_state=state_from_jax(jstate.sc_state, "cpu"), step=int(jstate.step))


def playground():
    import jax.numpy as jnp
    import numpy as np

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pg = load("compressor_playground")
    rows = {}
    for name in ("true_topk", "clt_k", "random_k", "local_topk"):
        _, _, dense = pg.compress(pg.ef, jnp.int32(0), pg.CompressorConfig(name, chunk=pg.CHUNK))
        rows[name] = (float(pg.metrics.contraction_gamma(pg.y, dense)), int(jnp.sum(dense != 0)),
                      float(pg.metrics.hamming_distance_topk(pg.ef[0], pg.y,
                                                             pg.SIZE // pg.CHUNK)))
    return {"ef": np.asarray(pg.ef), "rows": rows, "printed": out.getvalue()}


def run(job: str):
    if job == "playground":
        return playground()
    if job == "pod":
        out, log = io.StringIO(), io.StringIO()
        logger = logging.getLogger("repro")
        logger.setLevel(logging.INFO)
        logger.addHandler(logging.StreamHandler(log))
        with contextlib.redirect_stdout(out):
            load("multipod_groups").main()
        return out.getvalue(), log.getvalue()
    example, compressor, beta = job.split(":")
    if example == "quick":
        return load("quickstart").train(compressor, 64, float(beta))
    return load("large_batch_lowpass").train(compressor, float(beta))


if __name__ == "__main__":
    results = {job: run(job) for job in sys.argv[2:]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(results, f)
