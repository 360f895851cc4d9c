"""The training examples' whole runs on the CPU: the reference against the
port from the same weights, and the port's own-init final losses.

For each training example of ``examples/`` at its full step count and SMOKE
width (quickstart's two arms, 60 steps; large_batch_lowpass's three, 80;
multipod_groups, 24), this script

  * runs the reference example as it stands (imported by path; its
    ``run_training`` wrapped to record the initial state it drew and every
    step's loss) and the port's ``examples_torch/`` counterpart from that
    state, carried across, and prints both losses at every step with the
    largest gap;
  * runs the port from its own initial state (a CPU generator seeded 0) and
    prints its final loss. ``chip_smoke.py``'s ``[examples]`` phase holds the
    card's quickstart runs to these: the same CPU-drawn weights, the same
    batches.

Torch runs on ``--threads`` threads (default 1: the CPU's tok_embed gradient,
an index-accumulate, is bitwise repeatable on one thread only). Needs the
JAX package and the port; runs on the CPU only.

    PYTHONPATH=src python tools/examples_witness.py [--examples quickstart,...] [--threads N]
"""

import argparse
import importlib.util
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.models.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.training import TrainState, run_training  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
# example: [(arm label, the arguments of the reference's train and the port's setup)]
ARMS = {
    "quickstart": [("none", ("none", 64, 1.0)), ("clt_k", ("clt_k", 64, 1.0))],
    "large_batch_lowpass": [("none", ("none", 1.0)), ("clt_k beta=1", ("clt_k", 1.0)),
                            ("clt_k beta=0.1", ("clt_k", 0.1))],
    "multipod_groups": [("clt_k groups=2", ())],
}


def load(folder: str, name: str):
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}",
                                                  os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def carry(jstate) -> TrainState:
    """A JAX TrainState (sgdm) -> the port's, on the CPU."""
    return TrainState(params=params_from_jax(jstate.params, "cpu"),
                      opt_state={"m": params_from_jax(jstate.opt_state["m"], "cpu")},
                      sc_state=state_from_jax(jstate.sc_state, "cpu"), step=int(jstate.step))


def reference_run(mod, name: str, args: tuple):
    """The reference example's run of ``args``: (its initial state carried
    across to the port, per-step losses). The reference's step donates its
    state's buffers, so the state is carried before the run."""
    real, rec = mod.run_training, {}

    def recording(loop, state, batches, steps, **kw):
        rec["init"] = carry(state)
        loop.log_every = 1
        state, hist = real(loop, state, batches, steps, **kw)
        rec["losses"] = [h["loss"] for h in hist]
        return state, hist

    mod.run_training = recording
    try:
        mod.main() if name == "multipod_groups" else mod.train(*args)
    finally:
        mod.run_training = real
    return rec["init"], rec["losses"]


def port_run(mod, name: str, args: tuple, steps: int, init=None) -> list:
    """The port example's loop from ``init`` (None: its own draw): per-step losses."""
    loop, state, batches = mod.setup(*args, device="cpu", init=init)
    loop.log_every = 1
    _, hist = run_training(loop, state, batches, steps, log=None)
    return [h["loss"] for h in hist]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--examples", default=",".join(ARMS))
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    own = {}
    for name in args.examples.split(","):
        ref, mine = load("examples", name), load("examples_torch", name)
        steps = mine.STEPS
        for label, arm in ARMS[name]:
            init, want = reference_run(ref, name, arm)
            got = port_run(mine, name, arm, steps, init)
            gaps = np.abs(np.subtract(got, want)) / np.abs(want)
            print(f"[witness] {name} {label}, {steps} steps from the reference's weights "
                  f"(torch on {args.threads} thread(s)): step, reference loss, port loss, "
                  f"relative gap")
            for i, (w, g, r) in enumerate(zip(want, got, gaps)):
                print(f"  {i:3d} {w:.6f} {g:.6f} {r:.2e}")
            i = int(np.argmax(gaps))
            print(f"[witness] {name} {label}: largest relative gap {gaps[i]:.3e} at step {i}; "
                  f"final {want[-1]:.6f} / {got[-1]:.6f} ({gaps[-1]:.3e})")
            mine_own = port_run(mine, name, arm, steps)
            own[f"{name} {label}"] = mine_own[-1]
            print(f"[witness] {name} {label}: the port from its own weights (CPU generator, "
                  f"seed 0): final loss {mine_own[-1]!r}; losses every 10 steps "
                  + " ".join(f"{x:.4f}" for x in mine_own[::10]))
    print("[witness] the port's own-init final losses: " + json.dumps(own))
    return own


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
