"""repro_torch.optim.schedule against repro.optim.schedule.

The reference evaluates a schedule in float32 on the device, the port in
Python floats on the host; each value agrees to rtol 1e-6 at step 0, 1, the
warm-up's last step and first step after it, each boundary, the total and
beyond. Two float32 effects bound where that holds: just short of a
cosine's end, float32's 1 + cos(pi * frac) cancels to a few digits, and
float32's 0.98 is 1.9e-8 above 0.98, which the exponential decay raises to
the epoch count (1.9e-6 at epoch 100), so its last step is epoch 10. The JAX
values are computed once for the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.optim import schedule as jsched
from repro_torch.optim import schedule as tsched

# name: (constructor name, args, steps)
CASES = {
    "step_decay": ("step_decay", (0.1, (30, 60, 90), 0.1), (0, 1, 29, 30, 31, 59, 60, 89, 90, 500)),
    "step_decay_half": ("step_decay", (0.4, (5,), 0.5), (0, 1, 4, 5, 6, 100)),
    "inverse_sqrt": ("inverse_sqrt", (1e-3, 4000), (0, 1, 2, 3999, 4000, 4001, 100_000)),
    "exponential_decay": ("exponential_decay", (0.05, 100, 0.98), (0, 1, 50, 99, 100, 101, 1000)),
    "cosine": ("cosine", (0.1, 1000), (0, 1, 250, 500, 750, 1000, 1001, 5000)),
    "cosine_final_frac": ("cosine", (0.1, 1000, 0.1), (0, 1, 250, 500, 1000, 2000)),
    "chain_warmup_cosine": ("chain_warmup", (0.1, 100, 1000, "cosine"),
                            (0, 1, 50, 99, 100, 101, 550, 1000, 1200)),
    "chain_warmup_constant": ("chain_warmup", (0.1, 100, 1000, "constant"),
                              (0, 1, 99, 100, 101, 1000, 1200)),
    "linear_warmup_start": ("linear_warmup", None, (0, 1, 9, 10, 11, 40)),
}


def _make(module, name, args):
    if args is None:  # linear_warmup over a constant, from a non-zero start
        return module.linear_warmup(module.constant(0.2), 10, start_lr=0.05)
    return getattr(module, name)(*args)


@pytest.fixture(scope="module")
def jax_values():
    out = {}
    for case, (name, args, steps) in CASES.items():
        f = _make(jsched, name, args)
        out[case] = np.array([float(f(jnp.asarray(s, jnp.int32))) for s in steps])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_the_reference(case, jax_values):
    name, args, steps = CASES[case]
    f = _make(tsched, name, args)
    got = np.array([f(s) for s in steps])
    assert all(isinstance(f(s), float) for s in steps)
    np.testing.assert_allclose(got, jax_values[case], rtol=1e-6, atol=0)


def test_chain_warmup_unknown_kind_raises():
    with pytest.raises(ValueError, match="linear"):
        tsched.chain_warmup(0.1, 10, 100, kind="linear")
    with pytest.raises(ValueError):
        jsched.chain_warmup(0.1, 10, 100, kind="linear")


def test_the_port_has_every_reference_schedule():
    assert set(tsched.__all__) == set(jsched.__all__)
