"""Scale & failure scenario harness for the port's ScaleCom reduce.

The port of ``repro.harness``. Sweeps worker counts (flat and hierarchical
topologies), injects faults — stragglers, dropped/rejoining workers, stale
or corrupt EF residues — around the genuine ``scalecom_reduce`` on the
run's device, and asserts per-step invariants: gradient build-up bounded,
trajectories within codec tolerance of the fault-free run, and comm-byte
accounting matching ``core.plan``.

Entry points:

  ``python -m repro_torch.harness --scenarios drop,straggler,stale --workers 8,64``
  ``run_scenario(name, workers, ..., device="cuda")`` /
  ``run_buildup_sweep(..., device="cuda")`` from code;
  ``python -m repro_torch.launch.train --preflight-scenarios NAMES``.

Submodules: ``scenarios`` (runner + registry), ``injectors`` (fault layer),
``invariants`` (per-step checks), ``cli``.
"""

from repro_torch.harness.injectors import (
    CorruptResidueInjector,
    DropRejoinInjector,
    Injector,
    StaleResidueInjector,
    StepContext,
    StragglerInjector,
)
from repro_torch.harness.invariants import (
    CODEC_TOL,
    check_buildup,
    check_comm_accounting,
    check_trajectory,
    codec_tolerance,
)
from repro_torch.harness.scenarios import (
    SCENARIOS,
    ScenarioResult,
    ScenarioSpec,
    elastic_groups,
    elastic_replan,
    make_stream,
    run_buildup_sweep,
    run_scenario,
    scenario_names,
)

__all__ = [
    "CODEC_TOL",
    "CorruptResidueInjector",
    "DropRejoinInjector",
    "Injector",
    "SCENARIOS",
    "ScenarioResult",
    "ScenarioSpec",
    "StaleResidueInjector",
    "StepContext",
    "StragglerInjector",
    "check_buildup",
    "check_comm_accounting",
    "check_trajectory",
    "codec_tolerance",
    "elastic_groups",
    "elastic_replan",
    "make_stream",
    "run_buildup_sweep",
    "run_scenario",
    "scenario_names",
]
