"""The rank side of ``tests/test_torch_tp_hybrid_encdec.py``: four processes
joined in a gloo group through a ``file://`` store, as a (2 data, 2 model)
grid, running the hybrid (recurrentgemma) and the encoder-decoder (whisper)
cases through ``_torch_tp_family_ranks``' runs and round trips.

``rank_main`` is the target of each spawned process. It imports torch and
``repro_torch`` only, runs torch on one thread, takes its job from the
parent's pipe, runs every case with the others and sends back numpy arrays
and plain values. A failure raises, and the process exits non-zero.
"""

import datetime

import torch
import torch.distributed as dist

import _torch_tp_family_ranks as fam
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.training import train_step as ts

TIMEOUT_S = fam.TIMEOUT_S


def rank_main(rank: int, world: int, store: str, conn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    job = conn.recv()
    grid = make_test_mesh((2, 2))
    result = {"coords": dict(grid.coords), "runs": {}, "round_trip": {}, "split": {}}
    for case, case_job in job["cases"].items():
        model = fam.model_of(case_job["arch"], case_job["overrides"])
        result["split"][case] = sorted(ts._tp_layout(
            model.abstract_params(), model.logical_axes(), grid).axis.split)
        for label in case_job["runs"]:
            result["runs"][(case, label)] = fam._run(case_job, grid, label)
    for case in job["round_trip"]:
        case_job = job["cases"][case]
        result["round_trip"][case] = fam._round_trip(case_job["arch"], grid,
                                                     case_job["overrides"])
    conn.send(result)
    dist.barrier()
    dist.destroy_process_group()
