"""Real collectives: ScaleCom's reduce with one worker per process, or one
group of processes per worker (``ring``), the port of
``repro.distributed``. Importing starts no process and joins no group."""

from repro_torch.distributed.ring import (
    Hierarchy,
    all_reduce_mean,
    clt_ring_reduce,
    group_fold,
    make_hierarchy,
    make_ring_reducer,
    payload_sent,
    reset_sent,
    ring_reduce,
    sent,
)

__all__ = [
    "Hierarchy", "all_reduce_mean", "clt_ring_reduce", "group_fold", "make_hierarchy",
    "make_ring_reducer", "payload_sent", "reset_sent", "ring_reduce", "sent",
]
