"""Real collectives: the CLT-k reduce with one ScaleCom worker per process
(``ring``), the port of ``repro.distributed``. Importing starts no process
and joins no group."""

from repro_torch.distributed.ring import (
    all_reduce_mean,
    clt_ring_reduce,
    make_ring_reducer,
    reset_sent,
    sent,
)

__all__ = ["clt_ring_reduce", "make_ring_reducer", "all_reduce_mean", "sent", "reset_sent"]
