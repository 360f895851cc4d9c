"""ScaleCom core: chunked ops, compressors, state, plan and the reduce."""

from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.rates import RateRule
from repro_torch.core.scalecom import ScaleComConfig, dense_reduce, scalecom_reduce
from repro_torch.core.state import ScaleComState, init_state

__all__ = [
    "CompressorConfig",
    "RateRule",
    "ScaleComConfig",
    "ScaleComState",
    "dense_reduce",
    "init_state",
    "scalecom_reduce",
]
