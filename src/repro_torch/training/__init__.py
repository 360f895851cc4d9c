from repro_torch.training.train_step import (
    TrainState,
    build_train_step,
    init_train_state,
    shard_train_state,
)
from repro_torch.training.loop import TrainLoop, run_training

__all__ = [
    "TrainState", "build_train_step", "init_train_state", "shard_train_state", "TrainLoop",
    "run_training",
]
