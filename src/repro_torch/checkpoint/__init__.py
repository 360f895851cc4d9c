from repro_torch.checkpoint.checkpoint import (
    latest_step, restore, restore_sharded, save, save_sharded,
)

__all__ = ["latest_step", "restore", "restore_sharded", "save", "save_sharded"]
