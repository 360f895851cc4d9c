from repro_torch.checkpoint.checkpoint import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
