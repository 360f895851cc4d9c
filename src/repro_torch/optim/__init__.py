from repro_torch.optim.optimizer import Optimizer, adam, make_optimizer, rmsprop, sgdm
from repro_torch.optim import schedule

__all__ = ["Optimizer", "adam", "make_optimizer", "rmsprop", "sgdm", "schedule"]
