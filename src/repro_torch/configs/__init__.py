from repro_torch.configs.base import ArchConfig
from repro_torch.configs import registry

__all__ = ["ArchConfig", "registry"]
