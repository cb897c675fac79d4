from repro_torch.configs.base import GraphConfig

__all__ = ["GraphConfig"]
