from .base import ModelConfig, all_archs, get_config, register

__all__ = ["ModelConfig", "all_archs", "get_config", "register"]
