from .base import ModelConfig, get_config, register

__all__ = ["ModelConfig", "get_config", "register"]
