"""Configs the port serves: `ModelConfig` and its registry (jax-free copies
of `repro.configs`), and the paper nets' configs."""
from repro_torch.configs.base import (
    ModelConfig, get_config, list_archs, register,
)

__all__ = ["ModelConfig", "get_config", "list_archs", "register"]
