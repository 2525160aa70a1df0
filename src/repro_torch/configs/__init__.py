from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    reduced,
)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "RWKVConfig",
           "SSMConfig", "all_configs", "get_config", "reduced"]
