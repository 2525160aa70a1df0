from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    reduced,
)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "RWKVConfig",
           "SSMConfig", "ShapeConfig", "TrainConfig", "all_configs",
           "get_config", "reduced"]
