"""Architecture registry: ``--arch <id>`` resolution.

Arch ids keep the assignment spelling (dashes/dots); module names use
underscores.  The dense decoders, the hybrid Mamba2 stack (zamba2) and
RWKV6 are ported; the remaining ids of ``repro.configs.registry``
follow with the rest of the model zoo.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: dict[str, str] = {
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
