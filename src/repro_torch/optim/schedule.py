"""Learning-rate schedules (warmup + cosine)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def warmup_cosine(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The scheduled learning rate at ``step`` (a 0-d tensor), in f32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)
