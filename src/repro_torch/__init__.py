"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper.

The layout mirrors ``repro`` module for module so a reader finds each
counterpart (``repro_torch/models/attention.py`` next to
``repro/models/attention.py``).  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU is a hand-written
CUDA kernel under ``kernels/csrc``, built at first use.

This package imports ``torch``, numpy and the standard library only.
Entry points (``build_model``, ``Engine``, ``launch.serve``) run on the
GPU by default and raise when there is none; the CPU is used only when
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point should run on.  ``"cuda"`` (the
    default everywhere) raises when no CUDA device is present — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` -> torch dtype (bf16 unless float32)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


__all__ = ["compute_dtype", "resolve_device"]
