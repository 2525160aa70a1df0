"""Stand-ins for every model input that allocate nothing.

The counterpart of ``repro/launch/inputs.py``.  Where the reference
gives ``jax.ShapeDtypeStruct``s, the port gives tensors without storage:
``meta`` tensors by default, or fake tensors of a
``torch._subclasses.fake_tensor.FakeTensorMode`` (``fake_mode=``), which
the offload planner's capture traces as it traces real inputs.

    train_*    -> loss_fn(params, batch)                 ``batch_specs``
    prefill_*  -> prefill(params, batch, max_len)        ``prefill_specs``
    decode_*   -> decode_step(params, cache, token, pos) ``decode_specs``

[audio] / [vlm] configs get precomputed frontend embeddings (no port
config has one yet).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _spec(shape, dtype, fake_mode, device) -> torch.Tensor:
    if fake_mode is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    with fake_mode:
        return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, fake_mode=None,
                device: str | torch.device = "cpu") -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((b, s), torch.int32, fake_mode, device),
             "labels": _spec((b, s), torch.int32, fake_mode, device)}
    if cfg.frontend != "none":
        specs["frontend"] = _spec((b, cfg.frontend_len, cfg.d_model),
                                  torch.bfloat16, fake_mode, device)
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, *, fake_mode=None,
                  device: str | torch.device = "cpu") -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((b, s), torch.int32, fake_mode, device)}
    if cfg.frontend != "none":
        specs["frontend"] = _spec((b, cfg.frontend_len, cfg.d_model),
                                  torch.bfloat16, fake_mode, device)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, *, fake_mode=None,
                 device: str | torch.device = "cpu") -> dict:
    b = shape.global_batch
    return {"token": _spec((b,), torch.int32, fake_mode, device),
            "pos": _spec((b,), torch.int32, fake_mode, device)}


def abstract_tree(fn: Callable, *args, fake_mode=None) -> Any:
    """``fn(*args)`` run on fake tensors (``jax.eval_shape``'s use): the
    tree of what it returns, every tensor without storage.  A model's
    ``init`` gives its parameter tree so."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_mode if fake_mode is not None else FakeTensorMode():
        return fn(*args)
