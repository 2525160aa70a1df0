"""Carry the JAX package's parameters across, as numpy arrays.

``from_jax_params`` takes the parameter tree of ``repro.models`` with
every leaf already a numpy array (the caller does
``jax.tree.map(np.asarray, params)`` — this module imports no JAX) and
returns the port's tree:

* ``params["decoder"]["stack"][pos]`` holds each pattern position's
  blocks stacked ``[n_periods, ...]`` and ``["rem"][pos]`` the leftover
  layers; they are unstacked into the port's per-layer list in layer
  order ``layer = period * len(pattern) + pos``.
* ``params["decoder"]["shared_attn"]`` (the tied block of the
  ``shared_attention`` positions, which the stack leaves out) becomes
  ONE dict that every such layer's entry holds.
* Weights keep their ``[in, out]`` orientation (both sides do
  ``x @ w``); ``embed.table`` / ``embed.head`` keep the padded vocab.
* Everything is cast once into ``dtype``; the leaves the model reads in
  f32 (``layers.F32_LEAVES``: RMSNorm scales, the recurrent blocks'
  decay and bonus vectors) stay f32.

Every leaf of the input must be consumed: a leaf the port has no place
for raises instead of being dropped silently.

``from_jax_train_state`` carries a whole JAX ``TrainState`` (params and
the AdamW ``m``, ``v`` and ``step``, numpy leaves) across as the port's
``TrainState``, everything f32 as the JAX package keeps it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import compute_dtype, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cast_params
from repro_torch.models.transformer import check_supported


def _leaf_paths(tree: Any, prefix: tuple = ()) -> set[tuple]:
    if isinstance(tree, dict):
        out: set[tuple] = set()
        for k, v in tree.items():
            out |= _leaf_paths(v, prefix + (k,))
        return out
    return {prefix}


def from_jax_params(params: dict, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """JAX-package parameter tree (numpy leaves) -> port parameters on
    ``device`` in ``dtype`` (default: the config's compute dtype)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg.dtype) if dtype is None else dtype
    unused = _leaf_paths(params)

    def take(path: tuple, index: int | None = None) -> torch.Tensor:
        node = params
        for key in path:
            node = node[key]
        unused.discard(path)
        arr = np.asarray(node)
        return torch.from_numpy(np.array(arr if index is None
                                         else arr[index]))

    def take_tree(path: tuple, index: int | None = None) -> Any:
        node = params
        for key in path:
            node = node[key]
        if isinstance(node, dict):
            return {k: take_tree(path + (k,), index) for k in node}
        return take(path, index)

    pattern = cfg.block_pattern
    n_periods = cfg.num_layers // len(pattern)
    shared = (take_tree(("decoder", "shared_attn"))
              if "shared_attention" in pattern else None)
    layers = []
    for layer in range(cfg.num_layers):
        period, pos = divmod(layer, len(pattern))
        if pattern[pos] == "shared_attention":
            layers.append(shared)        # tied: one dict at every position
        elif period < n_periods:
            layers.append(take_tree(("decoder", "stack", str(pos)), period))
        else:
            layers.append(take_tree(("decoder", "rem", str(pos))))
    out = {
        "embed": take_tree(("embed",)),
        "final_ln": take_tree(("final_ln",)),
        "layers": layers,
    }
    if unused:
        raise ValueError(
            "parameters the port has no place for: "
            + ", ".join("/".join(p) for p in sorted(unused)))
    return cast_params(out, dtype, dev)


def from_jax_train_state(state: Any, cfg: ModelConfig, *,
                         device: str | torch.device = "cuda") -> Any:
    """JAX-package ``TrainState`` (numpy leaves) -> the port's
    ``TrainState`` on ``device``: f32 master parameters and f32 moments
    laid out as the port's parameter tree, the step as a 0-d int32."""
    from repro_torch.optim import AdamWState
    from repro_torch.train.step import TrainState

    def tree(t):
        return from_jax_params(t, cfg, device=device, dtype=torch.float32)

    dev = resolve_device(device)
    step = torch.as_tensor(np.array(state.opt.step), dtype=torch.int32,
                           device=dev)
    return TrainState(tree(state.params),
                      AdamWState(step, tree(state.opt.m), tree(state.opt.v)))
