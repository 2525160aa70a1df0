"""AdamW with f32 moments and the fused update kernel (B8).

The update is a pure value chain: ``apply_updates(use_kernel=True)``
runs it as one pass of ``kernels.ops.adamw_update`` per leaf (the
CUDA kernel on the GPU, its plain version on the CPU); without the
kernel it is the same math as PyTorch ops, which the offload compiler
fuses when the update is offloaded.  The int8 gradient compression of
the JAX package belongs to the sharding slice.

Like the JAX package the update is functional: it returns new
parameter and moment tensors and leaves its inputs as they were.

A tied block that several places of the parameter tree hold (zamba2's
shared attention, ``Ties``) has one AdamW entry: ``init_state`` gives
every place of it the same pair of moments, as the reference's tree holds
``shared_attn`` once.  The other functions map over the leaves they are
given: the training step gives them its unique tensors, so the block is
updated once and counts once in the global norm.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import Ties

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Params               # f32, mirrors params
    v: Params               # f32, mirrors params


def init_state(params: Params) -> AdamWState:
    ties = Ties(params)
    unique = ties.unique(params)

    def zeros():
        return ties.tree([torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device) for p in unique])
    dev = unique[0].device if unique else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def adamw_hyper(cfg: TrainConfig, lr: torch.Tensor, bc1: torch.Tensor,
                bc2: torch.Tensor) -> torch.Tensor:
    """The kernel's f32 ``hyper[7]``: lr, b1, b2, eps, wd, bc1, bc2."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=lr.device)
    return torch.stack([lr.float(), f32(cfg.beta1), f32(cfg.beta2),
                        f32(cfg.eps), f32(cfg.weight_decay), bc1.float(),
                        bc2.float()])


def apply_updates(params: Params, grads: Params, state: AdamWState,
                  cfg: TrainConfig, lr: torch.Tensor, *,
                  use_kernel: bool = False) -> tuple[Params, AdamWState]:
    """One AdamW step; ``lr`` is the scheduled learning rate (0-d).
    Each leaf is updated once: a tree that holds a tensor at several
    places is given as its unique tensors (``Ties.unique``), as the
    training step gives it."""
    step = state.step + 1
    bc1 = 1.0 - cfg.beta1 ** step.float()
    bc2 = 1.0 - cfg.beta2 ** step.float()

    if use_kernel:
        hyper = adamw_hyper(cfg, lr, bc1, bc2)

        def upd(p, g, m, v):
            return kops.adamw_update(p, g, m, v, hyper)
    else:
        def upd(p, g, m, v):
            gf = g.float()
            m_new = cfg.beta1 * m + (1 - cfg.beta1) * gf
            v_new = cfg.beta2 * v + (1 - cfg.beta2) * gf * gf
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), m_new, v_new

    flat_p, tree = pytree.tree_flatten(params)
    new = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, pytree.tree_leaves(grads), pytree.tree_leaves(state.m),
        pytree.tree_leaves(state.v))]
    return (pytree.tree_unflatten([n[0] for n in new], tree),
            AdamWState(step, pytree.tree_unflatten([n[1] for n in new], tree),
                       pytree.tree_unflatten([n[2] for n in new], tree)))


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for x in pytree.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           grads), norm
