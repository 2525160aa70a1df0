"""The training step: loss -> grads -> clip -> AdamW.

With ``offload=True`` (or ``tcfg.offload``) the step runs through the
offload compiler (``repro_torch.core.offload``) on both sides of the
gradient: the *un-differentiated* loss is wrapped, so the backward flows
through the fused segments' planned backwards — each segment's
cotangent program is re-planned by the same planner, and the gradient
contractions (dx = g @ w^T, dw = x^T @ g) anchor the dlhs and drhs
kernels (B4, B6) instead of running unfused.  The optimizer update
(clip + AdamW elementwise math) is offloaded as its own program.
``tcfg.offload_policy`` selects the decision backend; None resolves the
active ``with offload_policy(...):`` scope at call time.

Gradient accumulation over microbatches is a Python loop summing f32
gradients.  The step is functional: it returns a new ``TrainState`` and
leaves the one it was given as it was.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import attention_only_pattern
from repro_torch.optim import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    init_state,
    warmup_cosine,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _offloaded(fn, tcfg: TrainConfig):
    from repro_torch.core.offload import mpu_offload
    return mpu_offload(fn, policy=tcfg.resolved_offload_policy())


def init_train_state(model: Model, seed: int = 0) -> TrainState:
    params = model.init(seed)
    return TrainState(params, init_state(params))


def device_batch(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig, *,
                    offload: bool | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``offload`` (default: ``tcfg.offload``) routes the loss and the
    update through the offload compiler.  The step exposes
    ``compute_grads(params, batch) -> (loss, metrics, grads)`` and, when
    offloaded, ``loss_fn`` / ``update_fn`` (the wrappers), ``stats`` /
    ``update_stats`` (their plan-cache counters) and ``explain_loss`` /
    ``explain_update`` (their decision reports).  Stacks with recurrent
    or tied blocks (zamba2, rwkv6) are served, not yet trained: raises."""
    if not attention_only_pattern(model.cfg) or \
            "shared_attention" in model.cfg.block_pattern:
        raise NotImplementedError(
            f"training {model.cfg.name} (blocks {model.cfg.block_pattern}) "
            "is not ported yet: the port trains dense attention stacks")
    use_offload = tcfg.offload if offload is None else offload

    def loss_fn(params, batch):
        return model.loss_fn(params, batch, remat=tcfg.remat)

    if use_offload:
        loss_fn = _offloaded(loss_fn, tcfg)

    def grads_of(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            pytree.tree_unflatten(list(grads), spec)

    def compute_grads(params, batch):
        batch = device_batch(batch, model.device)
        if tcfg.microbatches <= 1:
            return grads_of(params, batch)
        n = tcfg.microbatches
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = pytree.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, _, grads = grads_of(params, mb)
            acc = pytree.tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        inv = 1.0 / n
        grads = pytree.tree_map(lambda g: g * inv, acc)
        return loss_sum * inv, {"loss": loss_sum * inv}, grads

    def update_fn(params, grads, opt):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = warmup_cosine(tcfg, opt.step)
        params, opt = apply_updates(params, grads, opt, tcfg, lr)
        return params, opt, gnorm, lr

    if use_offload:
        update_fn = _offloaded(update_fn, tcfg)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grads = compute_grads(state.params, batch)
        with torch.no_grad():
            params, opt, gnorm, lr = update_fn(state.params, grads,
                                               state.opt)
        metrics = {**metrics, "grad_norm": gnorm, "lr": lr,
                   "loss": metrics.get("loss", loss)}
        return TrainState(params, opt), metrics

    train_step.compute_grads = compute_grads
    if use_offload:
        train_step.loss_fn = loss_fn
        train_step.update_fn = update_fn
        train_step.stats = loss_fn.stats
        train_step.update_stats = update_fn.stats
        train_step.explain_loss = loss_fn.explain
        train_step.explain_update = update_fn.explain
    return train_step


def make_eval_step(model: Model, tcfg: TrainConfig, *,
                   offload: bool | None = None):
    """Returns ``eval_step(params, batch) -> metrics`` (no gradients)."""
    def eval_step(params, batch):
        _, metrics = model.loss_fn(params, batch, remat=False)
        return metrics

    use_offload = tcfg.offload if offload is None else offload
    fn = _offloaded(eval_step, tcfg) if use_offload else eval_step

    @torch.no_grad()
    def run(params, batch):
        return fn(params, device_batch(batch, model.device))
    return run
