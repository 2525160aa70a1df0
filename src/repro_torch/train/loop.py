"""The training loop: data -> step -> metrics, on one device.

The step is compiled as the reference's loop jits it, with the state
donated (``compile_train_step``): on a CUDA device each batch signature
gets one warm step and one CUDA graph capture, and every later step is a
replay over the donated state's own buffers; ``train_step.counters``
holds ``train_traces``.  Checkpointing and restart arrive with the
durability slice (ROADMAP queue A, item 5): until then ``train`` refuses
a config that asks for periodic checkpoints instead of silently skipping
them.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.ckpt import StragglerMonitor
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data import SyntheticLM, make_data_config
from repro_torch.models import build_model
from repro_torch.train.step import (
    CompiledTrainStep,
    TrainState,
    compile_train_step,
    init_train_state,
)


def train(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig, *,
          steps: int | None = None, log_every: int = 10,
          device: str | torch.device = "cuda",
          on_metrics: Callable[[int, dict], None] | None = None,
          on_step: Callable[[CompiledTrainStep], None] | None = None
          ) -> tuple[TrainState, list[dict]]:
    """Train from a fresh state for ``steps`` (default
    ``tcfg.total_steps``) steps on ``device`` (default: the GPU; raises
    when there is none).  Returns the final state and one metrics dict a
    step; ``on_step`` is given the compiled step once it is built (its
    counters, graph and plan stats)."""
    if tcfg.checkpoint_every > 0:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP queue A, item 5: "
            "durability); leave TrainConfig.checkpoint_every at 0")
    model = build_model(cfg, device=device)
    train_step = compile_train_step(model, tcfg)
    if on_step:
        on_step(train_step)
    data = SyntheticLM(make_data_config(cfg, shape, tcfg.seed))
    straggler = StragglerMonitor(tolerance=2.0,
                                 deadline_s=tcfg.step_deadline_s)
    state = init_train_state(model, tcfg.seed)
    total = steps if steps is not None else tcfg.total_steps

    history: list[dict] = []
    t_start = time.monotonic()
    for step in range(total):
        batch = data.batch(step)
        straggler.start()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["straggler"] = float(straggler.stop(step))
        metrics["deadline_miss"] = float(straggler.missed_deadline(step))
        history.append({"step": step, **metrics})
        if on_metrics:
            on_metrics(step, metrics)
        if log_every and step % log_every == 0:
            dt = time.monotonic() - t_start
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} ({dt:.0f}s)")
    return state, history
