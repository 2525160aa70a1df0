"""The training loop: data -> step -> metrics -> checkpoint -> restart,
on one device.

The step is compiled as the reference's loop jits it, with the state
donated (``compile_train_step``): on a CUDA device each batch signature
gets one warm step and one CUDA graph capture, and every later step is a
replay over the donated state's own buffers; ``train_step.counters``
holds ``train_traces``.  Checkpoints and restart mirror
``repro/train/loop.py``: ``CheckpointManager.restore_or_init`` runs
before the compiled step takes the state over, a save runs at the
cadence (forced on a hard deadline miss) and once at the end, and a save
reads the donated state after the step's replay has finished.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.ckpt import CheckpointManager, StragglerMonitor
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
    """Train up to step ``steps`` (default ``tcfg.total_steps``) on
    ``device`` (default: the GPU; raises when there is none), resuming
    from ``tcfg.checkpoint_dir`` where it holds a checkpoint.  Returns the
    final state and one metrics dict a step run; ``on_step`` is given the
    compiled step once it is built (its counters, graph and plan
    stats)."""
    model = build_model(cfg, device=device)
    train_step = compile_train_step(model, tcfg)
    if on_step:
        on_step(train_step)
    data = SyntheticLM(make_data_config(cfg, shape, tcfg.seed))
    mgr = CheckpointManager(tcfg)
    straggler = StragglerMonitor(tolerance=2.0,
                                 deadline_s=tcfg.step_deadline_s)
    state, start = mgr.restore_or_init(
        lambda: init_train_state(model, tcfg.seed))
    total = steps if steps is not None else tcfg.total_steps

    history: list[dict] = []
    t_start = time.monotonic()
    last_step = start - 1      # last step actually executed THIS run
    for step in range(start, total):
        batch = data.batch(step)
        straggler.start()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        was_slow = straggler.stop(step)
        missed = straggler.missed_deadline(step)
        metrics["straggler"] = float(was_slow)
        metrics["deadline_miss"] = float(missed)
        history.append({"step": step, **metrics})
        if on_metrics:
            on_metrics(step, metrics)
        if log_every and step % log_every == 0:
            dt = time.monotonic() - t_start
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} ({dt:.0f}s)")
        # a hard-deadline miss is the runbook's swap/restart trigger:
        # commit the state first so the restart loses nothing.  The
        # metrics were read, so the step's work on the device is done
        mgr.maybe_save(step, state, force=missed)
        last_step = step
    # final commit, labelled with the step the state reflects; guarded on
    # last_step >= start so a restart that finds start >= total never
    # saves the restored state under an earlier label
    if last_step >= start:
        mgr.maybe_save(last_step, state, force=(tcfg.checkpoint_every > 0))
    return state, history
