"""Fault-tolerance manager of the training loop (the port's copy of
``repro/ckpt/manager.py``): periodic checkpoints, restart, elastic data
axis, and straggler accounting.

  * ``CheckpointManager.maybe_save`` checkpoints every N steps (atomic,
    bounded retention);
  * ``restore_or_init`` resumes from the newest complete checkpoint,
    walking back over corrupt or torn steps — a crashed job restarts from
    the last commit, and the data pipeline's (seed, step) determinism
    replays the exact batch stream;
  * ``elastic_data_axis`` shrinks the data axis to the largest size the
    surviving hosts can populate evenly;
  * ``StragglerMonitor`` tracks per-step wall times and flags steps
    beyond ``median * tolerance`` or a hard per-step deadline.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import TrainConfig


@dataclass
class StragglerMonitor:
    """Per-step wall-time tracking with two trip wires: the relative
    one (``median * tolerance``, needs a 5-step history) and an optional
    *hard* per-step deadline (``deadline_s`` > 0, checked from step 0 —
    wired from ``TrainConfig.step_deadline_s``).  Hard misses land in
    ``deadline_misses`` as well as ``flagged`` so the loop can react
    (commit a checkpoint before the runbook's swap/restart)."""

    tolerance: float = 2.0
    window: int = 50
    deadline_s: float = 0.0      # hard per-step deadline; 0 = disabled
    times: list[float] = field(default_factory=list)
    flagged: list[tuple[int, float]] = field(default_factory=list)
    deadline_misses: list[tuple[int, float]] = field(default_factory=list)
    # lifetime totals survive the window trim (the lists are bounded so
    # month-long runs don't grow memory; counts must not reset with them)
    total_flagged: int = 0
    total_deadline_misses: int = 0
    _t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler (relative outlier
        or hard-deadline miss)."""
        assert self._t0 is not None
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        self.times = self.times[-self.window:]
        med = sorted(self.times)[len(self.times) // 2]
        hard = self.deadline_s > 0 and dt > self.deadline_s
        if hard:
            self.deadline_misses.append((step, dt))
            self.deadline_misses = self.deadline_misses[-self.window:]
            self.total_deadline_misses += 1
        if hard or (len(self.times) >= 5 and dt > med * self.tolerance):
            self.flagged.append((step, dt))
            self.flagged = self.flagged[-self.window:]
            self.total_flagged += 1
            return True
        return False

    def missed_deadline(self, step: int) -> bool:
        """Did ``step`` trip the hard deadline?  (Checks the tail only —
        intended for the just-stopped step.)"""
        return bool(self.deadline_misses
                    and self.deadline_misses[-1][0] == step)


def elastic_data_axis(requested: int, surviving_hosts: int,
                      hosts_per_data_shard: int = 1) -> int:
    """Largest data-axis size <= requested that the surviving hosts can
    populate evenly."""
    capacity = max(1, surviving_hosts // hosts_per_data_shard)
    size = min(requested, capacity)
    while size > 1 and requested % size != 0:
        size -= 1
    return max(1, size)


class CheckpointManager:
    """Checkpoints of one training run under ``cfg.checkpoint_dir``
    (required once ``cfg.checkpoint_every > 0``: ``TrainConfig`` checks
    it)."""

    def __init__(self, cfg: TrainConfig, *, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        # durability observability: how the last restore walked back and
        # whether any saves were dropped on disk faults
        self.counters = {"restore_walkbacks": 0, "restore_corrupt_skipped": 0,
                         "save_failures": 0}

    def restore_or_init(self, init_fn: Callable[[], Any]) -> tuple[Any, int]:
        """Returns (state, start_step).  A checkpoint at step N holds
        the state *after* N's update (``maybe_save`` runs post-step), so
        the resumed loop starts at N + 1.

        Walk-back: steps that fail verification (``ckpt.verify_step``)
        or fail to load are skipped, newest first, until a complete and
        verified checkpoint restores.  ``restore`` writes into the tree
        ``init_fn()`` made, so a load that fails part way is followed by
        a fresh ``init_fn()`` — a corrupt checkpoint never leaks into the
        state returned.  With no directory configured: ``(init_fn(), 0)``."""
        example = init_fn()
        directory = self.cfg.checkpoint_dir
        if directory is None:
            return example, 0
        for step in reversed(ckpt.all_steps(directory)):
            status = ckpt.verify_step(directory, step)
            if status not in ("verified", "legacy"):
                self.counters["restore_corrupt_skipped"] += 1
                self.counters["restore_walkbacks"] += 1
                continue
            try:
                state = ckpt.restore(directory, step, example,
                                     num_hosts_now=self.num_hosts)
            except ckpt.CheckpointCorrupt:
                self.counters["restore_corrupt_skipped"] += 1
                self.counters["restore_walkbacks"] += 1
                example = None          # its leaves may be half written
                example = init_fn()
                continue
            return state, step + 1
        return example, 0

    def maybe_save(self, step: int, state: Any, *, force: bool = False):
        if self.cfg.checkpoint_dir is None:
            return None
        if not force and (self.cfg.checkpoint_every <= 0
                          or step % self.cfg.checkpoint_every != 0
                          or step == 0):
            return None
        try:
            return ckpt.save(self.cfg.checkpoint_dir, step, state,
                             host_id=self.host_id, num_hosts=self.num_hosts,
                             keep=self.cfg.keep_checkpoints)
        except OSError:
            # a transient disk fault drops THIS save, not the run; the
            # partial .tmp dir is invisible to restore and the next
            # cadence point retries
            self.counters["save_failures"] += 1
            return None
