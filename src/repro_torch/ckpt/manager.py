"""Straggler accounting of the training loop (the port's copy of
``StragglerMonitor`` in ``repro/ckpt/manager.py``).

``StragglerMonitor`` tracks per-step wall times and flags steps beyond
``median * tolerance`` or a hard per-step deadline.  The checkpoint
manager (periodic atomic checkpoints, restore, elastic re-mesh) arrives
with the durability slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


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
