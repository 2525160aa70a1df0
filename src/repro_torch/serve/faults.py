"""Deterministic fault injection for the serving stack (the port's copy
of ``repro/serve/faults.py``: the same classes, streams and draws).

Real near-bank hardware faults routinely (transient per-bank errors,
thermal throttling — see the UPMEM characterization in PAPERS.md), so
every degradation path in this repo must be exercisable in CI without
real hardware.  ``FaultInjector`` is a seeded source of four fault
classes:

* **kernel launch failures** — raised from ``KernelGuard.run`` before a
  ``cuda`` launch, driving the ``cuda -> ref`` demotion and (with
  ``kernel_fail_burst`` >= the guard threshold) the quarantine + all_far
  re-plan path.  The ref attempt is *never* faulted: it is the far
  pipeline, the paper's always-works tier.  The guard is consulted where
  a wrapper is called — an eager call, the warm call and the capture of
  a CUDA graph — never by a graph's replay, as the reference's guard is
  consulted at trace time and never by a compiled executable.
* **NaN/Inf logits** — ``poison_slots`` marks at most one active slot
  per step; the engine turns the mark into non-finite logits on device
  and must abort only that request.
* **page-alloc failures** — ``page_alloc`` makes ``PagePool`` growth
  transiently fail, driving the engine's pause/retry path.
* **slow steps** — ``slow_step`` sleeps, driving deadline expiry.
* **disk IO faults** — ``disk_io`` makes durable-artifact reads/writes
  (``repro_torch/core/artifacts.py``: the persistent plan cache and the
  hardened checkpoint store) raise or return truncated bytes, driving the
  counted-miss / quarantine / walk-back degradation paths.

Each class draws from its own ``numpy`` Generator stream (seed + class
offset), so enabling one class never perturbs another's sequence — a
chaos run's fault schedule is a pure function of (seed, call counts).

``inject(injector)`` installs the injector on the process-wide kernel
guard AND the artifact layer for a scope; ``Engine(fault_injector=...)``
does the same for the engine's lifetime and additionally consults the
injector for the step-time classes (NaN, page, slow).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.artifacts import set_disk_injector
from repro_torch.kernels.guard import set_injector


class FaultInjected(RuntimeError):
    """A simulated fault (kernel launch failure) raised by the injector."""


@dataclass(frozen=True)
class FaultConfig:
    """Rates/limits for each fault class.  All rates are per-draw
    probabilities in [0, 1]; 0 disables the class."""

    kernel_fail_rate: float = 0.0
    kernel_fail_burst: int = 3      # consecutive failures once triggered
    kernel_targets: tuple = ()      # () = any kernel; else restrict by name
    nan_logit_rate: float = 0.0
    nan_logit_limit: int = 0        # max total poisoned slots; 0 = unlimited
    page_fail_rate: float = 0.0
    slow_step_rate: float = 0.0
    slow_step_s: float = 0.0
    disk_fail_rate: float = 0.0
    disk_truncate_share: float = 0.5  # of triggered faults: torn vs raise
    seed: int = 0


@dataclass
class FaultInjector:
    """Seeded, per-class-stream fault source.  Stateless apart from the
    rng streams and counters — safe to share across engine rebuilds."""

    cfg: FaultConfig = field(default_factory=FaultConfig)
    counters: dict = field(default_factory=dict)

    def __post_init__(self):
        s = self.cfg.seed
        self._rng_kernel = np.random.default_rng(s + 1)
        self._rng_nan = np.random.default_rng(s + 2)
        self._rng_page = np.random.default_rng(s + 3)
        self._rng_slow = np.random.default_rng(s + 4)
        self._rng_disk = np.random.default_rng(s + 5)
        self._burst: dict = {}      # (kernel, impl) -> remaining failures
        self._nan_total = 0
        for k in ("kernel_faults", "nan_injected", "page_faults_injected",
                  "slow_steps", "disk_faults_injected"):
            self.counters.setdefault(k, 0)

    # -- kernel launch (called from KernelGuard.run, before a launch) -------
    def kernel_launch(self, kernel: str, impl: str) -> None:
        """Raise ``FaultInjected`` to simulate a launch failure.  Never
        faults ref (the far pipeline must stay available) — the guard
        only consults us for non-ref impls, but double-check anyway."""
        if impl == "ref" or self.cfg.kernel_fail_rate <= 0.0:
            return
        if self.cfg.kernel_targets and kernel not in self.cfg.kernel_targets:
            return
        key = (kernel, impl)
        if self._burst.get(key, 0) > 0:
            self._burst[key] -= 1
        elif self._rng_kernel.random() < self.cfg.kernel_fail_rate:
            self._burst[key] = max(0, self.cfg.kernel_fail_burst - 1)
        else:
            return
        self.counters["kernel_faults"] += 1
        raise FaultInjected(f"injected launch failure: {kernel}/{impl}")

    # -- step-time classes (called from Engine.step, host side) -------------
    def poison_slots(self, active: np.ndarray) -> np.ndarray:
        """Bool [slots] mask of rows whose logits this step should be
        forced non-finite.  At most one slot per step, and at most
        ``nan_logit_limit`` total (0 = unlimited)."""
        mask = np.zeros_like(active, dtype=bool)
        limit = self.cfg.nan_logit_limit
        if self.cfg.nan_logit_rate <= 0.0 or not active.any():
            return mask
        if limit > 0 and self._nan_total >= limit:
            return mask
        if self._rng_nan.random() < self.cfg.nan_logit_rate:
            idx = np.flatnonzero(active)
            pick = idx[self._rng_nan.integers(len(idx))]
            mask[pick] = True
            self._nan_total += 1
            self.counters["nan_injected"] += 1
        return mask

    def page_alloc(self) -> bool:
        """True = this page-pool growth attempt should transiently fail."""
        if self.cfg.page_fail_rate <= 0.0:
            return False
        if self._rng_page.random() < self.cfg.page_fail_rate:
            self.counters["page_faults_injected"] += 1
            return True
        return False

    def slow_step(self) -> None:
        """Maybe sleep to simulate a straggler step (drives deadlines)."""
        if self.cfg.slow_step_rate <= 0.0 or self.cfg.slow_step_s <= 0.0:
            return
        if self._rng_slow.random() < self.cfg.slow_step_rate:
            self.counters["slow_steps"] += 1
            time.sleep(self.cfg.slow_step_s)

    def disk_io(self, op: str) -> str | None:
        """Consulted by ``repro_torch/core/artifacts.py`` on every durable
        read or write.  Returns ``None`` (no fault), ``"raise"`` (IO error) or
        ``"truncate"`` (torn transfer: the payload is cut short, which a
        reader must detect via the commit marker's checksum)."""
        if self.cfg.disk_fail_rate <= 0.0:
            return None
        if self._rng_disk.random() >= self.cfg.disk_fail_rate:
            return None
        self.counters["disk_faults_injected"] += 1
        if self._rng_disk.random() < self.cfg.disk_truncate_share:
            return "truncate"
        return "raise"

    def stats(self) -> dict:
        return dict(self.counters)


@contextlib.contextmanager
def inject(injector: FaultInjector | None):
    """Install ``injector`` on the process kernel guard AND the durable
    artifact layer for the scope of the ``with`` block (restores the
    previous injectors on exit)."""
    prev = set_injector(injector)
    prev_disk = set_disk_injector(injector)
    try:
        yield injector
    finally:
        set_injector(prev)
        set_disk_injector(prev_disk)
