"""Guarded kernel dispatch: impl resolution, launch counts, health.

The counterpart of ``repro/kernels/guard.py``.  Every kernel entry point
in ``repro_torch.kernels.ops`` (and B9's autograd function) dispatches
through the process-wide ``KernelGuard.run``.  The chains are
``cuda -> ref`` for a CUDA tensor and ``ref`` for a CPU one; ``ref``,
the plain PyTorch version (the far pipeline), is never faulted and never
quarantined.

Only an **injected** fault demotes.  Before a ``cuda`` launch the guard
asks the installed fault injector (``set_injector``, or
``repro_torch.serve.faults.inject``), which may raise ``FaultInjected``:
that attempt is counted as a failure and the call is served by the
plain version.  Any other exception of a kernel propagates — a build or
launch failure on a CUDA tensor is a real fault and must surface; the
reference's chain would demote it, the port does not.

After ``threshold`` consecutive injected failures of one (kernel, impl)
pair the pair is **quarantined**: later calls go to the plain version
without a launch.  Each quarantine (and each ``reset`` that lifts one)
bumps ``epoch``, which the stack reads:

* ``core.offload.mpu_offload`` plans with ``mode="all_far"`` while a
  segment kernel (``SEGMENT_KERNELS``) is quarantined at the policy's
  impl (``degraded_for``), and bypasses its persistent plan store;
* the ``Engine`` and the compiled training step drop their CUDA graphs
  and looked-up plans on an epoch change and capture again.

The guard is consulted where a wrapper is called: an eager call, the
warm call and the capture of a CUDA graph.  A graph's replay calls no
wrapper and consults nothing, as the reference's guard is consulted at
trace time and never by a compiled executable.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: str, tensor: torch.Tensor) -> str:
    """Resolve ``"auto"`` from where the data lives: ``"cuda"`` (the
    hand-written kernel) for a CUDA tensor, ``"ref"`` (the plain PyTorch
    version) for a CPU tensor.  ``"cuda"`` on a CPU tensor raises: the
    kernel cannot run there and nothing stands in for it."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if tensor.is_cuda else "ref"
    if impl == "cuda" and not tensor.is_cuda:
        raise RuntimeError(
            "impl='cuda' needs tensors on a CUDA device, got "
            f"{tensor.device}; CPU tensors take impl='ref'")
    return impl


class LaunchRecord:
    """The ``count_launch`` / ``count_variant`` / ``count_into`` calls
    made while a CUDA graph was captured.  Capture launches nothing, and
    a replay launches every captured kernel without calling a wrapper, so
    the calls are kept here and ``replay()`` counts them once per replay
    of the graph."""

    def __init__(self, guard: "KernelGuard"):
        self._guard = guard
        self.calls: list[tuple[str, str | None, str | None]] = []
        #: the ``count_into`` calls: (counter, key, n)
        self.adds: list[tuple[dict, str, int]] = []

    def replay(self) -> None:
        for kernel, symbol, variant in self.calls:
            if variant is None:
                self._guard._add_launch(kernel)
            else:
                self._guard._add_variant(kernel, symbol, variant)
        for counter, key, n in self.adds:
            counter[key] = counter.get(key, 0) + n


#: fallback chain per resolved impl — ref (the far pipeline) is last
FALLBACK_CHAIN: dict[str, tuple[str, ...]] = {
    "cuda": ("cuda", "ref"),
    "ref": ("ref",),
}

#: kernels the offload planner dispatches fused segments to (the
#: reference's names) — a quarantine of one of these at the policy's
#: impl degrades ``mpu_offload`` wrappers to all_far planning
SEGMENT_KERNELS = frozenset({
    "fused_elementwise", "fused_segment", "fused_segment_grid",
    "fused_matmul", "fused_matmul_dlhs", "fused_matmul_drhs",
    "fused_flash",
})


@dataclass
class KernelGuard:
    """Per-process kernel bookkeeping and health.  ``launches[name]`` is
    a plain integer bumped by a wrapper exactly where it launches its
    kernel (inside ``recording()`` the call is recorded instead, and
    counted by each replay of the captured graph).  Health: injected
    failures per (kernel, impl), consecutive and total, quarantine after
    ``threshold`` consecutive ones; ``epoch`` changes with every
    quarantine state change."""

    threshold: int = 3
    epoch: int = 0
    injector: Any = None            # duck-typed: .kernel_launch(kernel, impl)
    kernel_failures: int = 0        # injected failures, all kernels
    kernel_fallbacks: int = 0       # calls served by the plain version
    quarantines: int = 0            # (kernel, impl) pairs ever quarantined
    launches: dict[str, int] = field(default_factory=dict)
    #: launches of a kernel with several variants (B4 / B6's sm90
    #: mainloop: by TMA or register-staged) by (kernel, variant), and the
    #: variant each generated symbol's last launch took
    variants: dict[tuple[str, str], int] = field(default_factory=dict)
    last_variant: dict[str, str] = field(default_factory=dict)
    _record: LaunchRecord | None = field(default=None, repr=False)
    _consec: dict[tuple[str, str], int] = field(default_factory=dict)
    _total: dict[tuple[str, str], int] = field(default_factory=dict)
    _quarantined: set[tuple[str, str]] = field(default_factory=set)
    _per_kernel: dict[str, dict[str, int]] = field(default_factory=dict)

    # -- health queries -----------------------------------------------------
    def is_quarantined(self, kernel: str, impl: str) -> bool:
        return (kernel, impl) in self._quarantined

    def chain(self, kernel: str, impl: str) -> tuple[str, ...]:
        """The impls a dispatch of ``kernel`` at the resolved ``impl``
        attempts, skipping quarantined entries.  Never empty: ref is
        unquarantinable."""
        return tuple(im for im in FALLBACK_CHAIN[impl]
                     if im == "ref" or not self.is_quarantined(kernel, im))

    def degraded_for(self, impl: str) -> bool:
        """True when a fused-segment kernel is quarantined at ``impl``
        (``"auto"`` reads as ``"cuda"``, the impl it takes on the card) —
        the signal ``mpu_offload`` maps to ``mode="all_far"``."""
        im = "cuda" if impl == "auto" else impl
        if im == "ref":
            return False
        return any((k, im) in self._quarantined for k in SEGMENT_KERNELS)

    def failures(self, kernel: str, impl: str) -> tuple[int, int]:
        """(consecutive, total) injected failures of ``(kernel, impl)``."""
        key = (kernel, impl)
        return self._consec.get(key, 0), self._total.get(key, 0)

    def health(self) -> dict[str, dict[str, int]]:
        """Per-kernel failure / fallback / quarantine counts."""
        return {k: dict(v) for k, v in self._per_kernel.items()}

    def stats(self) -> dict[str, int]:
        return {"guard_epoch": self.epoch,
                "kernel_failures": self.kernel_failures,
                "kernel_fallbacks": self.kernel_fallbacks,
                "quarantines": self.quarantines}

    # -- health bookkeeping ---------------------------------------------------
    def _bump(self, kernel: str, key: str) -> None:
        per = self._per_kernel.setdefault(kernel, {})
        per[key] = per.get(key, 0) + 1

    def record_failure(self, kernel: str, impl: str) -> bool:
        """Count one failed attempt; True if it tripped the quarantine.
        ref never quarantines."""
        self.kernel_failures += 1
        self._bump(kernel, f"failures_{impl}")
        key = (kernel, impl)
        self._total[key] = self._total.get(key, 0) + 1
        if impl == "ref":
            return False
        self._consec[key] = self._consec.get(key, 0) + 1
        if self._consec[key] >= self.threshold and \
                key not in self._quarantined:
            self._quarantined.add(key)
            self.quarantines += 1
            self.epoch += 1
            self._bump(kernel, f"quarantined_{impl}")
            return True
        return False

    def record_success(self, kernel: str, impl: str) -> None:
        self._consec.pop((kernel, impl), None)

    def reset(self) -> None:
        """Forget the failures and lift every quarantine (bumps epoch, so
        degraded plans and graphs are built again)."""
        had = bool(self._quarantined) or bool(self._consec)
        self._consec.clear()
        self._total.clear()
        self._quarantined.clear()
        if had:
            self.epoch += 1

    # -- the guarded dispatch -------------------------------------------------
    def run(self, kernel: str, impl: str, attempt: Callable[[str], Any]):
        """``attempt(im)`` for the resolved ``impl``'s chain: the kernel
        (``"cuda"``) unless it is quarantined or the injector faults this
        launch, else the plain version (``"ref"``).  Only
        ``FaultInjected`` demotes; any other exception propagates."""
        chain = self.chain(kernel, impl)
        if chain[0] == "cuda":
            try:
                if self.injector is not None:
                    self.injector.kernel_launch(kernel, "cuda")
                out = attempt("cuda")
            except Exception as e:
                if not _injected(e):
                    raise
                self.record_failure(kernel, "cuda")
            else:
                self.record_success(kernel, "cuda")
                return out
        if impl != "ref":
            self.kernel_fallbacks += 1
            self._bump(kernel, "fallback_ref")
        return attempt("ref")

    def count_launch(self, kernel: str) -> None:
        if self._record is not None:
            self._record.calls.append((kernel, None, None))
        else:
            self._add_launch(kernel)

    def count_variant(self, kernel: str, symbol: str, variant: str) -> None:
        if self._record is not None:
            self._record.calls.append((kernel, symbol, variant))
        else:
            self._add_variant(kernel, symbol, variant)

    def count_into(self, counter: dict, key: str, n: int = 1) -> None:
        """``counter[key] += n`` for work done beside a launch (the grid
        kernel's operand copies): now, or inside ``recording()`` once per
        replay of the captured graph, as launches are counted."""
        if self._record is not None:
            self._record.adds.append((counter, key, n))
        else:
            counter[key] = counter.get(key, 0) + n

    @contextmanager
    def recording(self) -> Iterator[LaunchRecord]:
        """Record instead of count the launches made inside (a CUDA
        graph's capture); the record's ``replay()`` counts them."""
        record, outer = LaunchRecord(self), self._record
        self._record = record
        try:
            yield record
        finally:
            self._record = outer

    def _add_launch(self, kernel: str) -> None:
        self.launches[kernel] = self.launches.get(kernel, 0) + 1

    def _add_variant(self, kernel: str, symbol: str, variant: str) -> None:
        self.variants[kernel, variant] = \
            self.variants.get((kernel, variant), 0) + 1
        self.last_variant[symbol] = variant


def _injected(e: Exception) -> bool:
    # the injector's module imports this one: resolved at the first fault
    from repro_torch.serve.faults import FaultInjected

    return isinstance(e, FaultInjected)


#: the process-wide guard every ops dispatch goes through
_GUARD = KernelGuard()


def kernel_guard() -> KernelGuard:
    return _GUARD


def set_injector(injector: Any) -> Any:
    """Install a fault injector on the process guard; returns the
    previous one (``serve.faults.inject`` restores it)."""
    prev = _GUARD.injector
    _GUARD.injector = injector
    return prev
