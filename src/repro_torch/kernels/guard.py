"""Kernel dispatch state: impl resolution, launch counts, health epoch.

The counterpart of ``repro/kernels/guard.py`` reduced to what the
serving engine reads: ``kernel_guard().epoch``, ``stats()`` and
``resolve_impl``.  There is **no fallback chain** here: on a CUDA tensor
a wrapper launches its kernel or raises — a build or launch failure is
a real fault and must surface.  Demotion to the plain version is only
ever legitimate for *injected* faults and arrives with the fault
injector's port.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

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


@dataclass
class KernelGuard:
    """Per-process kernel bookkeeping.  ``launches[name]`` is a plain
    integer bumped by a wrapper exactly where it launches its kernel
    (inside ``recording()`` the call is recorded instead, and counted
    by each replay of the captured graph); ``epoch`` changes when kernel
    health changes, which nothing does until fault injection is ported
    (failure and quarantine counts arrive with it)."""

    epoch: int = 0
    launches: dict[str, int] = field(default_factory=dict)
    #: launches of a kernel with several variants (B4 / B6's sm90
    #: mainloop: by TMA or register-staged) by (kernel, variant), and the
    #: variant each generated symbol's last launch took
    variants: dict[tuple[str, str], int] = field(default_factory=dict)
    last_variant: dict[str, str] = field(default_factory=dict)
    _record: LaunchRecord | None = field(default=None, repr=False)

    def stats(self) -> dict[str, int]:
        return {"guard_epoch": self.epoch}

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


_GUARD = KernelGuard()


def kernel_guard() -> KernelGuard:
    return _GUARD
