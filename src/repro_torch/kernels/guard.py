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

from dataclasses import dataclass, field

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


@dataclass
class KernelGuard:
    """Per-process kernel bookkeeping.  ``launches[name]`` is a plain
    integer bumped by a wrapper exactly where it launches its kernel;
    ``epoch`` changes when kernel health changes, which nothing does
    until fault injection is ported (failure and quarantine counts
    arrive with it)."""

    epoch: int = 0
    launches: dict[str, int] = field(default_factory=dict)
    #: launches of a kernel with several variants (B4 / B6's sm90
    #: mainloop: by TMA or register-staged) by (kernel, variant), and the
    #: variant each generated symbol's last launch took
    variants: dict[tuple[str, str], int] = field(default_factory=dict)
    last_variant: dict[str, str] = field(default_factory=dict)

    def stats(self) -> dict[str, int]:
        return {"guard_epoch": self.epoch}

    def count_launch(self, kernel: str) -> None:
        self.launches[kernel] = self.launches.get(kernel, 0) + 1

    def count_variant(self, kernel: str, symbol: str, variant: str) -> None:
        self.variants[kernel, variant] = \
            self.variants.get((kernel, variant), 0) + 1
        self.last_variant[symbol] = variant


_GUARD = KernelGuard()


def kernel_guard() -> KernelGuard:
    return _GUARD
