"""Kernel entry points: the dispatch shell of the port.

The counterpart of ``repro/kernels/ops.py`` for the kernels ported so
far.  ``impl`` is ``"auto"`` (``"cuda"`` for a CUDA tensor, ``"ref"``
for a CPU tensor), ``"cuda"`` (the hand-written kernel; raises for a CPU
tensor) or ``"ref"`` (the plain PyTorch version, on whatever device the
tensors are — how a kernel is compared with it on the card).  Nothing
here catches a kernel's failure.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (
    paged_decode_attention as _paged_decode_cuda,
    paged_decode_attention_plain,
)
from repro_torch.kernels.guard import kernel_guard, resolve_impl

#: every ported kernel, by the name its launch counter goes under
KERNELS = ("paged_decode_attention",)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, impl: str = "auto",
                           **kw) -> torch.Tensor:
    """Decode attention over a paged KV pool (block-table indexed)."""
    if resolve_impl(impl, q) == "ref":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, lengths)
    return _paged_decode_cuda(q, k_pages, v_pages, block_tables, lengths,
                              **kw)


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last ``reset_launch_counts``."""
    counts = kernel_guard().launches
    return {k: counts.get(k, 0) for k in KERNELS}


def reset_launch_counts() -> None:
    kernel_guard().launches.clear()
