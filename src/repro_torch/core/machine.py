"""The machine model the offload decision prices traffic with.

The counterpart of ``repro/core/machine.py`` for the card the port runs
on.  Only datasheet figures (NVIDIA's, H100 SXM) are used: they price
the ``cost`` decision and bound the kernels, and no number here is a
measurement.  The JAX package's MPU and GPU models arrive with the
simulator slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class H100:
    """One NVIDIA H100 SXM (datasheet)."""

    hbm_gbps: float = 3350.0            # device memory, GB/s
    smem_bytes: int = 232448            # shared memory one block can use
    sms: int = 132                      # streaming multiprocessors
    l2_bytes: int = 50 * 1024 * 1024    # L2 cache


H100_SXM = H100()
