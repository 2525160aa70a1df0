"""Location lattice of the paper's Algorithm 1.

The counterpart of ``repro/core/isa.py`` reduced to ``Loc``: the
instruction IR, its annotation pass and the policy projection arrive
with the simulator slice of the port.

    U  unknown
    N  near-bank   (value registers / compute on loaded data)
    F  far-bank    (addresses, control flow, far-only opcodes)
    B  both        (conflicting N/F evidence -> lives in both RFs)
"""
from __future__ import annotations

import enum


class Loc(enum.Enum):
    U = "U"
    N = "N"
    F = "F"
    B = "B"
