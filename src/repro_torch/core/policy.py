"""First-class offload policy: one object for the §IV-B1 decision.

The counterpart of ``repro/core/policy.py`` for the planner's side (the
simulator's location policies arrive with the simulator slice).

* ``OffloadPolicy`` — a frozen, hashable configuration: the decision
  mode, the planner thresholds (``bulk_threshold``, ``min_segment``),
  the runtime knobs (``impl``, ``max_plans``, ``smem_budget``) and the
  machine model whose bandwidths the ``cost`` backend prices traffic
  with.  It is part of every plan-cache key.
* ``offload_policy(p)`` — a context manager for scoped overrides.
* ``SegmentDecision`` / ``DecisionReport`` — the per-candidate verdicts
  the planner records and ``wrapped.explain(*args)`` renders.

Decision backends
-----------------

``greedy``    the default: fuse an admissible candidate with at least
              ``min_segment`` ALU ops (an anchored one needs >= 1 fused
              op — a bare contraction only adds the row workspace).
``cost``      price the candidate both ways — fused bytes
              (``Segment.io_bytes``) against the far path's per-op
              round trips — at the machine's bandwidths and decline
              whenever far is modeled no slower.
``all_near``  fuse every admissible candidate.
``all_far``   never fuse: every op runs unfused.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator

from repro_torch.core.machine import H100_SXM

#: decision backends of the planner
PLANNER_MODES: tuple[str, ...] = ("greedy", "cost", "all_near", "all_far")


@dataclass(frozen=True)
class OffloadPolicy:
    """Every knob of the offload subsystem in one frozen, hashable value.

    ``mode``           decision backend (see module docstring)
    ``bulk_threshold`` minimum tensor size for a value to seed a segment
    ``min_segment``    greedy mode's ALU-op floor per fused segment
    ``max_plans``      LRU bound of a wrapper's plan cache
    ``impl``           kernel dispatch: "auto" | "cuda" | "ref"
    ``smem_budget``    the anchored kernels' accumulator budget in bytes
                       (None: one block's shared memory on the machine);
                       planner and kernel honor the same value
    ``machine``        the machine model pricing the ``cost`` decision
    """

    mode: str = "greedy"
    bulk_threshold: int = 1024
    min_segment: int = 2
    max_plans: int = 128
    impl: str = "auto"
    smem_budget: int | None = None
    machine: Any = H100_SXM

    def __post_init__(self):
        if self.mode not in PLANNER_MODES:
            raise ValueError(f"OffloadPolicy.mode {self.mode!r}: expected "
                             f"one of {sorted(PLANNER_MODES)}")
        if self.impl not in ("auto", "cuda", "ref"):
            raise ValueError(f"OffloadPolicy.impl {self.impl!r}: expected "
                             "auto, cuda or ref")
        if self.max_plans < 1:
            raise ValueError("max_plans must be >= 1")
        if self.min_segment < 1:
            raise ValueError("min_segment must be >= 1")
        if self.smem_budget is not None and self.smem_budget < 4096:
            raise ValueError("smem_budget must be >= 4096 bytes")

    @property
    def budget(self) -> int:
        """The accumulator budget the planner and kernels share."""
        return (self.machine.smem_bytes if self.smem_budget is None
                else self.smem_budget)

    # -- the cost model ----------------------------------------------------
    def modeled_us(self, near_bytes: int, far_bytes: int
                   ) -> tuple[float, float]:
        """(near_us, far_us): the candidate priced both ways (memory
        bound: time == bytes / bandwidth).  A fused segment streams the
        same HBM as the far path: the gain is moving fewer bytes, not a
        faster wire."""
        gbps = float(self.machine.hbm_gbps)
        return near_bytes / (gbps * 1e3), far_bytes / (gbps * 1e3)

    def decide(self, *, tier: str, n_compute: int, near_bytes: int,
               far_bytes: int) -> "SegmentDecision":
        """The §IV-B1 decision for one candidate segment."""
        near_us, far_us = self.modeled_us(near_bytes, far_bytes)
        if self.mode == "all_far":
            fuse, reason = False, "policy all_far: far pipeline only"
        elif self.mode == "all_near":
            fuse, reason = True, "policy all_near: fuse every admissible"
        elif self.mode == "cost":
            fuse = near_us < far_us
            ratio = far_us / max(near_us, 1e-12)
            reason = (f"modeled near {ratio:.2f}x faster" if fuse else
                      f"far path no slower ({near_us:.2f}us near vs "
                      f"{far_us:.2f}us far)")
        elif tier == "anchor":
            fuse = n_compute >= 1
            reason = ("anchored: epilogue/prologue rides the accumulator"
                      if fuse else
                      "bare contraction: no fused ALU work")
        else:
            fuse = n_compute >= self.min_segment
            reason = (f"{n_compute} ALU ops >= min_segment" if fuse else
                      f"{n_compute} ALU ops < min_segment="
                      f"{self.min_segment}")
        return SegmentDecision(
            tier=tier, form=None, eqns=n_compute, rows=0, roles=(),
            near_bytes=near_bytes, far_bytes=far_bytes, near_us=near_us,
            far_us=far_us, fused=fuse, reason=reason)


#: the process-wide default policy
DEFAULT_POLICY = OffloadPolicy()

_tls = threading.local()


def current_policy() -> OffloadPolicy:
    """The innermost active ``offload_policy(...)`` override, else the
    default."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else DEFAULT_POLICY


def active_policy_override() -> OffloadPolicy | None:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def offload_policy(policy: OffloadPolicy) -> Iterator[OffloadPolicy]:
    """Scoped policy override: inside the block every wrapped call
    resolves to ``policy`` (and keys its plan cache on it)."""
    if not isinstance(policy, OffloadPolicy):
        raise TypeError(f"expected OffloadPolicy, got {type(policy)!r}")
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(policy)
    try:
        yield policy
    finally:
        stack.pop()


def resolve_policy(policy: OffloadPolicy | None = None) -> OffloadPolicy:
    """The explicit policy, else the active scoped override, else the
    default."""
    return policy if policy is not None else current_policy()


@dataclass(frozen=True)
class SegmentDecision:
    """One candidate segment's §IV-B1 verdict."""

    tier: str                    # "elementwise" | "anchor"
    form: str | None             # fwd/dlhs/drhs/flash for anchored candidates
    eqns: int                    # fused ALU ops (n_compute)
    rows: int                    # shared row extent of the block views
    roles: tuple[str, ...]       # operand roles (bulk/param/rep/tile/...)
    near_bytes: int              # fused kernel traffic (Segment.io_bytes)
    far_bytes: int               # per-op round trips on the far path
    near_us: float
    far_us: float
    fused: bool
    reason: str
    batch: tuple = ()            # batch grid axes of a batched anchor

    def _with(self, **kw) -> "SegmentDecision":
        return dataclasses.replace(self, **kw)


@dataclass
class DecisionReport:
    """What ``wrapped.explain(*args)`` returns: one row per candidate
    segment (fused AND declined) and the plan's traffic accounting."""

    policy: OffloadPolicy
    decisions: list[SegmentDecision]
    naive_bytes: int
    fused_bytes: int

    @property
    def n_fused(self) -> int:
        return sum(d.fused for d in self.decisions)

    @property
    def n_declined(self) -> int:
        return sum(not d.fused for d in self.decisions)

    @property
    def traffic_reduction(self) -> float:
        return self.naive_bytes / max(self.fused_bytes, 1)

    def __str__(self) -> str:
        hdr = (f"OffloadPolicy(mode={self.policy.mode}, "
               f"bulk_threshold={self.policy.bulk_threshold}, "
               f"min_segment={self.policy.min_segment}, "
               f"machine={type(self.policy.machine).__name__}) — "
               f"{self.n_fused} fused / {self.n_declined} declined, "
               f"traffic {self.traffic_reduction:.2f}x "
               f"({self.naive_bytes / 1e6:.2f} -> "
               f"{self.fused_bytes / 1e6:.2f} MB)")
        cols = ("idx", "tier", "form", "batch", "eqns", "rows", "near_mb",
                "far_mb", "near_us", "far_us", "decision")
        rows = [cols]
        for i, d in enumerate(self.decisions):
            rows.append((str(i), d.tier, d.form or "-",
                         "x".join(map(str, d.batch)) if d.batch else "-",
                         str(d.eqns),
                         str(d.rows), f"{d.near_bytes / 1e6:.2f}",
                         f"{d.far_bytes / 1e6:.2f}", f"{d.near_us:.2f}",
                         f"{d.far_us:.2f}", "FUSE" if d.fused else "decline"))
        widths = [max(len(r[c]) for r in rows) for c in range(len(cols))]
        lines = [hdr, "  ".join(c.ljust(w) for c, w in zip(rows[0], widths))]
        for r, d in zip(rows[1:], self.decisions):
            line = "  ".join(c.ljust(w) for c, w in zip(r, widths))
            lines.append(f"{line}  {d.reason}")
            if d.roles:
                lines.append(" " * (sum(widths) + 2 * len(widths))
                             + f"operands: {', '.join(d.roles)}")
        return "\n".join(lines)
