"""The offload compiler of the port: Algorithm 1 over fx graphs, the
§IV-B1 policy, and the forward planner + runner (``mpu_offload``)."""
from repro_torch.core.isa import Loc
from repro_torch.core.locator import GraphAnnotation, annotate_graph
from repro_torch.core.machine import H100, H100_SXM
from repro_torch.core.offload import (
    MatmulAnchor,
    OffloadPlan,
    OffloadStats,
    OperandSpec,
    Segment,
    capture,
    mpu_offload,
    offload_report,
    plan_offload,
)
from repro_torch.core.policy import (
    DEFAULT_POLICY,
    PLANNER_MODES,
    DecisionReport,
    OffloadPolicy,
    SegmentDecision,
    current_policy,
    offload_policy,
    resolve_policy,
)

__all__ = [
    "Loc", "GraphAnnotation", "annotate_graph", "H100", "H100_SXM",
    "MatmulAnchor", "OffloadPlan", "OffloadStats", "OperandSpec", "Segment",
    "capture", "mpu_offload", "offload_report",
    "plan_offload", "DEFAULT_POLICY", "PLANNER_MODES", "DecisionReport",
    "OffloadPolicy", "SegmentDecision", "current_policy", "offload_policy",
    "resolve_policy",
]
