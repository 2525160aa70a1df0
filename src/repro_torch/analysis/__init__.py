"""Static verification of offload plans (the MPU §V verifying backend).

The counterpart of ``repro.analysis``: ``verify_plan`` walks an
``OffloadPlan`` of the port and its captured graph and proves, without
running anything, alias safety, index bounds and coverage, shared-memory
and register legality on the H100, and well-formedness.  Findings are
typed; ``python -m repro_torch.analysis.lint`` sweeps every registry
model.  ``docs/torch_analysis.md`` has the rule catalog.
"""
from repro_torch.analysis.verifier import (
    REGISTERS_A_THREAD,
    SEVERITIES,
    SMEM_CAPACITY_BYTES,
    Finding,
    PlanVerificationError,
    decision_statuses,
    dropped_findings,
    has_errors,
    max_severity,
    segment_smem,
    verify_paged_decode,
    verify_plan,
)

__all__ = [
    "REGISTERS_A_THREAD",
    "SEVERITIES",
    "SMEM_CAPACITY_BYTES",
    "Finding",
    "PlanVerificationError",
    "decision_statuses",
    "dropped_findings",
    "has_errors",
    "max_severity",
    "segment_smem",
    "verify_paged_decode",
    "verify_plan",
]
