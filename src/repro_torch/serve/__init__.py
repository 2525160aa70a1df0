from repro_torch.serve.engine import (
    Completion,
    Engine,
    FixedSlotEngine,
    Request,
)
from repro_torch.serve.faults import (
    FaultConfig,
    FaultInjected,
    FaultInjector,
    inject,
)
from repro_torch.serve.kv_pool import PagePool, bucket_length, ceil_pow2

__all__ = ["Completion", "Engine", "FaultConfig", "FaultInjected",
           "FaultInjector", "FixedSlotEngine", "PagePool", "Request",
           "bucket_length", "ceil_pow2", "inject"]
