from repro_torch.serve.engine import Completion, Engine, Request
from repro_torch.serve.faults import (
    FaultConfig,
    FaultInjected,
    FaultInjector,
    inject,
)
from repro_torch.serve.kv_pool import PagePool, bucket_length, ceil_pow2

__all__ = ["Completion", "Engine", "FaultConfig", "FaultInjected",
           "FaultInjector", "PagePool", "Request", "bucket_length",
           "ceil_pow2", "inject"]
