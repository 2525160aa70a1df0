from repro_torch.ckpt.checkpoint import (
    CheckpointCorrupt,
    all_steps,
    latest_step,
    newest_restorable,
    restore,
    save,
    verify_step,
)
from repro_torch.ckpt.manager import (
    CheckpointManager,
    StragglerMonitor,
    elastic_data_axis,
)

__all__ = [
    "CheckpointCorrupt", "all_steps", "latest_step", "newest_restorable",
    "restore", "save", "verify_step",
    "CheckpointManager", "StragglerMonitor", "elastic_data_axis",
]
