from repro_torch.ckpt.manager import StragglerMonitor

__all__ = ["StragglerMonitor"]
