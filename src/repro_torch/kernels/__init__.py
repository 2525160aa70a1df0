"""Hand-written GPU kernels of the port and their dispatch (``ops``)."""
from repro_torch.kernels.flash_attention_bwd import flash_attention_diff

__all__ = ["flash_attention_diff"]
