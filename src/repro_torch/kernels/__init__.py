"""Hand-written GPU kernels of the port and their dispatch (``ops``),
under the reference's names: every TPU kernel of the reference has its
counterpart here.

The entry points exported here (``rmsnorm``, ``rotary``,
``decode_attention``, ``flash_attention``, ``fused_elementwise``,
``adamw_update``, ``flash_attention_bwd``, ``ssd_scan``, ``wkv6``) share
their names with submodules of this package.  Importing a submodule
binds its name here to the module; the ``from ... import`` lines below rebind it to the
function, so they must stay the last imports of this file.  Elsewhere,
reach a submodule by its full path (``from
repro_torch.kernels.rotary import rotary_plain`` or
``importlib.import_module("repro_torch.kernels.rotary")``), never as an
attribute of this package.  No module imported here loads Triton:
every Triton kernel imports it at its first launch.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_diff,
)
from repro_torch.kernels.ops import (
    adamw_update,
    decode_attention,
    flash_attention,
    fused_elementwise,
    fused_matmul_dlhs_segment,
    fused_matmul_drhs_segment,
    fused_matmul_segment,
    fused_segment,
    fused_segment_grid,
    paged_decode_attention,
    rmsnorm,
    rotary,
    ssd_scan,
    wkv6,
)

__all__ = [
    "ops",
    "ref",
    "flash_attention_bwd",
    "flash_attention_diff",
    "adamw_update",
    "decode_attention",
    "flash_attention",
    "fused_elementwise",
    "fused_matmul_dlhs_segment",
    "fused_matmul_drhs_segment",
    "fused_matmul_segment",
    "fused_segment",
    "fused_segment_grid",
    "paged_decode_attention",
    "rmsnorm",
    "rotary",
    "ssd_scan",
    "wkv6",
]
