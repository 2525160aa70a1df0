"""The plain versions of the ported kernels under the names of the
reference's oracles (``repro/kernels/ref.py``).

Each is the plain PyTorch version that lives beside its kernel and
follows the kernel's arithmetic; where that differs from the JAX oracle
it says so (a decode row of length 0 gives zeros here, the mean of V
there).  ``ref_ssd_scan`` and ``ref_wkv6`` return ``(y, state)`` as the
reference's sequential oracles do, from the chunked form of the kernels
(the same values up to rounding; ``ref_wkv6`` stays finite at any decay).
"""
from repro_torch.kernels.decode_attention import (
    decode_attention_plain as ref_decode_attention,
    paged_decode_attention_plain as ref_paged_decode_attention,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_plain as ref_flash_attention,
)
from repro_torch.kernels.rmsnorm import rmsnorm_plain as ref_rmsnorm
from repro_torch.kernels.rotary import rotary_plain as ref_rotary
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ref_ssd_scan
from repro_torch.kernels.wkv6 import wkv6_plain as ref_wkv6

__all__ = ["ref_decode_attention", "ref_flash_attention",
           "ref_paged_decode_attention", "ref_rmsnorm", "ref_rotary",
           "ref_ssd_scan", "ref_wkv6"]
