"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper (B12) and its plain
version.

``ssd_scan`` replaces the TPU kernel of ``repro/kernels/ssd_scan.py``
(``_ssd_kernel``, ``pl.pallas_call`` at :91): x ``[B, S, H, P]``, logd
(= dt * a, at most 0) and dt ``[B, S, H]``, B and C ``[B, S, N]`` shared
by all heads; y ``[B, S, H, P]`` in x's dtype, the ``[P, N]`` state of
each head carried across chunks in f32 and not returned.  The kernel is
``csrc/ssd_scan.cu`` (bound by operations, see the note there); its
chunk length is its own (``CHUNK``), taken from no caller.
``ssd_scan_plain`` beside it computes the same chunked form in plain
PyTorch, for CPU tensors and for comparison on the card; it also
returns the final state, as the reference's oracle ``ref_ssd_scan`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "ssd_scan"
#: the kernel's chunk length (``Q`` in csrc/ssd_scan.cu)
CHUNK = 64

_DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan_plain(x: torch.Tensor, logd: torch.Tensor, dt: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor, *,
                   chunk: int = CHUNK,
                   state0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan in f32 over chunks of ``chunk`` positions.
    Returns ``(y [B, S, H, P] in x's dtype, state [B, H, P, N] f32)``.
    The chunk changes the result only by rounding."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    xf, ld, dtf = x.float(), logd.float(), dt.float()
    bf, cf = bmat.float(), cmat.float()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        q = sl.stop - s0
        csum = torch.cumsum(ld[:, sl], dim=1).transpose(1, 2)   # [B, H, Q]
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        diff = csum[..., :, None] - csum[..., None, :]
        decay = torch.exp(torch.where(tri, diff, -torch.inf))    # [B,H,Q,Q]
        scores = torch.einsum("bin,bjn->bij", cf[:, sl], bf[:, sl])
        xw = xf[:, sl] * dtf[:, sl, :, None]                     # [B,Q,H,P]
        y_intra = torch.einsum("bhij,bjhp->bihp",
                               scores[:, None] * decay, xw)
        y_inter = torch.einsum("bin,bhpn->bihp", cf[:, sl], state) * \
            torch.exp(csum).transpose(1, 2)[..., None]
        y[:, sl] = (y_intra + y_inter).to(x.dtype)
        end = csum[..., -1:]                                     # [B, H, 1]
        dback = torch.exp(end - csum).transpose(1, 2)[..., None]  # [B,Q,H,1]
        state = state * torch.exp(end)[..., None] + torch.einsum(
            "bjhp,bjn->bhpn", xw * dback, bf[:, sl])
    return y, state


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.ssd_scan_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.ssd_scan_launch.restype = ci
        lib.ssd_scan_error.argtypes = [ci]
        lib.ssd_scan_error.restype = ctypes.c_char_p
    return lib


def ssd_scan(x: torch.Tensor, logd: torch.Tensor, dt: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """Launch B12.  x ``[B, S, H, P]`` f32 or bf16; logd, dt ``[B, S, H]``
    and bmat, cmat ``[B, S, N]``, taken as f32 (cast if given otherwise).
    Returns y in x's dtype.  Runs on PyTorch's current stream, never
    synchronises; raises on anything the kernel does not take or on a
    refused launch: there is no fallback to the plain version."""
    args = (x, logd, dt, bmat, cmat)
    if not all(t.is_cuda for t in args):
        raise RuntimeError(
            "ssd_scan launches a CUDA kernel; its operands are on "
            f"{[str(t.device) for t in args]} (CPU tensors go through "
            "ssd_scan_plain)")
    if any(t.device != x.device for t in args):
        raise ValueError("ssd_scan's operands are on different devices")
    if x.ndim != 4:
        raise ValueError(f"expected x [B, S, H, P], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1] if bmat.ndim == 3 else -1
    if logd.shape != (b, s, h) or dt.shape != (b, s, h) or \
            bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(
            f"expected logd, dt [{b}, {s}, {h}] and bmat, cmat [{b}, {s}, N]; "
            f"got {tuple(logd.shape)}, {tuple(dt.shape)}, "
            f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    logd, dt, bmat, cmat = (t.float().contiguous()
                            for t in (logd, dt, bmat, cmat))
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ssd_scan_launch(
            x.data_ptr(), logd.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), b, s, h, p, n,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.ssd_scan_error(code).decode()
        raise RuntimeError(f"ssd_scan launch failed at x {tuple(x.shape)}, "
                           f"N={n}: {msg}")
    kernel_guard().count_launch(KERNEL)
    return y
