"""Rotary position embedding: the CUDA kernel's wrapper and its plain
version.

``rotary`` replaces the TPU kernel of ``repro/kernels/rotary.py``
(``_rope_kernel``): half-split RoPE on x ``[R, N, H]`` at ``positions
[R]``, sin / cos made in the kernel from ``theta``.  The kernel is
``csrc/rotary.cu`` (bound by bytes, see the note there);
``rotary_plain`` repeats the same arithmetic in plain PyTorch, for CPU
tensors and for comparison on the card.  Forward only, as the
reference (it has no VJP).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "rotary"

#: the dtypes of x the kernel takes, by the code csrc/rotary.cu knows
#: them by
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POS_DTYPES = (torch.int32, torch.int64)


def rotary_freqs(h: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i/H)`` for ``i < H/2`` in f32, each step rounded as
    the kernel rounds it."""
    return 1.0 / (theta ** (torch.arange(0, h, 2, dtype=torch.float32,
                                         device=device) / h))


def rotary_plain(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """x ``[R, N, H]``; positions ``[R]``.  f32 math, output in x's dtype."""
    h = x.shape[-1]
    ang = positions[:, None].float() * rotary_freqs(h, theta, x.device)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.rotary_launch.argtypes is None:
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rotary_launch.argtypes = [vp, vp, vp, i64, ci, ci, ci, ci,
                                      ctypes.c_float, vp]
        lib.rotary_launch.restype = ci
        lib.rotary_error.argtypes = [ci]
        lib.rotary_error.restype = ctypes.c_char_p
    return lib


def rotary(x: torch.Tensor, positions: torch.Tensor, *,
           theta: float = 10000.0) -> torch.Tensor:
    """Launch B10.  x ``[R, N, H]`` f32, bf16 or f16 (H even); positions
    ``[R]`` int32 or int64, read by the kernel as given.  Output in x's
    dtype.  Runs on PyTorch's current stream, never synchronises; raises
    on anything the kernel does not take or on a refused launch."""
    if not (x.is_cuda and positions.is_cuda):
        raise RuntimeError(
            f"rotary launches a CUDA kernel; x is on {x.device}, positions "
            f"on {positions.device} (CPU tensors go through rotary_plain)")
    if x.device != positions.device:
        raise ValueError(f"x is on {x.device}, positions on "
                         f"{positions.device}")
    if x.ndim != 3 or positions.shape != (x.shape[0],) or x.shape[2] % 2:
        raise ValueError("expected x [R, N, H] with H even and positions "
                         f"[R]; got {tuple(x.shape)}, "
                         f"{tuple(positions.shape)}")
    if x.dtype not in _DTYPES or positions.dtype not in _POS_DTYPES:
        raise TypeError("x must be float32, bfloat16 or float16 and "
                        "positions int32 or int64; got "
                        f"{x.dtype}, {positions.dtype}")
    x, pos = x.contiguous(), positions.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    r, n, h = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.rotary_launch(
            x.data_ptr(), pos.data_ptr(), out.data_ptr(), r, n, h,
            _DTYPES[x.dtype], int(pos.dtype == torch.int64),
            float(theta), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.rotary_error(code).decode()
        raise RuntimeError(f"rotary launch failed at {tuple(x.shape)}: {msg}")
    kernel_guard().count_launch(KERNEL)
    return out
