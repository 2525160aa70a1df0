"""RMSNorm: the CUDA kernels' wrappers, their plain versions and the
autograd pairing.

``rmsnorm`` / ``rmsnorm_bwd`` replace the TPU kernels of
``repro/kernels/rmsnorm.py`` (``_fwd_kernel`` via ``_call_fwd`` and
``_bwd_kernel`` via ``_rmsnorm_bwd``); the kernels are
``csrc/rmsnorm.cu`` (bound by bytes, see the note there).
``RMSNormFn`` pairs them as the reference's ``custom_vjp`` does: the
forward saves ``(x, scale)`` and the backward recomputes the row
statistic.  ``rmsnorm_plain`` / ``rmsnorm_bwd_plain`` repeat the same
arithmetic in plain PyTorch, for CPU tensors and for comparison on the
card; the backward's plain version is the explicit formula, not autograd
of the plain forward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard, resolve_impl

KERNEL = "rmsnorm"
KERNEL_BWD = "rmsnorm_bwd"

_DTYPES = (torch.float32, torch.bfloat16)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, ds)``: ``dx = inv * (g*s - xhat * mean(g*s * xhat))`` in x's
    dtype and ``ds = sum_rows(g * xhat)`` summed in f32, in scale's dtype."""
    x2, g2 = _rows(x).float(), _rows(g).float()
    s = scale.float()
    var = (x2 * x2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = x2 * inv
    gs = g2 * s
    dot = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (gs - xhat * dot)).to(x.dtype).reshape(x.shape)
    ds = (g2 * xhat).sum(dim=0).to(scale.dtype)
    return dx, ds


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.rmsnorm_fwd_launch.argtypes is None:
        vp, ci, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_float)
        lib.rmsnorm_fwd_launch.argtypes = [vp, vp, vp, i64, ci, ci, ci, f, vp]
        lib.rmsnorm_fwd_launch.restype = ci
        lib.rmsnorm_bwd_launch.argtypes = [vp, vp, vp, vp, vp, vp, i64, ci,
                                           ci, ci, ci, f, vp]
        lib.rmsnorm_bwd_launch.restype = ci
        lib.rmsnorm_error.argtypes = [ci]
        lib.rmsnorm_error.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor, name: str) -> None:
    if not (x.is_cuda and scale.is_cuda):
        raise RuntimeError(
            f"{name} launches a CUDA kernel; x is on {x.device}, scale on "
            f"{scale.device} (CPU tensors go through {name}_plain)")
    if x.device != scale.device:
        raise ValueError(f"x is on {x.device}, scale on {scale.device}")
    if x.ndim < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"expected x [..., D] and scale [D]; got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError("x and scale must be float32 or bfloat16; got "
                        f"{x.dtype}, {scale.dtype}")


def _raise(lib: ctypes.CDLL, code: int, name: str, shape) -> None:
    if code != 0:
        msg = lib.rmsnorm_error(code).decode()
        raise RuntimeError(f"{name} launch failed at {tuple(shape)}: {msg}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Launch the B9 forward.  x ``[..., D]`` (any leading dims, any row
    count, any D; rows too wide for registers take the wide kernel),
    scale ``[D]``; f32 or bf16 each, f32 math, output in x's dtype.  Runs on PyTorch's current stream, never synchronises; raises
    on anything the kernel does not take or on a refused launch."""
    _check(x, scale, KERNEL)
    x2, s = _rows(x).contiguous(), scale.contiguous()
    y = torch.empty_like(x2)
    if x2.numel() == 0:
        return y.reshape(x.shape)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.rmsnorm_fwd_launch(
            x2.data_ptr(), s.data_ptr(), y.data_ptr(), x2.shape[0],
            x2.shape[1], int(x.dtype == torch.bfloat16),
            int(s.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream().cuda_stream)
    _raise(lib, code, KERNEL, x.shape)
    kernel_guard().count_launch(KERNEL)
    return y.reshape(x.shape)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the B9 backward: ``(dx, ds)`` for the cotangent ``g`` of
    ``rmsnorm(x, scale)``; dx in x's dtype, ds in scale's.  One launch of
    the row kernel (about one block an SM, each writing an f32 partial
    ``[D]``) and one of the fixed-order sum of the partials; counted as
    one launch of B9-bwd.  Any D, as the forward."""
    _check(x, scale, KERNEL_BWD)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("g must have x's shape, dtype and device; got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    x2, g2, s = _rows(x).contiguous(), _rows(g).contiguous(), \
        scale.contiguous()
    dx = torch.empty_like(x2)
    ds = torch.empty_like(s)
    if x2.numel() == 0:
        return dx.reshape(x.shape), ds.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # scratch for the per-block partials; PyTorch's allocator hands its
    # memory on only to later work on this stream, so dropping it is safe
    part = torch.empty((sms, x2.shape[1]), dtype=torch.float32,
                       device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.rmsnorm_bwd_launch(
            x2.data_ptr(), s.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            ds.data_ptr(), part.data_ptr(), x2.shape[0], x2.shape[1],
            int(x.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
            sms, eps, torch.cuda.current_stream().cuda_stream)
    _raise(lib, code, KERNEL_BWD, x.shape)
    kernel_guard().count_launch(KERNEL_BWD)
    return dx.reshape(x.shape), ds


class RMSNormFn(torch.autograd.Function):
    """B9 forward, B9 backward; the plain versions for CPU tensors
    (``impl`` resolved as ``ops`` resolves it).  The forward saves
    ``(x, scale)``, as the reference's VJP saves ``(x2, scale)``."""

    @staticmethod
    def forward(ctx, x, scale, eps, impl):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.impl = eps, impl
        if resolve_impl(impl, x) == "ref":
            return rmsnorm_plain(x, scale, eps)
        return rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        if resolve_impl(ctx.impl, x) == "ref":
            dx, ds = rmsnorm_bwd_plain(x, scale, g, ctx.eps)
        else:
            dx, ds = rmsnorm_bwd(x, scale, g, eps=ctx.eps)
        return dx, ds, None, None
