"""Flash attention, backward: the CUDA kernels' wrappers (B7), their
plain version, and ``flash_attention_diff`` (B5 forward with the
log-sum-exp, B7 backward) as a ``torch.autograd.Function``.

``flash_attention_bwd`` replaces the two TPU kernels of
``repro/kernels/flash_attention_bwd.py`` — ``_dkv_kernel``
(``pl.pallas_call`` at :196) and ``_dq_kernel`` (:218): both recompute
``P = exp(q k^T * scale - lse)`` from the forward's log-sum-exp, ``dkv``
accumulates ``dV = P^T dO`` and ``dK = dS^T q`` over the q tiles of all
G heads of a kv head, ``dq`` accumulates ``dQ = dS k`` over the kv
tiles, with ``dS = P * (dO v^T - D) * scale``.  ``D = rowsum(dO * o)``
is computed here, outside the kernels, as the reference does (:172).
Bound by operations, they run as one of two pairs of kernels by dtype:
bf16 / f16 on the wgmma / TMA kernels of
``csrc/flash_attention_bwd_sm90.cuh`` (every product on the tensor cores
with its accumulator in registers, dK and dV included, P and dS fed to
the next products from registers), f32 on the FMA kernels of
``csrc/flash_attention_bwd.cu`` (head dims up to 64).  No atomics: two
launches are bit-equal.  ``flash_attention_bwd_plain`` repeats the same
arithmetic as full-matrix PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    DTYPE_CODES,
    PATHS,
    allowed_keys,
    check_operands,
    default_scale,
    flash_attention as _flash_cuda,
    flash_attention_plain,
    refusal,
)
from repro_torch.kernels.guard import kernel_guard, resolve_impl

SOURCE = "flash_attention_bwd"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_DQ = "flash_attention_bwd_dq"


def row_dot(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * o)`` in f32, ``[B, S, NQ]``."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, scale: float | None = None):
    """Plain PyTorch version of the two kernels: ``(dq, dk, dv)`` from the
    whole ``[S, T]`` probability matrix in f32, rebuilt from ``lse`` (0
    where the mask hides a key), each gradient in its operand's dtype."""
    b, s, nq, h = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = nq // nk
    sc = default_scale(h) if scale is None else scale
    qg = q.float().reshape(b, s, nk, g, h)
    dog = do.float().reshape(b, s, nk, g, h)
    kf, vf = k.float(), v.float()
    ok = allowed_keys(s, t, causal=causal, window=window,
                      device=q.device)[None, :, None, None, :]
    scores = torch.einsum("bskgh,btkh->bskgt", qg, kf) * sc
    p = torch.where(ok, torch.exp(scores - lse.float().reshape(
        b, s, nk, g, 1)), 0.0)
    dp = torch.einsum("bskgh,btkh->bskgt", dog, vf)
    ds = p * (dp - row_dot(do, o).reshape(b, s, nk, g, 1)) * sc
    dv = torch.einsum("bskgt,bskgh->btkh", p, dog)
    dk = torch.einsum("bskgt,bskgh->btkh", ds, qg)
    dq = torch.einsum("bskgt,btkh->bskgh", ds, kf).reshape(b, s, nq, h)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.flash_attention_bwd_dq_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        tail = [ci] * 9 + [ctypes.c_float, ctypes.POINTER(ci), vp]
        lib.flash_attention_bwd_dkv_launch.argtypes = [vp] * 8 + tail
        lib.flash_attention_bwd_dq_launch.argtypes = [vp] * 7 + tail
        lib.flash_attention_bwd_dkv_launch.restype = ci
        lib.flash_attention_bwd_dq_launch.restype = ci
        lib.flash_attention_bwd_error.argtypes = [ci]
        lib.flash_attention_bwd_error.restype = ctypes.c_char_p
    return lib


def bwd_refusal(head_dim: int, dtype: torch.dtype,
                group: int = 1) -> str | None:
    """Why B7 refuses operands of this head dim, dtype and GQA group, or
    None when it takes them: what B5 refuses (``refusal``), and f32 with
    head_dim above 64 (the FMA kernels' f32 tiles of 128 do not fit a
    block's shared memory)."""
    why = refusal(head_dim, dtype, group)
    if why is None and dtype == torch.float32 and head_dim > 64:
        why = f"flash_attention_bwd takes f32 head_dim <= 64, got {head_dim}"
    return why


def _check_bwd(q, k, v, do, lse, dvec) -> None:
    if not q.is_cuda:
        raise RuntimeError(
            f"flash_attention_bwd launches CUDA kernels; q is on {q.device} "
            "(CPU tensors go through flash_attention_bwd_plain)")
    check_operands(q, k, v, do)
    b, s, nq, h = q.shape
    for name, t in (("lse", lse), ("D", dvec)):
        if t.shape != (b, s, nq) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous f32 [B,S,NQ] "
                             f"tensor on {q.device}; got {tuple(t.shape)} "
                             f"{t.dtype}")
    why = bwd_refusal(h, q.dtype, nq // k.shape[2])
    if why is not None:
        raise ValueError(why)


def _launch(name: str, q, k, v, do, lse, dvec, outs, causal, window,
            scale) -> None:
    _check_bwd(q, k, v, do, lse, dvec)
    b, s, nq, h = q.shape
    t, nk = k.shape[1], k.shape[2]
    lib = _lib()
    fn = lib.flash_attention_bwd_dkv_launch if name == KERNEL_DKV else \
        lib.flash_attention_bwd_dq_launch
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), dvec.data_ptr(),
                  *(x.data_ptr() for x in outs), b, s, t, nq, nk, h,
                  DTYPE_CODES[q.dtype], int(causal), int(window),
                  default_scale(h) if scale is None else float(scale),
                  ctypes.byref(path), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.flash_attention_bwd_error(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
    kernel_guard().count_launch(name)
    kernel_guard().count_variant(name, name, PATHS[path.value])


def flash_attention_bwd_dkv(q, k, v, do, lse, dvec, *, causal: bool = True,
                            window: int = 0, scale: float | None = None):
    """Launch B7's ``dkv`` kernel on CUDA tensors: ``(dk, dv)``.  ``dvec``
    is ``D = rowsum(dO * o)`` (``row_dot``)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(KERNEL_DKV, q, k, v, do, lse, dvec, (dk, dv), causal, window,
            scale)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, dvec, *, causal: bool = True,
                           window: int = 0, scale: float | None = None):
    """Launch B7's ``dq`` kernel on CUDA tensors: ``dq``."""
    dq = torch.empty_like(q)
    _launch(KERNEL_DQ, q, k, v, do, lse, dvec, (dq,), causal, window, scale)
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """Launch B7 on CUDA tensors: ``D = rowsum(dO * o)``, then ``dkv``
    and ``dq`` (each counts as one launch of its kernel, and the path it
    took).  ``lse`` is the forward's ``[B, S, NQ]`` f32 log-sum-exp.
    Raises on anything the kernels do not take — what B5 refuses
    (``flash_attention.refusal``), and f32 with head_dim above 64 — or on
    a refused launch.  Returns ``(dq, dk, dv)``."""
    check_operands(q, k, v, o)
    dvec = row_dot(do, o)
    kw = dict(causal=causal, window=window, scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    return flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw), dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """B5 forward (with the log-sum-exp), B7 backward; the plain versions
    for CPU tensors (``impl`` resolved as ``ops`` resolves it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, impl):
        if resolve_impl(impl, q) == "ref":
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        else:
            o, lse = _flash_cuda(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window)
        if resolve_impl(ctx.impl, q) == "ref":
            grads = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        else:
            grads = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                        **kw)
        return (*grads, None, None, None)


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0, *,
                         impl: str = "auto") -> torch.Tensor:
    """Differentiable flash attention (``scale = 1/sqrt(H)``, as the
    reference's).  The reference's ``q_block`` / ``kv_block`` /
    ``interpret`` arguments shape TPU blocks only and are not carried
    over.  On CUDA tensors it takes what B5 takes (``ops.flash_attention``)
    and its backward B7 besides refuses f32 with head_dim above 64 (the
    f32 FMA kernels' tiles of 128 do not fit 227 KB of shared memory):
    such inputs raise ``ValueError``, where the reference's Pallas kernels
    take them."""
    return _FlashAttentionFn.apply(q, k, v, causal, window, impl)
