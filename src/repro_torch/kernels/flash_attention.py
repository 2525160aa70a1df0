"""Flash attention, forward: the CUDA kernel's wrapper (B5), its plain
version, and the q-tile helper the offload planner shares with it.

``flash_attention`` replaces the TPU kernel of the same name in
``repro/kernels/flash_attention.py`` (``pl.pallas_call`` at :145):
softmax(q k^T * scale) v over q ``[B, S, NQ, H]`` and k, v
``[B, T, NK, H]`` (GQA), causal and sliding-window masks, an optional
log-sum-exp ``[B, S, NQ]`` (f32).  The kernel is
``csrc/flash_attention.cu`` (bound by operations at the main path's
shapes, see the note there); ``flash_attention_plain`` beside it repeats
the same arithmetic as full-matrix PyTorch for CPU tensors and for
comparison on the card.

A q tile folds the G query heads of one kv head into ``Q_ROWS`` rows, so
it spans ``q_block(G)`` query positions; k and v stream once per q tile.
``Segment.io_bytes`` counts a flash segment's k / v traffic with the same
helper.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

NEG_INF = -1e30
KERNEL = "flash_attention"
#: rows of the forward kernel's q tile (G heads x q_block(G) positions)
#: and the most query heads a q tile folds
Q_ROWS = 128
G_MAX = 64
HEAD_DIMS = (16, 32, 64, 128)

_DTYPES = (torch.float32, torch.bfloat16)


def q_block(group: int) -> int:
    """Query positions of one q tile when it folds ``group`` heads."""
    if not 1 <= group <= G_MAX:
        raise ValueError(f"a q tile folds 1..{G_MAX} heads, got {group}")
    return Q_ROWS // group


def q_blocks(s_len: int, group: int = 1) -> int:
    """q tiles over ``s_len`` positions: how often k and v stream."""
    return -(-s_len // q_block(group))


def default_scale(h: int) -> float:
    return 1.0 / math.sqrt(h)


def allowed_keys(s_len: int, t_len: int, *, causal: bool, window: int,
                 device) -> torch.Tensor:
    """``[S, T]`` bool: which key positions each query position sees."""
    q_pos = torch.arange(s_len, device=device)[:, None]
    k_pos = torch.arange(t_len, device=device)[None, :]
    ok = torch.ones((s_len, t_len), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: float | None = None,
                          return_lse: bool = False):
    """Plain PyTorch version of the kernel: the whole ``[S, T]`` score
    matrix in f32, masked keys dropped outright (``p = 0``), ``l``
    clamped at 1e-37 (a row that sees no key gives zeros), output in
    ``q``'s dtype, ``lse = m + log l`` in f32."""
    b, s, nq, h = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = nq // nk
    sc = default_scale(h) if scale is None else scale
    qg = q.float().reshape(b, s, nk, g, h)
    scores = torch.einsum("bskgh,btkh->bskgt", qg, k.float()) * sc
    ok = allowed_keys(s, t, causal=causal, window=window,
                      device=q.device)[None, :, None, None, :]
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(scores - m), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    out = torch.einsum("bskgt,btkh->bskgh", p, v.float()) / l
    out = out.reshape(b, s, nq, h).to(q.dtype).contiguous()
    if return_lse:
        return out, (m + torch.log(l)).reshape(b, s, nq).contiguous()
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       ci, ctypes.c_float, vp]
        fn.restype = ci
        lib.flash_attention_error.argtypes = [ci]
        lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def refusal(head_dim: int, dtype: torch.dtype, group: int = 1) -> str | None:
    """Why B5 refuses operands of this head dim, dtype and GQA group (G
    query heads per kv head), or None when it takes them: H in
    ``HEAD_DIMS``, f32 or bf16, G at most ``G_MAX``.  ``check_operands``
    raises with this reason; the offload planner declines a flash pair
    with it."""
    if head_dim not in HEAD_DIMS:
        return f"head_dim {head_dim} is not one of {HEAD_DIMS}"
    if dtype not in _DTYPES:
        return f"dtype {dtype} is not float32 or bfloat16"
    if not 1 <= group <= G_MAX:
        return f"G={group} query heads per kv head is not in 1..{G_MAX}"
    return None


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *more: torch.Tensor) -> None:
    """What the flash kernels take: q (and ``more``, shaped as q) ``[B, S,
    NQ, H]``, k / v ``[B, T, NK, H]``, one dtype (f32 or bf16), one
    device, contiguous and 16-byte aligned, H in ``HEAD_DIMS`` and
    NQ = G * NK with G at most ``G_MAX``.  Raises otherwise."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("expected q [B,S,NQ,H] and k, v [B,T,NK,H]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, nq, h = q.shape
    if k.shape[0] != b or k.shape[3] != h:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    nk = k.shape[2]
    if nq % nk:
        raise ValueError(f"NQ={nq} must be G * NK={nk} with G <= {G_MAX}")
    why = refusal(h, q.dtype, nq // nk)
    if why is not None:
        raise (TypeError if why.startswith("dtype") else ValueError)(why)
    for name, t in (("q", q), ("k", k), ("v", v),
                    *((f"operand {i}", t) for i, t in enumerate(more))):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}: q, k, v share float32 "
                            f"or bfloat16 (q is {q.dtype})")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for i, t in enumerate(more):
        if t.shape != q.shape:
            raise ValueError(f"operand {i} {tuple(t.shape)} is not shaped "
                             f"as q {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, return_lse: bool = False):
    """Launch B5 on CUDA tensors.  Returns ``out`` (``[B, S, NQ, H]`` in
    q's dtype) or ``(out, lse)``.  Runs on PyTorch's current stream,
    never synchronises, raises on anything the kernel does not take or
    on a refused launch: there is no fallback to the plain version."""
    if not q.is_cuda:
        raise RuntimeError(
            f"flash_attention launches a CUDA kernel; q is on {q.device} "
            "(CPU tensors go through flash_attention_plain)")
    check_operands(q, k, v)
    b, s, nq, h = q.shape
    t, nk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, s, nq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, t, nq, nk, h,
            int(q.dtype == torch.bfloat16), int(causal), int(window),
            default_scale(h) if scale is None else float(scale),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error(code).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg}")
    kernel_guard().count_launch(KERNEL)
    return (out, lse) if return_lse else out
