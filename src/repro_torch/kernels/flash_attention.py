"""Flash attention, forward: the CUDA kernels' wrapper (B5), its plain
version, and the tile helper the offload planner shares with them.

``flash_attention`` replaces the TPU kernel of the same name in
``repro/kernels/flash_attention.py`` (``pl.pallas_call`` at :145):
softmax(q k^T * scale) v over q ``[B, S, NQ, H]`` and k, v
``[B, T, NK, H]`` (GQA), causal and sliding-window masks, an optional
log-sum-exp ``[B, S, NQ]`` (f32).  Bound by operations at the main path's
shapes, it runs as one of two kernels by dtype:

* bf16 and f16 (head dims that are multiples of 8 up to 256): the wgmma
  / TMA kernel of ``csrc/flash_attention_sm90.cuh`` — a loading
  warpgroup feeds two computing warpgroups through an mbarrier ring,
  both products run on the tensor cores' full-rate instruction with the
  accumulators in registers, and P goes from the first product to the
  second in registers;
* f32 (head dims 16 / 32 / 64 / 128): the FMA kernel of
  ``csrc/flash_attention.cu``, so that f32 keeps full f32 precision.

``flash_attention_plain`` beside them repeats the same arithmetic as
full-matrix PyTorch for CPU tensors and for comparison on the card.

A q tile folds the G query heads of one kv head into its rows
(``tile_rows``), so it spans ``q_block(G)`` query positions; k and v
stream once per q tile.  ``Segment.io_bytes`` counts a flash segment's
k / v traffic with the same helper.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

NEG_INF = -1e30
KERNEL = "flash_attention"
#: the most query heads a q tile folds
G_MAX = 64
#: head dims of the f32 kernels: B5's; B7's are those up to 64
HEAD_DIMS_F32 = (16, 32, 64, 128)
#: 16-bit head dims: multiples of 8 from 8 to 256, each run on the
#: instantiation of the next width of ``SM90_WIDTHS`` (the columns past
#: H arrive as zeros)
HEAD_DIM_STEP, HEAD_DIM_MAX = 8, 256
SM90_WIDTHS = (64, 128, 256)
#: the C interface's dtype codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the path a launch took, as the C interface reports it
PATHS = ("fma", "sm90")


def sm90_width(head_dim: int) -> int:
    """The head-dim width the 16-bit kernels compute for ``head_dim``."""
    return next(w for w in SM90_WIDTHS if head_dim <= w)


def tile_rows(kernel: str, head_dim: int, dtype: torch.dtype
              ) -> tuple[int, int]:
    """``(q rows, kv rows)`` of one CTA's tile of ``kernel`` ("fwd",
    "dkv", "dq") for ``head_dim`` and ``dtype``, as the CUDA sources set
    them.  16-bit (``csrc/flash_attention_sm90.cuh`` /
    ``flash_attention_bwd_sm90.cuh``): two computing warpgroups of 64
    rows — fwd 128 q rows against kv tiles of 128 rows at width 64 and of
    64 wider (so that S, O and P fit 168 registers a thread), dkv 128 kv
    rows against q tiles of 64, dq 128 q rows against kv tiles of 64.
    f32 (the FMA kernels): fwd 128 q rows against 64 kv rows, dkv / dq 64
    against 64."""
    if kernel not in ("fwd", "dkv", "dq"):
        raise ValueError(f"kernel is fwd, dkv or dq, got {kernel!r}")
    if dtype == torch.float32:
        return (128, 64) if kernel == "fwd" else (64, 64)
    width = sm90_width(head_dim)
    return {"fwd": (128, 128 if width <= 64 else 64), "dkv": (64, 128),
            "dq": (128, 64)}[kernel]


def q_block(group: int, head_dim: int = 128,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Query positions of one forward q tile when it folds ``group``
    heads (``tile_rows("fwd", ...)``'s q rows over ``group``)."""
    if not 1 <= group <= G_MAX:
        raise ValueError(f"a q tile folds 1..{G_MAX} heads, got {group}")
    return tile_rows("fwd", head_dim, dtype)[0] // group


def q_blocks(s_len: int, group: int = 1, head_dim: int = 128,
             dtype: torch.dtype = torch.bfloat16) -> int:
    """Forward q tiles over ``s_len`` positions: how often k and v
    stream."""
    return -(-s_len // q_block(group, head_dim, dtype))


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
                       ci, ctypes.c_float, ctypes.POINTER(ci), vp]
        fn.restype = ci
        lib.flash_attention_error.argtypes = [ci]
        lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def refusal(head_dim: int, dtype: torch.dtype, group: int = 1) -> str | None:
    """Why B5 (and B7) refuse operands of this head dim, dtype and GQA
    group (G query heads per kv head), or None when they take them: bf16
    or f16 with H a multiple of 8 from 8 to 256, f32 with H in
    ``HEAD_DIMS_F32``, and G at most ``G_MAX``.  (B7 besides takes f32
    only up to H = 64.)  ``check_operands`` raises with this reason; the
    offload planner declines a flash pair with it."""
    if dtype not in DTYPE_CODES:
        return f"dtype {dtype} is not float32, bfloat16 or float16"
    if dtype == torch.float32:
        if head_dim not in HEAD_DIMS_F32:
            return (f"head_dim {head_dim} is not one of {HEAD_DIMS_F32} "
                    "(float32)")
    elif head_dim % HEAD_DIM_STEP or not 0 < head_dim <= HEAD_DIM_MAX:
        return (f"head_dim {head_dim} is not a multiple of {HEAD_DIM_STEP} "
                f"from {HEAD_DIM_STEP} to {HEAD_DIM_MAX} ({dtype})")
    if not 1 <= group <= G_MAX:
        return f"G={group} query heads per kv head is not in 1..{G_MAX}"
    return None


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *more: torch.Tensor) -> None:
    """What the flash kernels take: q (and ``more``, shaped as q) ``[B, S,
    NQ, H]``, k / v ``[B, T, NK, H]``, one dtype, one device, contiguous
    and 16-byte aligned, what ``refusal`` allows, and NQ = G * NK.
    Raises otherwise."""
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
            raise TypeError(f"{name} is {t.dtype}: q, k, v share one dtype "
                            f"(q is {q.dtype})")
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
    on a refused launch: there is no fallback to the plain version.
    Counts the launch, and the path it took (``kernel_guard().variants``:
    "sm90" or "fma")."""
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
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, t, nq, nk, h,
            DTYPE_CODES[q.dtype], int(causal), int(window),
            default_scale(h) if scale is None else float(scale),
            ctypes.byref(path), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error(code).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg}")
    kernel_guard().count_launch(KERNEL)
    kernel_guard().count_variant(KERNEL, KERNEL, PATHS[path.value])
    return (out, lse) if return_lse else out
