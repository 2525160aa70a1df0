"""Decode attention: the CUDA kernels' wrappers and their plain versions.

``paged_decode_attention`` replaces the TPU kernel of the same name in
``repro/kernels/decode_attention.py`` (``_paged_decode_kernel``): one
query token per sequence attends over K/V held in a global page pool
``[P, NK, page, H]`` through a block table ``[B, NP]``.
``decode_attention`` replaces ``_decode_kernel`` there: the same over a
dense cache, token-major ``[B, T, NK, H]`` or head-major ``[B, NK, T,
H]``, read in place through its strides.  The kernels are
``csrc/paged_decode_attention.cu`` and ``csrc/decode_attention.cu``, one
core shared through ``csrc/decode_common.cuh`` (bound by bytes, see the
notes there); ``paged_decode_attention_plain`` and
``decode_attention_plain`` beside them repeat the same arithmetic in
plain PyTorch for CPU tensors and for comparison on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

NEG_INF = -1e30
KERNEL = "paged_decode_attention"
KERNEL_DENSE = "decode_attention"
#: the dense kernel cuts a sequence's live tokens into splits of whole
#: 64-token chunks: B1's page size on the engine's path, so a dense copy
#: of a paged cache is reduced in B1's order
DENSE_CHUNK = 64

#: the dtypes the kernels take, by the code they are passed as
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           head_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel: q ``[B, NQ, H]``, caches
    ``[B, T, NK, H]`` (``head_major``: ``[B, NK, T, H]``), masked softmax
    in f32, output in ``q``'s dtype.

    Follows the kernels' arithmetic, not the JAX oracle's: probabilities
    stay f32 for the PV product, and a row with ``lengths == 0`` gives
    zeros (``l`` clamped at 1e-37), as inactive slots do in the engine.
    """
    if not head_major:
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    b, nq, h = q.shape
    nk, t = k_cache.shape[1], k_cache.shape[2]
    g = nq // nk
    kc, vc = k_cache.float(), v_cache.float()
    qg = q.reshape(b, nk, g, h).float()
    s = torch.matmul(qg, kc.transpose(-1, -2)) * (1.0 / (h ** 0.5))
    k_pos = torch.arange(t, device=q.device)
    ok = k_pos[None, :] < lengths[:, None]            # [B, T]
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    # masked keys are dropped outright so an all-masked row sums to l = 0
    p = torch.where(ok[:, None, None, :], torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vc) / torch.clamp(l, min=1e-37)
    return out.reshape(b, nq, h).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel: gather each sequence's
    pages through its table into a head-major cache, then
    ``decode_attention_plain``."""
    b, h = q.shape[0], q.shape[2]
    nk, page = k_pages.shape[1], k_pages.shape[2]
    n_pages = block_tables.shape[1]
    tables = block_tables.long()
    # [B, NP, NK, page, H] -> head-major [B, NK, T, H]
    kc = k_pages[tables].permute(0, 2, 1, 3, 4).reshape(
        b, nk, n_pages * page, h)
    vc = v_pages[tables].permute(0, 2, 1, 3, 4).reshape(
        b, nk, n_pages * page, h)
    return decode_attention_plain(q, kc, vc, lengths, head_major=True)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci,
                       i64, i64, i64, ctypes.c_float, vp]
        fn.restype = ci
        lib.paged_decode_attention_error.argtypes = [ci]
        lib.paged_decode_attention_error.restype = ctypes.c_char_p
    return lib


def default_num_splits(b: int, nq: int, nk: int, n_pages: int,
                       sms: int) -> int:
    """How many runs the live pages are cut into: enough (b, kv head,
    split) blocks to fill the card (two resident blocks of 256 threads
    on each of its ``sms`` SMs), never more than there are pages (the
    dense kernel passes its chunks).  Decided from shapes alone so the
    launch needs no host sync."""
    g = nq // nk
    tile = next(t for t in (8, 4, 2, 1) if g % t == 0)
    blocks = b * nk * (g // tile)
    return max(1, min(n_pages, 2 * sms // max(blocks, 1)))


def _check_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              what: str) -> None:
    """What both kernels need of q and the K / V they read in place:
    one dtype (f32, bf16 or f16) and device, a row of H elements a
    power-of-two number (at most 32) of 16-byte vectors, H contiguous,
    rows 16-byte aligned, one set of strides for K and V."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q and {what} must share dtype float32, bfloat16 "
                        f"or float16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in ((f"k_{what}", k), (f"v_{what}", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    h = q.shape[-1]
    vec = 16 // q.element_size()
    lanes = h // vec
    if h % vec or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(
            f"head_dim {h} ({q.dtype}): a row must be a power-of-two "
            f"number (at most 32) of 16-byte vectors")
    if k.stride(3) != 1 or any(s % vec for s in k.stride()[:3]):
        raise ValueError(f"{what}: head_dim must be contiguous and rows "
                         "16-byte aligned")
    if v.stride() != k.stride():
        raise ValueError(f"k_{what} and v_{what} must share strides")
    for name, t in (("q", q), (f"k_{what}", k), (f"v_{what}", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _check(q, k_pages, v_pages, block_tables, lengths) -> None:
    if q.ndim != 3 or k_pages.ndim != 4 or block_tables.ndim != 2 \
            or lengths.ndim != 1:
        raise ValueError(
            "expected q [B,NQ,H], pages [P,NK,page,H], block_tables "
            f"[B,NP], lengths [B]; got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(block_tables.shape)}, "
            f"{tuple(lengths.shape)}")
    b, nq, h = q.shape
    nk = k_pages.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != h:
        raise ValueError("k_pages / v_pages / q head_dim disagree: "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}, "
                         f"H={h}")
    if nq % nk != 0:
        raise ValueError(f"NQ={nq} is not a multiple of NK={nk}")
    if block_tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError("block_tables / lengths batch differs from q's")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32; got "
                        f"{block_tables.dtype}, {lengths.dtype}")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("block_tables", block_tables),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_kv(q, k_pages, v_pages, "pages")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           num_splits: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q ``[B,NQ,H]``; pages ``[P,NK,page,H]``;
    ``block_tables [B,NP]`` int32; ``lengths [B]`` int32 (each at most
    ``NP * page``).  f32, bf16 or f16 in, f32 math, output in q's
    dtype.

    Runs on PyTorch's current stream, never synchronises, and raises on
    anything the kernel does not take or on a refused launch: there is
    no fallback to the plain version."""
    if not q.is_cuda:
        raise RuntimeError(
            f"paged_decode_attention launches a CUDA kernel; q is on "
            f"{q.device} (CPU tensors go through "
            "paged_decode_attention_plain)")
    _check(q, k_pages, v_pages, block_tables, lengths)
    b, nq, h = q.shape
    nk, page = k_pages.shape[1], k_pages.shape[2]
    n_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    if num_splits is None:
        num_splits = default_num_splits(
            b, nq, nk, n_pages,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    # scratch for the split partials; PyTorch's allocator hands its memory
    # on only to later work on this stream, so dropping it on return is safe
    part = None
    if num_splits > 1:
        part = torch.empty((b, nq, num_splits, h + 2), dtype=torch.float32,
                           device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            b, nq, nk, h, page, n_pages, num_splits,
            _DTYPES[q.dtype],
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            1.0 / (h ** 0.5), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.paged_decode_attention_error(code).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg}")
    kernel_guard().count_launch(KERNEL)
    return out


def _lib_dense() -> ctypes.CDLL:
    lib = _build.load(KERNEL_DENSE)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ci, i64, i64, i64, ctypes.c_float, vp]
        fn.restype = ci
        lib.decode_attention_error.argtypes = [ci]
        lib.decode_attention_error.restype = ctypes.c_char_p
    return lib


def _check_dense(q, k_cache, v_cache, lengths, head_major: bool) -> None:
    if q.ndim != 3 or k_cache.ndim != 4 or lengths.ndim != 1:
        raise ValueError(
            "expected q [B,NQ,H], caches [B,T,NK,H] (head-major [B,NK,T,H]),"
            f" lengths [B]; got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(lengths.shape)}")
    b, nq, h = q.shape
    nk = k_cache.shape[1] if head_major else k_cache.shape[2]
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != h:
        raise ValueError("k_cache / v_cache / q disagree: "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}, "
                         f"{tuple(q.shape)}")
    if nq % nk != 0:
        raise ValueError(f"NQ={nq} is not a multiple of NK={nk}")
    if lengths.shape[0] != b or lengths.device != q.device:
        raise ValueError(f"lengths {tuple(lengths.shape)} on "
                         f"{lengths.device} does not match q's batch / "
                         "device")
    _check_kv(q, k_cache, v_cache, "cache")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     head_major: bool = False) -> torch.Tensor:
    """Launch the dense-cache CUDA kernel.  q ``[B,NQ,H]``; caches
    ``[B,T,NK,H]`` token-major or, with ``head_major``, ``[B,NK,T,H]``,
    read in place through their strides (no pad, no transpose); lengths
    ``[B]`` (as int32; at most T counts).  f32, bf16 or f16 in, f32
    math, output in q's dtype.  The live tokens are cut into runs of whole
    ``DENSE_CHUNK``-token chunks, as many as fill the card
    (``default_num_splits``, from the shapes alone).

    Runs on PyTorch's current stream, never synchronises, and raises on
    anything the kernel does not take or on a refused launch: there is
    no fallback to the plain version."""
    if not q.is_cuda:
        raise RuntimeError(
            f"decode_attention launches a CUDA kernel; q is on {q.device} "
            "(CPU tensors go through decode_attention_plain)")
    q = q.contiguous()
    _check_dense(q, k_cache, v_cache, lengths, head_major)
    lengths = lengths.to(torch.int32).contiguous()
    b, nq, h = q.shape
    if head_major:
        nk, t = k_cache.shape[1], k_cache.shape[2]
        s_b, s_head, s_tok = (k_cache.stride(0), k_cache.stride(1),
                              k_cache.stride(2))
    else:
        t, nk = k_cache.shape[1], k_cache.shape[2]
        s_b, s_tok, s_head = (k_cache.stride(0), k_cache.stride(1),
                              k_cache.stride(2))
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out.zero_()
    num_splits = default_num_splits(
        b, nq, nk, -(-t // DENSE_CHUNK),
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    part = None
    if num_splits > 1:
        part = torch.empty((b, nq, num_splits, h + 2), dtype=torch.float32,
                           device=q.device)
    lib = _lib_dense()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, nq, nk, h, t,
            DENSE_CHUNK, num_splits, _DTYPES[q.dtype], s_b,
            s_head, s_tok, 1.0 / (h ** 0.5),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.decode_attention_error(code).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg}")
    kernel_guard().count_launch(KERNEL_DENSE)
    return out
