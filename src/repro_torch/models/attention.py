"""Attention: GQA / MHA, sliding-window, qk-norm, dense and paged KV cache.

The counterpart of ``repro/models/attention.py`` for one device:

* ``blockwise_attention`` — prefill path.  Blockwise flash-style
  online-softmax attention in plain PyTorch (query blocks outer, KV
  blocks inner) that never materializes the [S, T] score matrix.  The
  JAX package runs this path in pure ``jnp`` as well, outside any
  kernel.
* ``decode_attention`` — single-token decode against a dense KV cache,
  chunked over the cache.
* ``attention_decode_paged`` — single-token decode against the paged
  pool; the attention itself is the custom op
  ``repro_torch::paged_decode_attention``: the hand-written CUDA kernel
  (``repro_torch.kernels.ops.paged_decode_attention``) for CUDA tensors
  and its plain version for CPU tensors.  Being one op, it is one far
  node in the graph the offload planner captures (``register_fake``
  gives its output shape without running it).

Caches and page pools are updated **in place** (the JAX package is
functional and relies on buffer donation); functions still return them
so call sites read like their counterparts.

Shapes: q [B, S, NQ, H]; k/v [B, T, NK, H]; GQA groups G = NQ // NK;
page pools [P, NK, page, H]; block tables [B, NP] int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Params,
    apply_rope,
    at,
    dense_init,
    init_rmsnorm,
    rmsnorm_apply,
)

NEG_INF = -1e30


@torch.library.custom_op("repro_torch::paged_decode_attention",
                         mutates_args=())
def paged_attention_op(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, impl: str) -> torch.Tensor:
    """Paged decode attention as one op (see the module docstring)."""
    return kops.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                       lengths, impl=impl)


@paged_attention_op.register_fake
def _paged_attention_fake(q, k_pages, v_pages, block_tables, lengths, impl):
    return torch.empty_like(q)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    d = cfg.d_model
    h = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p: Params = {
        "wq": dense_init(gen, d, nq * h, dtype),
        "wk": dense_init(gen, d, nkv * h, dtype),
        "wv": dense_init(gen, d, nkv * h, dtype),
        "wo": dense_init(gen, nq * h, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq * h,), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((nkv * h,), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((nkv * h,), dtype=dtype, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(h, gen.device)
        p["k_norm"] = init_rmsnorm(h, gen.device)
    return p


def project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor | None):
    """Project to q, k, v (with bias / qk-norm / rope as configured)."""
    h = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ at(params["wq"], x.dtype)
    k = x @ at(params["wk"], x.dtype)
    v = x @ at(params["wv"], x.dtype)
    if cfg.qkv_bias:
        q = q + at(params["bq"], x.dtype)
        k = k + at(params["bk"], x.dtype)
        v = v + at(params["bv"], x.dtype)
    q = q.reshape(*q.shape[:-1], nq, h)
    k = k.reshape(*k.shape[:-1], nkv, h)
    v = v.reshape(*v.shape[:-1], nkv, h)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# blockwise flash-style attention (plain PyTorch)
# ---------------------------------------------------------------------------

def _pad_axis1(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad ``x`` [B, T, ...] by ``pad`` entries at the end of axis 1."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def _online_softmax_step(carry, s, ok, vblk, eq: str):
    """One KV block of online softmax: scores ``s`` (f32, scaled),
    mask ``ok`` broadcastable to ``s``; ``p`` is rounded to V's dtype
    before the PV product, as the JAX path does."""
    acc, m, l = carry
    s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, s.max(dim=-1).values)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum(eq, p.to(vblk.dtype).float(), vblk.float())
    return acc * corr[..., None] + pv, m_new, l_new


def blockwise_attention(
    q: torch.Tensor,  # [B, S, NQ, H]
    k: torch.Tensor,  # [B, T, NK, H]
    v: torch.Tensor,  # [B, T, NK, H]
    *,
    causal: bool = True,
    window: int = 0,
    q_block: int = 512,
    kv_block: int = 512,
    q_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Online-softmax attention; never materializes [S, T] scores.

    ``q_offset``: absolute position of q[0] (prefill continuation), an
    int or a 0-d int tensor on the device.  Products accumulate in f32
    and softmax statistics are f32.  With an int offset, KV blocks that
    lie wholly in a causal query block's future are skipped: they would
    contribute exact zeros.  A tensor offset is not read on the host:
    every KV block is walked and masked, which gives the same bits (KV
    block 0 holds an admissible key for every query, so a block wholly
    in the future adds ``exp(-inf) = 0`` to ``l`` and ``acc`` with a
    correction of exactly 1).
    """
    B, S, NQ, H = q.shape
    T, NK = k.shape[1], k.shape[2]
    G = NQ // NK
    q_block = min(q_block, S)
    kv_block = min(kv_block, T)
    s_pad = (-S) % q_block
    t_pad = (-T) % kv_block
    qp = _pad_axis1(q, s_pad).reshape(B, S + s_pad, NK, G, H)
    kp = _pad_axis1(k, t_pad)
    vp = _pad_axis1(v, t_pad)
    nqb, nkb = (S + s_pad) // q_block, (T + t_pad) // kv_block
    scale = 1.0 / (H ** 0.5)
    dev = q.device
    outs = []
    for qi in range(nqb):
        qblk = qp[:, qi * q_block:(qi + 1) * q_block].float()
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        carry = (torch.zeros((B, q_block, NK, G, H), dtype=torch.float32,
                             device=dev),
                 torch.full((B, q_block, NK, G), NEG_INF,
                            dtype=torch.float32, device=dev),
                 torch.zeros((B, q_block, NK, G), dtype=torch.float32,
                             device=dev))
        skip = causal and not isinstance(q_offset, torch.Tensor)
        last_q = q_offset + (qi + 1) * q_block - 1
        for ki in range(nkb):
            if skip and ki * kv_block > last_q:
                break
            kblk = kp[:, ki * kv_block:(ki + 1) * kv_block]
            vblk = vp[:, ki * kv_block:(ki + 1) * kv_block]
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgh,bckh->bqkgc", qblk, kblk.float()) * scale
            ok = (k_pos < T)[None, :].expand(q_block, kv_block)
            if causal:
                ok = ok & (k_pos[None, :] <= q_pos[:, None])
            if window > 0:
                ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
            carry = _online_softmax_step(
                carry, s, ok[None, :, None, None, :], vblk,
                "bqkgc,bckh->bqkgh")
        acc, _, l = carry
        outs.append((acc / torch.clamp(l[..., None], min=1e-37)).to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(B, nqb * q_block, NQ, H)
    return out[:, :S]


def decode_attention(
    q: torch.Tensor,        # [B, NQ, H] single query token
    k_cache: torch.Tensor,  # [B, T, NK, H]
    v_cache: torch.Tensor,  # [B, T, NK, H]
    lengths: torch.Tensor,  # [B] valid cache lengths (new token's pos + 1)
    *,
    window: int = 0,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Decode attention over a dense cache, chunked over the cache with
    online softmax.  Memory-bound: about two operations a cache byte."""
    B, NQ, H = q.shape
    T, NK = k_cache.shape[1], k_cache.shape[2]
    G = NQ // NK
    kv_block = min(kv_block, T)
    t_pad = (-T) % kv_block
    kp = _pad_axis1(k_cache, t_pad)
    vp = _pad_axis1(v_cache, t_pad)
    nkb = (T + t_pad) // kv_block
    qg = q.reshape(B, NK, G, H).float()
    scale = 1.0 / (H ** 0.5)
    dev = q.device
    carry = (torch.zeros((B, NK, G, H), dtype=torch.float32, device=dev),
             torch.full((B, NK, G), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((B, NK, G), dtype=torch.float32, device=dev))
    for ki in range(nkb):
        kblk = kp[:, ki * kv_block:(ki + 1) * kv_block]
        vblk = vp[:, ki * kv_block:(ki + 1) * kv_block]
        k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
        s = torch.einsum("bkgh,bckh->bkgc", qg, kblk.float()) * scale
        ok = k_pos[None, :] < lengths[:, None]
        if window > 0:
            ok = ok & (k_pos[None, :] > (lengths[:, None] - 1 - window))
        carry = _online_softmax_step(carry, s, ok[:, None, None, :], vblk,
                                     "bkgc,bckh->bkgh")
    acc, _, l = carry
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(B, NQ, H).to(q.dtype)


# ---------------------------------------------------------------------------
# module-level apply fns
# ---------------------------------------------------------------------------

def attention_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True
                    ) -> torch.Tensor:
    """Full-sequence self-attention (the training path): x [B, S, D],
    positions [B, S] -> [B, S, D]."""
    q, k, v = project_qkv(params, cfg, x, positions)
    out = blockwise_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window)
    out = out.reshape(*x.shape[:-1], cfg.num_heads * cfg.resolved_head_dim)
    return out @ at(params["wo"], x.dtype)


def attention_prefill_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # [B, S, D]
    positions: torch.Tensor,       # [B, S]
    max_len: int,
    cache_dtype=torch.bfloat16,
    length: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel prefill: full-sequence attention + KV cache capture.

    Returns (out [B,S,D], k_cache [B,T,NK,H], v_cache) with T = max_len
    (or the sliding window for SWA archs, arranged rolling so that decode
    continues with slot = pos % window).

    ``length``: number of *real* tokens when the input is right-padded to
    a shape bucket (an int, or a 0-d int tensor on the device: the
    arrangement is elementwise) — the SWA rolling capture then arranges
    by the real length so pad tokens never occupy a slot a real token
    owns (dense
    capture needs no masking: pad entries sit at positions >= length and
    decode overwrites them before its length mask would admit them)."""
    b, s, _ = x.shape
    q, k, v = project_qkv(params, cfg, x, positions)
    out = blockwise_attention(q, k, v, causal=True,
                              window=cfg.sliding_window)
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    out = out @ at(params["wo"], x.dtype)

    w = cfg.sliding_window
    if w > 0:
        size = min(max_len, w)
        j = torch.arange(size, device=x.device)
        if s >= size and length is not None:
            # length-aware rolling: slot j holds token t, the last real
            # t with t % size == j; slots no real token reaches are
            # zeroed (the layout the unpadded s < size branch produces)
            last = (length - 1) - (length - 1 - j) % size
            valid = (last >= 0)[None, :, None, None]
            idx = torch.clamp(last, 0, s - 1)
            k_c = torch.where(valid, k.index_select(1, idx), 0)
            v_c = torch.where(valid, v.index_select(1, idx), 0)
        elif s >= size:
            # rolling arrangement: buf[slot] = last token t with t%size==slot
            last = s - 1 - (s - 1 - j) % size
            k_c = k.index_select(1, last)
            v_c = v.index_select(1, last)
        else:
            k_c = _pad_axis1(k, size - s)
            v_c = _pad_axis1(v, size - s)
    else:
        k_c = _pad_axis1(k, max_len - s)
        v_c = _pad_axis1(v, max_len - s)
    return out, k_c.to(cache_dtype), v_c.to(cache_dtype)


# ---------------------------------------------------------------------------
# paged KV cache: block-table indexed page pools
# ---------------------------------------------------------------------------

def gather_kv_pages(pages: torch.Tensor, block_tables: torch.Tensor
                    ) -> torch.Tensor:
    """[P, NK, page, H] pool + [B, NP] table -> token-major [B, T, NK, H]
    contiguous copy (T = NP * page)."""
    b, n_pages = block_tables.shape
    nk, page, h = pages.shape[1:]
    g = pages[block_tables.long()]              # [B, NP, NK, page, H]
    return g.permute(0, 1, 3, 2, 4).reshape(b, n_pages * page, nk, h)


def write_kv_page_entries(pages: torch.Tensor, new: torch.Tensor,
                          page_ids: torch.Tensor, offsets: torch.Tensor
                          ) -> torch.Tensor:
    """Scatter per-row entries into the pool **in place**: ``new``
    [R, NK, H] lands at ``pages[page_ids[r], :, offsets[r]]``.  Rows
    meant to be dropped point at the reserved scratch page 0 (several
    may hit the same entry; which one lands there is unspecified)."""
    pages[page_ids.long(), :, offsets.long()] = new.to(pages.dtype)
    return pages


def attention_decode_paged(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # [B, 1, D] new token
    pages_k: torch.Tensor,         # [P, NK, page, H] global page pool
    pages_v: torch.Tensor,
    pos: torch.Tensor,             # [B] position of the new token
    block_tables: torch.Tensor,    # [B, NP] int32 (bucketed width)
    active: torch.Tensor,          # [B] bool — inactive rows write scratch
    *,
    kv_capacity: int,              # logical per-request cache size
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against the paged pool: project the new token,
    scatter its K/V into the owning page (inactive rows land in the
    reserved scratch page 0), attend over the sequence's live pages.

    The attention is ``paged_attention_op``: the CUDA kernel streams
    pages through the block table for CUDA tensors (no gather); CPU
    tensors take its plain version.  Inactive rows carry
    ``lengths == 0`` and come out as zeros; the engine discards them."""
    B = x.shape[0]
    page = pages_k.shape[2]
    q, k, v = project_qkv(params, cfg, x, pos[:, None])
    if cfg.sliding_window > 0:
        slot = pos % kv_capacity
        lengths = torch.clamp(pos + 1, max=kv_capacity)
    else:
        slot = torch.clamp(pos, max=kv_capacity - 1)
        lengths = pos + 1
    lengths = torch.where(active, lengths, 0).to(torch.int32)
    pi = torch.clamp(slot // page, 0, block_tables.shape[1] - 1)
    gp = torch.where(active, block_tables.gather(1, pi[:, None].long())[:, 0],
                     0)
    off = slot % page
    write_kv_page_entries(pages_k, k[:, 0], gp, off)
    write_kv_page_entries(pages_v, v[:, 0], gp, off)
    out = paged_attention_op(q[:, 0], pages_k, pages_v,
                             block_tables, lengths, impl)
    out = out.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    return out @ at(params["wo"], x.dtype), pages_k, pages_v


def attention_prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # [1, C, D] prompt chunk (right-padded)
    pages_k: torch.Tensor,         # [P, NK, page, H]
    pages_v: torch.Tensor,
    block_table: torch.Tensor,     # [NP] int32 — this request's pages
    ctx_len: int | torch.Tensor,   # tokens already cached
    n_valid: int | torch.Tensor,   # real tokens in this chunk
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked prefill for dense (non-SWA) attention: write the chunk's
    K/V into the request's pages, then attend the chunk's queries over
    the gathered context+chunk.  Pad rows of the chunk scatter into the
    scratch page and produce unused outputs.  ``ctx_len`` / ``n_valid``
    may be 0-d int tensors on the device (nothing is read on the host)."""
    assert cfg.sliding_window == 0, "chunked prefill is dense-only"
    _, c, _ = x.shape
    page = pages_k.shape[2]
    pos_t = ctx_len + torch.arange(c, device=x.device)
    q, k, v = project_qkv(params, cfg, x, pos_t[None])
    valid = torch.arange(c, device=x.device) < n_valid
    pi = torch.clamp(pos_t // page, 0, block_table.shape[0] - 1)
    gp = torch.where(valid, block_table[pi], 0)
    off = pos_t % page
    write_kv_page_entries(pages_k, k[0], gp, off)
    write_kv_page_entries(pages_v, v[0], gp, off)
    kg = gather_kv_pages(pages_k, block_table[None])   # [1, T, NK, H]
    vg = gather_kv_pages(pages_v, block_table[None])
    out = blockwise_attention(q, kg, vg, causal=True, window=0,
                              q_offset=ctx_len)
    out = out.reshape(1, c, cfg.num_heads * cfg.resolved_head_dim)
    return out @ at(params["wo"], x.dtype), pages_k, pages_v


def attention_decode_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,               # [B, 1, D] new token
    cache_k: torch.Tensor,         # [B, T, NK, H]
    cache_v: torch.Tensor,
    pos: torch.Tensor,             # [B] position of the new token
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a dense cache: project the new token,
    update the rolling/linear cache in place, attend over the cache.
    Returns (out [B,1,D], cache_k, cache_v)."""
    B = x.shape[0]
    T = cache_k.shape[1]
    q, k, v = project_qkv(params, cfg, x, pos[:, None])
    # write position: linear cache -> pos; rolling (SWA) cache -> pos % T
    if cfg.sliding_window > 0:
        slot = pos % T
        lengths = torch.clamp(pos + 1, max=T)
    else:
        slot = torch.clamp(pos, max=T - 1)
        lengths = pos + 1
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot.long()] = v[:, 0].to(cache_v.dtype)
    out = decode_attention(q[:, 0], cache_k, cache_v, lengths, window=0)
    out = out.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim)
    return out @ at(params["wo"], x.dtype), cache_k, cache_v


def reference_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Naive O(S*T) oracle used only by tests."""
    B, S, NQ, H = q.shape
    T, NK = k.shape[1], k.shape[2]
    G = NQ // NK
    qg = q.reshape(B, S, NK, G, H).float()
    s = torch.einsum("bskgh,btkh->bskgt", qg, k.float()) / (H ** 0.5)
    q_pos = q_offset + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, NQ, H).to(q.dtype)
