"""Transformer stack assembly for the ported block kinds.

The decoder stack is ``cfg.block_pattern`` cycled over
``cfg.num_layers``.  The JAX package stacks parameters and caches per
pattern position (``[n_periods, ...]``) so it can ``lax.scan`` over
periods; eager PyTorch has no use for that, so the port keeps a plain
**list with one entry per layer**, in layer order
``layer = period * len(pattern) + pos`` (``repro_torch.convert`` maps
one layout onto the other).

Block kinds ported so far:
    attention         norm→attn→norm→ffn (dense MLP)
``shared_attention``, ``mamba2``, ``rwkv6`` and the MoE FFN raise
``NotImplementedError`` until the model-zoo slice ports them.

Caches are updated in place; see ``repro_torch.models.attention``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    attention_decode_apply,
    attention_decode_paged,
    attention_prefill_apply,
    attention_prefill_chunk,
    init_attention,
)
from repro_torch.models.layers import (
    Params,
    init_mlp,
    init_rmsnorm,
    mlp_apply,
    rmsnorm_apply,
)

Cache = list[dict[str, Any]]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for anything a later slice of the port still has to bring."""
    for kind in cfg.block_pattern:
        if kind != "attention":
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet: it arrives with "
                "the model-zoo slice (MoE / SSM / RWKV / shared attention)")
    if cfg.moe is not None:
        raise NotImplementedError(
            "the MoE FFN is not ported yet: it arrives with the model-zoo "
            "slice")
    if cfg.kind != "decoder" or cfg.frontend != "none":
        raise NotImplementedError(
            "encoder-decoder models and frontends are not ported yet: they "
            "arrive with the model-zoo slice")


def attention_only_pattern(cfg: ModelConfig) -> bool:
    """True iff every block in the pattern carries a KV cache (no
    recurrent state) — the precondition for chunked prefill."""
    return all(k in ("attention", "shared_attention")
               for k in cfg.block_pattern)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Params:
    d = cfg.d_model
    return {
        "ln1": init_rmsnorm(d, gen.device),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": init_rmsnorm(d, gen.device),
        "ffn": init_mlp(gen, d, cfg.d_ff, gated=cfg.gated_mlp, dtype=dtype),
    }


def _ffn_residual(params: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    h = rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg.act)


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def init_stack(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> list[Params]:
    check_supported(cfg)
    return [init_block(gen, cfg, dtype) for _ in range(cfg.num_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None) -> Cache:
    """Dense decode cache: per layer ``k`` / ``v`` [B, T, NK, H] with
    T = max_len (or the sliding window)."""
    h = cfg.resolved_head_dim
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.num_kv_heads, h)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def init_stack_cache_paged(cfg: ModelConfig, slots: int, num_pages: int,
                           page_size: int, *, dtype=torch.bfloat16,
                           device=None) -> Cache:
    """Paged cache: per layer a global page pool ``[P, NK, page, H]``
    shared by all slots (page 0 reserved as write scratch)."""
    shape = (num_pages, cfg.num_kv_heads, page_size, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def stack_prefill(params: list[Params], cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int, *,
                  cache_dtype=torch.bfloat16, length: int | None = None
                  ) -> tuple[torch.Tensor, Cache]:
    """Parallel prefill through the stack, emitting the decode cache."""
    cache: Cache = []
    for bp in params:
        h = rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        y, k_c, v_c = attention_prefill_apply(
            bp["attn"], cfg, h, positions, max_len, cache_dtype,
            length=length)
        x = _ffn_residual(bp, cfg, x + y)
        cache.append({"k": k_c, "v": v_c})
    return x, cache


def stack_decode(params: list[Params], cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, pos: torch.Tensor
                 ) -> tuple[torch.Tensor, Cache]:
    """Single-token decode through the whole stack (dense cache)."""
    for bp, c in zip(params, cache):
        h = rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        y, _, _ = attention_decode_apply(bp["attn"], cfg, h, c["k"], c["v"],
                                         pos)
        x = _ffn_residual(bp, cfg, x + y)
    return x, cache


def stack_decode_paged(params: list[Params], cfg: ModelConfig,
                       x: torch.Tensor, cache: Cache, pos: torch.Tensor,
                       block_tables: torch.Tensor, active: torch.Tensor, *,
                       max_len: int, impl: str = "auto"
                       ) -> tuple[torch.Tensor, Cache]:
    """Single-token decode through the stack against paged KV pools.

    Every layer shares one block table per request: tables index each
    layer's own pool with identical page ids, so admit/evict move O(1)
    table rows instead of O(layers) cache slices."""
    w = cfg.sliding_window
    cap = min(max_len, w) if w > 0 else max_len
    for bp, c in zip(params, cache):
        h = rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        y, _, _ = attention_decode_paged(
            bp["attn"], cfg, h, c["k"], c["v"], pos, block_tables, active,
            kv_capacity=cap, impl=impl)
        x = _ffn_residual(bp, cfg, x + y)
    return x, cache


def stack_prefill_chunk(params: list[Params], cfg: ModelConfig,
                        x: torch.Tensor, cache: Cache,
                        block_table: torch.Tensor, ctx_len: int,
                        n_valid: int) -> tuple[torch.Tensor, Cache]:
    """One prompt chunk through an attention-only stack, scattering K/V
    straight into the request's pages.  x [1,C,d]; block_table [NP].
    Dense attention only (asserted upstream)."""
    for bp, c in zip(params, cache):
        h = rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        y, _, _ = attention_prefill_chunk(
            bp["attn"], cfg, h, c["k"], c["v"], block_table, ctx_len,
            n_valid)
        x = _ffn_residual(bp, cfg, x + y)
    return x, cache
