"""Public model API of the port: build a decoder from its config (dense,
hybrid Mamba2 with tied shared attention, or RWKV6).

``build_model(cfg, device=...)`` returns a ``Model`` of plain functions,
named as in ``repro/models/model.py``:

    init(seed)                                   -> params (f32 masters)
    forward(params, batch, remat=False)          -> (hidden, aux, offset)
    loss_fn(params, batch, remat=True)           -> (loss, metrics)
    prefill(params, batch, max_len, length)      -> (last_logits, cache)
    decode_step(params, cache, token, pos)       -> (logits, cache)
    init_cache / init_paged_cache
    decode_step_paged(params, cache, token, pos, block_tables, active)
    prefill_chunk(params, cache, tokens, block_table, ctx_len, n_valid)

Parameters are ``{"embed", "final_ln", "layers": [block, ...]}``.
``init`` gives f32 master parameters, as the JAX package's ``init``
does; every function casts a weight to the compute dtype where it uses
it (``layers.at``), so ``loss_fn``'s gradients reach the masters.  The
serving engine casts its copy once (``layers.cast_params``), after
which those casts are no ops.  Caches are updated in place and
returned.  The serving functions run under ``torch.no_grad``;
``forward`` and ``loss_fn`` record gradients.  The encoder and the
frontends arrive with the rest of the model zoo.  A ``shared_attention``
layer's entry in ``layers`` is the one tied dict.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import compute_dtype, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    cross_entropy_loss,
    embed_apply,
    init_embedding,
    init_rmsnorm,
    lm_head_apply,
    rmsnorm_apply,
)
from repro_torch.models.transformer import (
    Cache,
    attention_only_pattern,
    check_supported,
    init_stack,
    init_stack_cache,
    init_stack_cache_paged,
    stack_apply,
    stack_decode,
    stack_decode_paged,
    stack_prefill,
    stack_prefill_chunk,
)


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    init: Callable[..., Params]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor, int]]
    loss_fn: Callable[..., tuple[torch.Tensor, dict]]
    prefill: Callable[..., tuple[torch.Tensor, Cache]]
    decode_step: Callable[..., tuple[torch.Tensor, Cache]]
    init_cache: Callable[..., Cache]
    # paged serving surface (continuous batching engine)
    init_paged_cache: Callable[..., Cache]
    decode_step_paged: Callable[..., tuple[torch.Tensor, Cache]]
    prefill_chunk: Callable[..., tuple[torch.Tensor, Cache]]


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda"
                ) -> Model:
    """Build the model's functions for ``device`` (default: the GPU;
    raises when there is none — pass ``device="cpu"`` for the CPU)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg.dtype)

    def _tokens(t) -> torch.Tensor:
        return torch.as_tensor(t, device=dev).long()

    def _at(h: torch.Tensor, index) -> torch.Tensor:
        """``h[:, index]``; a tensor index is read on the device."""
        if isinstance(index, torch.Tensor):
            return h.index_select(1, index.reshape(1).long())[:, 0]
        return h[:, index]

    def _head(params: Params, h_last: torch.Tensor) -> torch.Tensor:
        h_last = rmsnorm_apply(params["final_ln"], h_last, cfg.norm_eps)
        return lm_head_apply(params["embed"], h_last, cfg.vocab_size)

    # ---------------- init ----------------
    def init(seed: int = 0) -> Params:
        """Random f32 master parameters drawn on the device from an
        explicit ``torch.Generator`` (scales as the JAX initializers:
        N(0, 1/in) for dense weights, N(0, 0.02²) for the embedding
        table)."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                    tie=cfg.tie_embeddings),
            "final_ln": init_rmsnorm(cfg.d_model, dev),
            "layers": init_stack(gen, cfg),
        }

    # ---------------- training ----------------
    def forward(params: Params, batch: dict, *, remat: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Returns (hidden [B, S, D] after the final norm, aux, text
        offset); aux is the MoE loss (0 for a dense stack)."""
        tokens = _tokens(batch["tokens"])
        b, s = tokens.shape
        x = embed_apply(params["embed"], tokens, dtype)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        h = stack_apply(params["layers"], cfg, x, positions, remat=remat)
        h = rmsnorm_apply(params["final_ln"], h, cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=dev), 0

    def loss_fn(params: Params, batch: dict, *, remat: bool = True
                ) -> tuple[torch.Tensor, dict]:
        """Mean token cross-entropy (masked by ``batch["mask"]``) plus
        the aux loss; metrics ``loss``, ``moe_aux``, ``tokens``."""
        h, aux, offset = forward(params, batch, remat=remat)
        logits = lm_head_apply(params["embed"], h[:, offset:],
                               cfg.vocab_size)
        mask = batch.get("mask")
        loss = cross_entropy_loss(
            logits, _tokens(batch["labels"]),
            None if mask is None else torch.as_tensor(mask, device=dev))
        # the token count is the batch's shape, never read from its data
        n = math.prod(batch["tokens"].shape)
        return loss + aux, {"loss": loss, "moe_aux": aux,
                            "tokens": torch.full((), float(n), device=dev)}

    # ---------------- serving ----------------
    def init_cache(batch: int, max_len: int) -> Cache:
        return init_stack_cache(cfg, batch, max_len, dtype=dtype, device=dev)

    @torch.no_grad()
    def prefill(params: Params, batch: dict, max_len: int,
                length: int | torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Cache]:
        """Parallel prefill: one full-sequence pass that computes the
        last token's logits AND captures the decode cache.

        ``length``: real token count when ``tokens`` is right-padded to a
        shape bucket.  The last-token logits are read at the real end
        and the SWA rolling capture arranges by the real length.  A 0-d
        int tensor on the device is accepted and never read on the host,
        so one CUDA graph serves every prompt of a bucket."""
        tokens = _tokens(batch["tokens"])
        b, s = tokens.shape
        x = embed_apply(params["embed"], tokens, dtype)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        h, cache = stack_prefill(params["layers"], cfg, x, positions,
                                 max_len, cache_dtype=dtype, length=length)
        last = s - 1 if length is None else length - 1
        return _head(params, _at(h, last)), cache

    @torch.no_grad()
    def decode_step(params: Params, cache: Cache, token: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, Cache]:
        """token [B] int; pos [B] absolute positions."""
        x = embed_apply(params["embed"], _tokens(token)[:, None], dtype)
        h, cache = stack_decode(params["layers"], cfg, x, cache, pos)
        return _head(params, h[:, 0]), cache

    # ---------------- paged serving (continuous batching) ----------------
    def init_paged_cache(slots: int, num_pages: int, page_size: int) -> Cache:
        return init_stack_cache_paged(cfg, slots, num_pages, page_size,
                                      dtype=dtype, device=dev)

    @torch.no_grad()
    def decode_step_paged(params: Params, cache: Cache, token: torch.Tensor,
                          pos: torch.Tensor, block_tables: torch.Tensor,
                          active: torch.Tensor, *, max_len: int,
                          impl: str = "auto") -> tuple[torch.Tensor, Cache]:
        """token/pos [B]; block_tables [B,NP] int32; active [B] bool.
        Inactive rows compute but write only the reserved scratch page.
        ``impl`` picks the paged attention: ``"auto"`` is the CUDA kernel
        on the GPU and the plain version on the CPU."""
        x = embed_apply(params["embed"], _tokens(token)[:, None], dtype)
        h, cache = stack_decode_paged(params["layers"], cfg, x, cache, pos,
                                      block_tables, active, max_len=max_len,
                                      impl=impl)
        return _head(params, h[:, 0]), cache

    @torch.no_grad()
    def prefill_chunk(params: Params, cache: Cache, tokens: torch.Tensor,
                      block_table: torch.Tensor,
                      ctx_len: int | torch.Tensor,
                      n_valid: int | torch.Tensor
                      ) -> tuple[torch.Tensor, Cache]:
        """One prompt chunk [1, C] for a single request: scatter its K/V
        into the request's pages and return the logits at the chunk's
        last *real* token (meaningful only on the final chunk).  Dense
        attention-only decoder stacks (no SWA, no recurrent state).
        ``ctx_len`` / ``n_valid`` may be 0-d int tensors on the device,
        never read on the host (one CUDA graph for every chunk)."""
        assert cfg.sliding_window == 0 and attention_only_pattern(cfg)
        x = embed_apply(params["embed"], _tokens(tokens), dtype)
        h, cache = stack_prefill_chunk(params["layers"], cfg, x, cache,
                                       block_table, ctx_len, n_valid)
        last = (torch.clamp(n_valid - 1, min=0)
                if isinstance(n_valid, torch.Tensor) else max(n_valid - 1, 0))
        return _head(params, _at(h, last)), cache

    return Model(cfg, dev, dtype, init, forward, loss_fn, prefill,
                 decode_step, init_cache, init_paged_cache, decode_step_paged,
                 prefill_chunk)
