"""Transformer stack assembly: homogeneous and hybrid block stacks.

The decoder stack is ``cfg.block_pattern`` cycled over
``cfg.num_layers``.  The JAX package stacks parameters and caches per
pattern position (``[n_periods, ...]``) so it can ``lax.scan`` over
periods; eager PyTorch has no use for that, so the port keeps a plain
**list with one entry per layer**, in layer order
``layer = period * len(pattern) + pos`` (``repro_torch.convert`` maps
one layout onto the other); ``layer_kinds`` names each entry's kind.

Block kinds:
    attention         norm→attn→norm→ffn (dense MLP)
    shared_attention  the same, tied weights: every such layer's entry is
                      the ONE parameter dict (the reference's
                      ``params["shared_attn"]``), each with its own KV
    mamba2            norm→mamba2 (no FFN, Zamba2-style)
    rwkv6             norm→time-mix→norm→channel-mix
The MoE FFN, encoder-decoder models and frontends raise
``NotImplementedError`` until a later slice ports them.

``stack_apply`` is the full-sequence (training) stack.  With
``remat=True`` each block runs as ONE op, ``repro_torch::remat_block``:
its backward recomputes the block from the saved inputs instead of
keeping the block's activations — the counterpart of the reference's
``jax.checkpoint`` — and, being one op, it is one far node in the graph
the offload planner captures (its fake implementation gives the output
shape without running it), as the reference's checkpointed block is one
``remat`` eqn the planner leaves far.

Caches are updated in place; see ``repro_torch.models.attention``.  A
recurrent layer (mamba2, rwkv6) keeps one state row per batch row or
slot; its decode computes fresh state and writes it back into the cache.
"""
from __future__ import annotations

import collections
from typing import Any

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    attention_apply,
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

ATTENTION_KINDS = ("attention", "shared_attention")
KINDS = (*ATTENTION_KINDS, "mamba2", "rwkv6")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for anything a later slice of the port still has to bring."""
    for kind in cfg.block_pattern:
        if kind not in KINDS:
            raise NotImplementedError(f"block kind {kind!r} is not ported")
    if cfg.moe is not None:
        raise NotImplementedError(
            "the MoE FFN is not ported yet: it arrives with a later "
            "model-zoo slice")
    if cfg.kind != "decoder" or cfg.frontend != "none":
        raise NotImplementedError(
            "encoder-decoder models and frontends are not ported yet: they "
            "arrive with a later model-zoo slice")


def attention_only_pattern(cfg: ModelConfig) -> bool:
    """True iff every block in the pattern carries a KV cache (no
    recurrent state) — the precondition for chunked prefill."""
    return all(k in ATTENTION_KINDS for k in cfg.block_pattern)


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of every layer, in layer order."""
    pattern = cfg.block_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype=torch.float32) -> Params:
    d = cfg.d_model
    if kind in ATTENTION_KINDS:
        return {
            "ln1": init_rmsnorm(d, gen.device),
            "attn": init_attention(gen, cfg, dtype),
            "ln2": init_rmsnorm(d, gen.device),
            "ffn": init_mlp(gen, d, cfg.d_ff, gated=cfg.gated_mlp,
                            dtype=dtype),
        }
    if kind == "mamba2":
        return {"ln1": init_rmsnorm(d, gen.device),
                "mamba": ssm_mod.init_mamba2(gen, cfg, dtype)}
    if kind == "rwkv6":
        return {"ln1": init_rmsnorm(d, gen.device),
                "ln2": init_rmsnorm(d, gen.device),
                "rwkv": rwkv_mod.init_rwkv6(gen, cfg, dtype)}
    raise ValueError(kind)


def _ffn_residual(params: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    h = rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg.act)


def block_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, kind: str) -> torch.Tensor:
    """One block over the full sequence (the training path)."""
    h = rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind in ATTENTION_KINDS:
        x = x + attention_apply(params["attn"], cfg, h, positions)
        return _ffn_residual(params, cfg, x)
    if kind == "mamba2":
        return x + ssm_mod.mamba2_apply(params["mamba"], cfg, h)
    if kind == "rwkv6":
        x = x + rwkv_mod.rwkv6_time_mix_apply(params["rwkv"], cfg, h)
        h = rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
        return x + rwkv_mod.rwkv6_channel_mix_apply(params["rwkv"], cfg, h)
    raise ValueError(kind)


def block_prefill_apply(params: Params, cfg: ModelConfig, kind: str,
                        x: torch.Tensor, positions: torch.Tensor,
                        max_len: int, cache_dtype,
                        length: int | torch.Tensor | None
                        ) -> tuple[torch.Tensor, dict]:
    """Parallel prefill of one block: its output and its decode cache."""
    h = rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind in ATTENTION_KINDS:
        y, k_c, v_c = attention_prefill_apply(
            params["attn"], cfg, h, positions, max_len, cache_dtype,
            length=length)
        return _ffn_residual(params, cfg, x + y), {"k": k_c, "v": v_c}
    if kind == "mamba2":
        y, cache = ssm_mod.mamba2_apply(params["mamba"], cfg, h,
                                        return_state=True)
        return x + y, cache
    if kind == "rwkv6":
        y, wkv = rwkv_mod.rwkv6_time_mix_apply(params["rwkv"], cfg, h,
                                               return_state=True)
        x = x + y
        h2 = rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
        y2 = rwkv_mod.rwkv6_channel_mix_apply(params["rwkv"], cfg, h2)
        return x + y2, {"wkv": wkv, "tshift": h[:, -1:],
                        "cshift": h2[:, -1:]}
    raise ValueError(kind)


def recurrent_decode(params: Params, cfg: ModelConfig, kind: str,
                     x: torch.Tensor, cache: dict
                     ) -> tuple[torch.Tensor, dict]:
    """Single-token decode of a recurrent block (mamba2, rwkv6): its
    output and its new state (fresh tensors; ``cache`` is not touched)."""
    h = rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        y, new = ssm_mod.mamba2_decode_apply(params["mamba"], cfg, h, cache)
        return x + y, new
    if kind == "rwkv6":
        y, new = rwkv_mod.rwkv6_decode_apply(params["rwkv"], cfg, h, cache)
        x = x + y
        h = rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
        y = rwkv_mod._channel_mix(params["rwkv"], cfg, h, cache["cshift"])
        return x + y, {**new, "cshift": h}
    raise ValueError(kind)


def _write_state(cache: dict, new: dict,
                 active: torch.Tensor | None = None) -> None:
    """Write a recurrent block's new state into its cache, in place.
    With ``active [B]``, the rows of inactive slots keep their values
    (the reference's ``_mask_recurrent``), chosen on the device without
    a host sync."""
    for name, t in new.items():
        if active is not None:
            m = active.reshape((-1,) + (1,) * (t.ndim - 1))
            t = torch.where(m, t.to(cache[name].dtype), cache[name])
        cache[name].copy_(t)


# ---------------------------------------------------------------------------
# remat: one block as one op whose backward recomputes it
# ---------------------------------------------------------------------------

# the static side of a remat block (its config, kind and the structure of
# its parameter tree), by the string key the op carries
_REMAT: dict[str, tuple[ModelConfig, str, Any]] = {}
_REMAT_KEYS: dict[tuple, str] = {}


def _remat_key(cfg: ModelConfig, kind: str, spec: Any) -> str:
    k = (cfg, kind, str(spec))
    if k not in _REMAT_KEYS:
        _REMAT_KEYS[k] = key = f"block{len(_REMAT_KEYS)}"
        _REMAT[key] = (cfg, kind, spec)
    return _REMAT_KEYS[k]


def _remat_run(key: str, x, positions, leaves):
    cfg, kind, spec = _REMAT[key]
    return block_apply(pytree.tree_unflatten(list(leaves), spec), cfg, x,
                       positions, kind)


@torch.library.custom_op("repro_torch::remat_block", mutates_args=())
def remat_block_op(x: torch.Tensor, positions: torch.Tensor,
                   leaves: list[torch.Tensor], key: str) -> torch.Tensor:
    """``block_apply`` as one op (see the module docstring)."""
    with torch.no_grad():
        return _remat_run(key, x, positions, leaves)


@remat_block_op.register_fake
def _remat_block_fake(x, positions, leaves, key):
    return torch.empty_like(x)


def _remat_setup(ctx, inputs, output):
    x, positions, leaves, key = inputs
    ctx.key = key
    ctx.save_for_backward(x, positions, *leaves)


def _remat_backward(ctx, grad):
    x, positions, *leaves = ctx.saved_tensors
    with torch.enable_grad():
        xd = x.detach().requires_grad_()
        ld = [t.detach().requires_grad_() for t in leaves]
        y = _remat_run(ctx.key, xd, positions, ld)
        grads = torch.autograd.grad(y, [xd, *ld], grad, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, [xd, *ld])]
    return grads[0], None, grads[1:], None


remat_block_op.register_autograd(_remat_backward, setup_context=_remat_setup)


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def init_stack(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> list[Params]:
    """One parameter dict per layer; every ``shared_attention`` layer
    holds the same dict (tied weights), drawn once, first."""
    check_supported(cfg)
    kinds = layer_kinds(cfg)
    shared = (init_block(gen, cfg, "shared_attention", dtype)
              if "shared_attention" in kinds else None)
    return [shared if kind == "shared_attention"
            else init_block(gen, cfg, kind, dtype) for kind in kinds]


class Ties:
    """How a parameter tree's places map onto its unique tensors: the
    one place where the tied ``shared_attention`` block is counted once.

    ``init_stack`` puts the same dict at every ``shared_attention``
    position, as the reference keeps ``params["shared_attn"]`` once.
    Training treats the tree as its unique tensors (by identity, in the
    order of their first place among ``pytree.tree_leaves``):
    ``unique(tree)`` picks them from ``tree`` or from any tree of the
    same structure (gradients, moments), and ``tree(leaves)`` rebuilds
    the structure from one tensor a unique leaf, the same tensor at every
    place that held one.  So a gradient taken with respect to the unique
    leaves is the sum over the tied positions, an optimizer keeps one
    entry for the block, and a norm counts it once.  A tree without ties
    maps one to one."""

    def __init__(self, tree: Any):
        leaves, self.spec = pytree.tree_flatten(tree)
        ids: dict[int, int] = {}
        self.index = [ids.setdefault(id(t), len(ids)) for t in leaves]
        # unique tensors are numbered in the order of their first places
        self.first: list[int] = []
        for i, u in enumerate(self.index):
            if u == len(self.first):
                self.first.append(i)

    def unique(self, tree: Any) -> list:
        """The leaves of ``tree`` at the unique tensors' first places."""
        leaves = pytree.tree_leaves(tree)
        return [leaves[i] for i in self.first]

    def tree(self, leaves: list) -> Any:
        """The structure with ``leaves[u]`` at every place of unique
        tensor ``u``."""
        return pytree.tree_unflatten([leaves[u] for u in self.index],
                                     self.spec)

    def keys(self, tree: Any) -> list[str]:
        """A name for each unique tensor of ``tree``: its first place's
        path, ``/``-joined; a tensor that several places hold is the
        tied block, named as the reference names it — ``shared_attn``
        in place of its first position's ``layers/<i>``."""
        paths = [p for p, _ in pytree.tree_flatten_with_path(tree)[0]]
        places = collections.Counter(self.index)
        out = []
        for u, i in enumerate(self.first):
            parts = [str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in paths[i]]
            if places[u] > 1:
                at = parts.index("layers")
                parts[at:at + 2] = ["shared_attn"]
            out.append("/".join(parts))
        return out


def stack_apply(params: list[Params], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, remat: bool = False
                ) -> torch.Tensor:
    """The full-sequence stack (training forward): x [B, S, D] ->
    [B, S, D].  ``remat`` runs each block as one recomputing op."""
    for bp, kind in zip(params, layer_kinds(cfg)):
        if remat:
            leaves, spec = pytree.tree_flatten(bp)
            x = remat_block_op(x, positions, leaves,
                               _remat_key(cfg, kind, spec))
        else:
            x = block_apply(bp, cfg, x, positions, kind)
    return x


def _recurrent_cache(cfg: ModelConfig, kind: str, rows: int, dtype,
                     device) -> dict:
    """A recurrent layer's state, one row per batch row or slot."""
    if kind == "mamba2":
        return ssm_mod.init_mamba2_cache(cfg, rows, dtype, device)
    return rwkv_mod.init_rwkv6_cache(cfg, rows, dtype, device)


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None) -> Cache:
    """Dense decode cache: per attention layer ``k`` / ``v`` [B, T, NK, H]
    with T = max_len (or the sliding window); per recurrent layer its
    state rows."""
    h = cfg.resolved_head_dim
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.num_kv_heads, h)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            if kind in ATTENTION_KINDS
            else _recurrent_cache(cfg, kind, batch, dtype, device)
            for kind in layer_kinds(cfg)]


def init_stack_cache_paged(cfg: ModelConfig, slots: int, num_pages: int,
                           page_size: int, *, dtype=torch.bfloat16,
                           device=None) -> Cache:
    """Paged cache: per attention layer a global page pool ``[P, NK,
    page, H]`` shared by all slots (page 0 reserved as write scratch);
    per recurrent layer one state row per slot."""
    shape = (num_pages, cfg.num_kv_heads, page_size, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            if kind in ATTENTION_KINDS
            else _recurrent_cache(cfg, kind, slots, dtype, device)
            for kind in layer_kinds(cfg)]


def stack_prefill(params: list[Params], cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int, *,
                  cache_dtype=torch.bfloat16,
                  length: int | torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, Cache]:
    """Parallel prefill through the stack, emitting the decode cache."""
    cache: Cache = []
    for bp, kind in zip(params, layer_kinds(cfg)):
        x, c = block_prefill_apply(bp, cfg, kind, x, positions, max_len,
                                   cache_dtype, length)
        cache.append(c)
    return x, cache


def stack_decode(params: list[Params], cfg: ModelConfig, x: torch.Tensor,
                 cache: Cache, pos: torch.Tensor
                 ) -> tuple[torch.Tensor, Cache]:
    """Single-token decode through the whole stack (dense cache)."""
    for bp, c, kind in zip(params, cache, layer_kinds(cfg)):
        if kind not in ATTENTION_KINDS:
            x, new = recurrent_decode(bp, cfg, kind, x, c)
            _write_state(c, new)
            continue
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
    table rows instead of O(layers) cache slices.  A recurrent layer
    computes every slot's new state and keeps it for the active slots
    only: an inactive slot's row is frozen."""
    w = cfg.sliding_window
    cap = min(max_len, w) if w > 0 else max_len
    for bp, c, kind in zip(params, cache, layer_kinds(cfg)):
        if kind not in ATTENTION_KINDS:
            x, new = recurrent_decode(bp, cfg, kind, x, c)
            _write_state(c, new, active)
            continue
        h = rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        y, _, _ = attention_decode_paged(
            bp["attn"], cfg, h, c["k"], c["v"], pos, block_tables, active,
            kv_capacity=cap, impl=impl)
        x = _ffn_residual(bp, cfg, x + y)
    return x, cache


def stack_prefill_chunk(params: list[Params], cfg: ModelConfig,
                        x: torch.Tensor, cache: Cache,
                        block_table: torch.Tensor,
                        ctx_len: int | torch.Tensor,
                        n_valid: int | torch.Tensor
                        ) -> tuple[torch.Tensor, Cache]:
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
