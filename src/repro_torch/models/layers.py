"""Shared layers: norms, gated MLP, rotary embedding, token embedding,
the LM head and the token cross-entropy.

Everything is a plain function over explicit parameter dicts (nested
dicts of tensors), as in ``repro/models/layers.py``.  Weights keep the
``[in, out]`` orientation (``x @ w``).  As in the JAX package, a weight
is cast to the activations' dtype where it is used (``at``), so the
training state holds f32 master parameters and their gradients reach
them through the cast.  Serving casts its copy once instead
(``cast_params``, called by the engine): a cast to the dtype a tensor
already has is no op at all, so the served graph is the same as with
weights stored in the compute dtype.  The leaves read in f32 (RMSNorm
scales and the recurrent blocks' ``F32_LEAVES``) stay f32 and
statistics (norm, softmax, loss) are f32.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def activation(name: str):
    return _ACTS[name]


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / in_dim ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def at(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype`` for one use: the tensor itself when it already
    has it (no graph node), else a cast."""
    return w if w.dtype == dtype else w.to(dtype)


#: leaves every function reads in f32 (``.float()`` where used, as the
#: reference casts its f32 masters): RMSNorm scales, the SSM's decay, skip
#: and step bias, RWKV6's decay base, bonus and head norm
F32_LEAVES = frozenset({"scale", "A_log", "D", "dt_bias", "w0", "u",
                        "ln_x_scale", "ln_x_bias"})


def cast_params(tree: Any, dtype: torch.dtype, device=None) -> Any:
    """Cast a parameter tree once into the compute dtype (the serving
    copy); the leaves named in ``F32_LEAVES`` stay f32.  A leaf that is
    already in place is kept, not copied, and a dict that appears at
    several places (tied weights) stays one dict."""
    seen: dict[int, Any] = {}

    def walk(node, name=""):
        if isinstance(node, dict):
            if id(node) not in seen:
                seen[id(node)] = {k: walk(v, k) for k, v in node.items()}
            return seen[id(node)]
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return node.to(device=device, dtype=torch.float32
                       if name in F32_LEAVES else dtype)
    return walk(tree)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params: Params, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 statistics: one read of x, one write of y."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU family)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, dtype=torch.float32) -> Params:
    p = {}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
    p["up"] = dense_init(gen, d_model, d_ff, dtype)
    p["down"] = dense_init(gen, d_ff, d_model, dtype)
    return p


def mlp_apply(params: Params, x: torch.Tensor, act: str = "silu"
              ) -> torch.Tensor:
    u = x @ at(params["up"], x.dtype)
    if "gate" in params:
        h = activation(act)(x @ at(params["gate"], x.dtype)) * u
    else:
        h = activation(act)(u)
    return h @ at(params["down"], x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # a fill on the device, not a copy from the host: the decode step
    # runs this inside a CUDA graph's capture
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / (base ** exponent)  # [head_dim//2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (integer).
    Half-split layout, f32 angles."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs      # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]              # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Token embedding + LM head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, *,
                   pad_to: int = 256, tie: bool = False,
                   dtype=torch.float32) -> Params:
    """Embedding table padded to ``pad_to`` rows (the JAX package pads
    for vocab sharding; the port keeps the same parameter shapes)."""
    padded = round_up(vocab, pad_to)
    params: Params = {"table": embed_init(gen, padded, d_model, dtype)}
    if not tie:
        params["head"] = dense_init(gen, d_model, padded, dtype)
    return params


def embed_apply(params: Params, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``tokens`` in ``dtype`` (gathered, then cast: the
    same values as casting the table first)."""
    return at(params["table"][tokens], dtype)


def lm_head_apply(params: Params, x: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    """Returns f32 logits truncated to the logical vocab size."""
    if "head" in params:
        logits = x @ at(params["head"], x.dtype)
    else:
        logits = x @ at(params["table"], x.dtype).T
    return logits[..., :vocab].float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32.  logits [B, S, V], labels
    [B, S].  The log-sum-exp subtracts the row max without a gradient,
    as ``jax.scipy.special.logsumexp`` does."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
