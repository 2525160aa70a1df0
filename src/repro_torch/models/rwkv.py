"""RWKV6 (Finch) block: data-dependent-decay linear attention and channel
mix.

The counterpart of ``repro/models/rwkv.py``.  Time mix (WKV6) per head
with state ``S`` in ``R^{K x V}``:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``w_t = exp(-exp(w0 + tanh(x A) B))`` is the data-dependent decay, ``u``
the bonus for the current token.  Prefill uses the chunked form, decode
the one-step recurrence.  Channel mix is the squared-ReLU MLP with token
shift.  Heads are normalised with a per-head LayerNorm (``ln_x``).

``wkv6_chunked`` is the model's own chunked WKV6 in plain PyTorch, as
the reference's model keeps its own apart from the kernel (the same
arithmetic as ``kernels/wkv6.py``'s ``wkv6_plain``, which serves the
kernel's tests), with the model's chunk, a carried-in state and the
final state; the model does not launch B13.  Training differentiates it
and the offload compiler captures it as it stands: the chunk loop
unrolled, each chunk's output written into its slice of ``y``.  Its
exponents are all at most 0 (the decay between two positions of a chunk
is taken per pair), where the reference's ``k * exp(-cum)`` overflows
once a chunk's summed log-decay passes about -88.  Where the reference
is finite the two agree up to rounding; the difference is by design.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.models.layers import Params, at, dense_init


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    r = cfg.rwkv or RWKVConfig()
    return cfg.d_model // r.head_dim, r.head_dim


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Params:
    r = cfg.rwkv or RWKVConfig()
    d = cfg.d_model
    nheads, hd = _dims(cfg)
    dev = gen.device

    def full(value: float) -> torch.Tensor:
        return torch.full((d,), value, dtype=dtype, device=dev)

    u = torch.rand((nheads, hd), generator=gen, device=dev) - 0.5
    return {
        # token-shift mix coefficients (static; one per interpolant)
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-2.0),
        "wa": dense_init(gen, d, r.decay_lora, dtype),
        "wb": dense_init(gen, r.decay_lora, d, dtype),
        "u": u.to(dtype),   # bonus (time_first)
        "ln_x_scale": full(1.0),
        "ln_x_bias": full(0.0),
        # channel mix
        "cmix_r": full(0.5), "cmix_k": full(0.5),
        "cwr": dense_init(gen, d, d, dtype),
        "cwk": dense_init(gen, d, cfg.d_ff, dtype),
        "cwv": dense_init(gen, cfg.d_ff, d, dtype),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The previous token's features (zeros, or ``last``, at t = 0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x, prev, coeff):
    return x + (prev - x) * at(coeff, x.dtype)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, chunk: int = 32,
                 state0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6.  r, k, w ``[B, S, H, K]``, v ``[B, S, H, V]``, u
    ``[H, K]``, state0 ``[B, H, K, V]``.  Returns ``(y [B, S, H, V] in
    r's dtype, final state [B, H, K, V] f32)``."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    chunk = min(chunk, s)
    state = (torch.zeros((b, h, kk, vv), dtype=torch.float32,
                         device=r.device) if state0 is None
             else state0.float())
    rf, kf, vf = r.float(), k.float(), v.float()
    logw = torch.log(torch.clamp(w.float(), min=1e-20))
    uf = u.float()
    y = torch.empty((b, s, h, vv), dtype=r.dtype, device=r.device)
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        q = sl.stop - s0
        rq, kq, vq = rf[:, sl], kf[:, sl], vf[:, sl]             # [B,Q,H,*]
        cum = torch.cumsum(logw[:, sl], dim=1)                   # inclusive
        prev = cum - logw[:, sl]                                 # cum_{i-1}
        strict = torch.ones((q, q), dtype=torch.bool,
                            device=r.device).tril(-1)
        # exp(cum_{i-1} - cum_j) for j < i, per channel: every exponent <= 0
        diff = prev[:, :, None] - cum[:, None, :]                # [B,Q,Q,H,K]
        pair = torch.exp(torch.where(strict[None, :, :, None, None], diff,
                                     -torch.inf))
        scores = torch.einsum("bihk,bjhk,bijhk->bhij", rq, kq, pair)
        diag = torch.einsum("bihk,hk,bihk->bih", rq, uf, kq)
        out = torch.einsum("bhij,bjhv->bihv", scores, vq)
        out = out + diag[..., None] * vq
        out = out + torch.einsum("bihk,bhkv->bihv", rq * torch.exp(prev),
                                 state)
        y[:, sl] = out.to(r.dtype)
        end = cum[:, -1]                                         # [B, H, K]
        kscale = kq * torch.exp(end[:, None] - cum)
        state = state * torch.exp(end)[..., None] + torch.einsum(
            "bjhk,bjhv->bhkv", kscale, vq)
    return y, state


def wkv6_step(r, k, v, w, u, state):
    """Recurrent single step: r, k, w ``[B, H, K]``; v ``[B, H, V]``;
    state ``[B, H, K, V]``."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf,
                     state + u.float()[..., None] * kv)
    return y.to(r.dtype), state * wf[..., None] + kv


def _ln_heads(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """GroupNorm with groups = heads: a LayerNorm over each head's V.
    x ``[B, S, H, V]`` -> ``[B, S, H * V]``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*x.shape[:-2], -1)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _time_mix_inner(params, cfg, x, prev_token, state, *, decode: bool):
    nheads, hd = _dims(cfg)
    heads = (*x.shape[:-1], nheads, hd)
    xr, xk, xv, xw, xg = (_mix(x, prev_token, params[f"mix_{c}"])
                          for c in "rkvwg")
    r = (xr @ at(params["wr"], x.dtype)).reshape(heads)
    k = (xk @ at(params["wk"], x.dtype)).reshape(heads)
    v = (xv @ at(params["wv"], x.dtype)).reshape(heads)
    g = F.silu(xg @ at(params["wg"], x.dtype))
    wexp = params["w0"].float() + (
        torch.tanh(xw @ at(params["wa"], x.dtype))
        @ at(params["wb"], x.dtype)).float()
    w = torch.exp(-torch.exp(wexp)).reshape(heads)
    if decode:
        y, state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                             params["u"], state)
        y = y[:, None]
    else:
        y, state = wkv6_chunked(r, k, v, w, params["u"], state0=state)
    y = _ln_heads(y, params["ln_x_scale"], params["ln_x_bias"],
                  cfg.norm_eps)
    return (y * g) @ at(params["wo"], x.dtype), state


def _channel_mix(params, cfg, x, prev_token):
    xr = _mix(x, prev_token, params["cmix_r"])
    xk = _mix(x, prev_token, params["cmix_k"])
    rgate = torch.sigmoid(xr @ at(params["cwr"], x.dtype))
    h = torch.square(F.relu(xk @ at(params["cwk"], x.dtype)))
    return rgate * (h @ at(params["cwv"], x.dtype))


def rwkv6_time_mix_apply(params, cfg, x, *, return_state: bool = False):
    """Prefill / training path of the time-mix half.  x ``[B, S, d]``."""
    y, state = _time_mix_inner(params, cfg, x, _token_shift(x), None,
                               decode=False)
    return (y, state) if return_state else y


def rwkv6_channel_mix_apply(params, cfg, x):
    return _channel_mix(params, cfg, x, _token_shift(x))


def init_rwkv6_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Params:
    """Per-row decode state: ``wkv`` ``[B, H, K, V]`` f32 (kept in f32
    whatever the compute dtype, as the reference keeps it), the token
    shifts ``tshift`` / ``cshift`` ``[B, 1, d]`` in ``dtype``."""
    nheads, hd = _dims(cfg)
    return {
        "wkv": torch.zeros((batch, nheads, hd, hd), dtype=torch.float32,
                           device=device),
        "tshift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                              device=device),
        "cshift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                              device=device),
    }


def rwkv6_decode_apply(params, cfg, x, cache):
    """x ``[B, 1, d]`` -> (the time-mix output, the new ``wkv`` and
    ``tshift``); the block wrapper takes the channel mix and ``cshift``."""
    y, state = _time_mix_inner(params, cfg, x, cache["tshift"],
                               cache["wkv"], decode=True)
    return y, {**cache, "wkv": state, "tshift": x}


def reference_wkv6(r, k, v, w, u, state0=None):
    """Step-by-step oracle for ``wkv6_chunked`` (tests only)."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    state = (torch.zeros((b, h, kk, vv), dtype=torch.float32,
                         device=r.device) if state0 is None else state0)
    ys = []
    for t in range(s):
        y, state = wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, state)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), state
