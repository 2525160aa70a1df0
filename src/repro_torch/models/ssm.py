"""Mamba2 block (SSD — state-space duality, chunked matmul form).

The counterpart of ``repro/models/ssm.py``: a scan over chunks carrying
the ``[heads, head_dim, state]`` SSM state, dense products within a
chunk.  x ``[B, S, d]``; inner dim ``d_in = expand * d``; heads ``d_in /
head_dim``; state ``N = cfg.ssm.state_dim``.  B / C projections are
shared by all heads (one group, as in zamba2).

``ssd_chunked`` is the model's own chunked scan in plain PyTorch, as the
reference's model keeps its own apart from the kernel (the same
arithmetic as ``kernels/ssd_scan.py``'s ``ssd_scan_plain``, which serves
the kernel's tests), with the model's chunk, a carried-in state and the
final state.  The model does not launch B12: the reference's model does
not run its Pallas kernel either, and the kernel does not return the
state that prefill hands to decode.  Training differentiates it and the
offload compiler captures it as it stands: the chunk loop unrolled, each
chunk's output written into its slice of ``y``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.layers import (
    Params,
    at,
    dense_init,
    init_rmsnorm,
    rmsnorm_apply,
)


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    return d_in, nheads, s.head_dim, s.state_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> Params:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in, nheads, hd, n = _dims(cfg)
    conv_ch = d_in + 2 * n
    dev = gen.device
    conv_w = torch.randn((s.conv_width, conv_ch), generator=gen, device=dev)
    # in_proj emits [z (gate), x, B, C, dt] = 2*d_in + 2*n + nheads
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * n + nheads, dtype),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=dev)).to(dtype),
        "D": torch.ones((nheads,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full(
            (nheads,), 1e-2, device=dev))).to(dtype),
        "norm": init_rmsnorm(d_in, dev),
        "out_proj": dense_init(gen, d_in, d, dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """``[z, x, B, C, dt]`` from the input projection."""
    d_in, nheads, _, n = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, n, n, nheads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d of width W, then SiLU.  xbc ``[B, S, C]``;
    w ``[W, C]``.  Returns ``(y [B, S, C], new_state [B, W-1, C])``."""
    width = w.shape[0]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[-1]))
    xpad = torch.cat([state, xbc], dim=1)
    s = xbc.shape[1]
    y = sum(xpad[:, i:i + s] * at(w[i], xbc.dtype) for i in range(width))
    y = y + at(b, xbc.dtype)
    return F.silu(y), xpad[:, xpad.shape[1] - (width - 1):]


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                state0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  xh ``[B, S, H, P]``; dt ``[B, S, H]`` (softplus'd
    step sizes, f32); a ``[H]`` (negative decay rates, f32); bmat, cmat
    ``[B, S, N]``; state0 ``[B, H, P, N]``.  Returns ``(y [B, S, H, P] in
    xh's dtype, final state [B, H, P, N] f32)``."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if state0 is None else state0.float())
    xf, ld, dtf = xh.float(), (dt * a).float(), dt.float()
    bf, cf = bmat.float(), cmat.float()
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=xh.device)
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        q = sl.stop - s0
        csum = torch.cumsum(ld[:, sl], dim=1).transpose(1, 2)   # [B, H, Q]
        tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
        diff = csum[..., :, None] - csum[..., None, :]
        decay = torch.exp(torch.where(tri, diff, -torch.inf))    # [B,H,Q,Q]
        scores = torch.einsum("bin,bjn->bij", cf[:, sl], bf[:, sl])
        xw = xf[:, sl] * dtf[:, sl, :, None]                     # [B,Q,H,P]
        y_intra = torch.einsum("bhij,bjhp->bihp",
                               scores[:, None] * decay, xw)
        y_inter = torch.einsum("bin,bhpn->bihp", cf[:, sl], state) * \
            torch.exp(csum).transpose(1, 2)[..., None]
        y[:, sl] = (y_intra + y_inter).to(xh.dtype)
        end = csum[..., -1:]                                     # [B, H, 1]
        dback = torch.exp(end - csum).transpose(1, 2)[..., None]  # [B,Q,H,1]
        state = state * torch.exp(end)[..., None] + torch.einsum(
            "bjhp,bjn->bhpn", xw * dback, bf[:, sl])
    return y, state


def mamba2_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 return_state: bool = False):
    """Training / prefill path.  x ``[B, S, d]`` -> ``[B, S, d]`` (and
    the decode cache ``{"ssm", "conv"}`` when asked)."""
    s_cfg = cfg.ssm or SSMConfig()
    d_in, nheads, hd, n = _dims(cfg)
    zxbcdt = x @ at(params["in_proj"], x.dtype)
    z, xs, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(torch.cat([xs, bmat, cmat], dim=-1),
                                   params["conv_w"], params["conv_b"])
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())
    xh = xs.reshape(*xs.shape[:-1], nheads, hd)
    y, ssm_state = ssd_chunked(xh, dt, a, bmat.float(), cmat.float(),
                               s_cfg.chunk_size)
    y = y + xh * at(params["D"], x.dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:-1], d_in)
    y = rmsnorm_apply(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ at(params["out_proj"], x.dtype)
    if return_state:
        return out, {"ssm": ssm_state, "conv": conv_state}
    return out


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None) -> Params:
    """Per-row decode state: ``ssm`` ``[B, H, P, N]`` f32 (kept in f32
    whatever the compute dtype, as the reference keeps it) and ``conv``
    ``[B, W-1, d_in + 2N]`` in ``dtype``."""
    s = cfg.ssm or SSMConfig()
    d_in, nheads, hd, n = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, nheads, hd, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * n),
                            dtype=dtype, device=device),
    }


def mamba2_decode_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        cache: Params) -> tuple[torch.Tensor, Params]:
    """Single-token recurrent step.  x ``[B, 1, d]``; returns the output
    and the new cache (fresh tensors: the caller decides which rows to
    keep)."""
    d_in, nheads, hd, n = _dims(cfg)
    zxbcdt = x @ at(params["in_proj"], x.dtype)
    z, xs, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(torch.cat([xs, bmat, cmat], dim=-1),
                                   params["conv_w"], params["conv_b"],
                                   cache["conv"])
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]  # [B, H]
    a = -torch.exp(params["A_log"].float())
    xh = xs[:, 0].reshape(-1, nheads, hd).float()
    bm, cm = bmat[:, 0].float(), cmat[:, 0].float()
    state = cache["ssm"] * torch.exp(dt * a)[..., None, None] + \
        torch.einsum("bhp,bn,bh->bhpn", xh, bm, dt)
    y = torch.einsum("bhpn,bn->bhp", state, cm)
    y = y + xh * params["D"].float()[None, :, None]
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = rmsnorm_apply(params["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ at(params["out_proj"], x.dtype), {"ssm": state,
                                                 "conv": conv_state}


def reference_ssd(xh, dt, a, bmat, cmat, state0=None):
    """Step-by-step oracle for ``ssd_chunked`` (tests only)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if state0 is None else state0)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a)
        state = state * da[..., None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", xh[:, t].float(), bmat[:, t], dt[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cmat[:, t]))
    return torch.stack(ys, dim=1).to(xh.dtype), state
