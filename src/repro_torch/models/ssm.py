"""Mamba2 block (SSD — state-space duality, chunked matmul form).

The counterpart of ``repro/models/ssm.py``: a scan over chunks carrying
the ``[heads, head_dim, state]`` SSM state, dense products within a
chunk.  x ``[B, S, d]``; inner dim ``d_in = expand * d``; heads ``d_in /
head_dim``; state ``N = cfg.ssm.state_dim``.  B / C projections are
shared by all heads (one group, as in zamba2).

``ssd_chunked`` is plain PyTorch, as the reference's model has it: the
chunked form that ``kernels/ssd_scan.py`` keeps beside B12
(``ssd_scan_plain``), here with the model's own chunk, a carried-in
state and the final state.  The model does not launch B12: the
reference's model does not run its Pallas kernel either, and the kernel
does not return the state that prefill hands to decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import ssd_scan_plain
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
    return ssd_scan_plain(xh, dt * a, dt, bmat, cmat,
                          chunk=min(chunk, xh.shape[1]), state0=state0)


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
