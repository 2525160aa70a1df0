"""RWKV6 WKV recurrence: the CUDA kernel's wrapper (B13) and its plain
version.

``wkv6`` replaces the TPU kernel of ``repro/kernels/wkv6.py``
(``_wkv6_kernel``, ``pl.pallas_call`` at :83): r, k ``[B, S, H, K]``, v
``[B, S, H, V]``, the decay w ``[B, S, H, K]`` in (0, 1) and the bonus u
``[H, K]``; y ``[B, S, H, V]`` in r's dtype, the ``[K, V]`` state of each
head carried across chunks in f32 and not returned.  The kernel is
``csrc/wkv6.cu`` (bound by operations, see the note there); its chunk
length is its own (``CHUNK``).  ``wkv6_plain`` beside it computes the
same chunked form in plain PyTorch, for CPU tensors and for comparison
on the card, and also returns the final state, as the reference's oracle
``ref_wkv6`` does.

Both use a form whose exponents are all at most 0: the decay between
positions j < i of a chunk is ``exp(cum_{i-1} - cum_j)`` per channel.
The Pallas kernel's ``k * exp(-cum)`` overflows f32 once a chunk's summed
log-decay passes about -88 (NaN at its chunk of 64 for w <= 0.2); this
form follows the sequential recurrence at any decay, by design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "wkv6"
#: the kernel's chunk length (``WQ`` in csrc/wkv6.cu)
CHUNK = 32

_DTYPES = (torch.float32, torch.bfloat16)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = CHUNK,
               state0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV6 recurrence in f32 over chunks of ``chunk``
    positions.  Returns ``(y [B, S, H, V] in r's dtype, state [B, H, K,
    V] f32)``.  The chunk changes the result only by rounding."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
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


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.wkv6_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.wkv6_launch.restype = ci
        lib.wkv6_error.argtypes = [ci]
        lib.wkv6_error.restype = ctypes.c_char_p
    return lib


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch B13.  r, k ``[B, S, H, K]`` and v ``[B, S, H, V]`` of one
    dtype, f32 or bf16; w ``[B, S, H, K]`` and u ``[H, K]``, taken as f32
    (cast if given otherwise).  Returns y in r's dtype.  Runs on
    PyTorch's current stream, never synchronises; raises on anything the
    kernel does not take or on a refused launch: there is no fallback to
    the plain version."""
    args = (r, k, v, w, u)
    if not all(t.is_cuda for t in args):
        raise RuntimeError(
            "wkv6 launches a CUDA kernel; its operands are on "
            f"{[str(t.device) for t in args]} (CPU tensors go through "
            "wkv6_plain)")
    if any(t.device != r.device for t in args):
        raise ValueError("wkv6's operands are on different devices")
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected r [B, S, H, K] and v [B, S, H, V]; got "
                         f"{tuple(r.shape)}, {tuple(v.shape)}")
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or \
            v.shape[:3] != (b, s, h) or u.shape != (h, kk):
        raise ValueError(
            f"expected r, k, w [B, S, H, K], v [B, S, H, V] and u [H, K]; "
            f"got {tuple(r.shape)}, {tuple(k.shape)}, {tuple(w.shape)}, "
            f"{tuple(v.shape)}, {tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("r, k, v must share float32 or bfloat16; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w, u = w.float().contiguous(), u.float().contiguous()
    y = torch.empty((b, s, h, vv), dtype=r.dtype, device=r.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(r.device):
        code = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), b, s, h, kk, vv,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.wkv6_error(code).decode()
        raise RuntimeError(f"wkv6 launch failed at r {tuple(r.shape)}, "
                           f"V={vv}: {msg}")
    kernel_guard().count_launch(KERNEL)
    return y
