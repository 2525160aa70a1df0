"""RWKV6 WKV recurrence: the CUDA kernels' wrapper (B13), their launch
geometry and the plain version.

``wkv6`` replaces the TPU kernel of ``repro/kernels/wkv6.py``
(``_wkv6_kernel``, ``pl.pallas_call`` at :83): r, k ``[B, S, H, K]``, v
``[B, S, H, V]`` (f32, bf16 or f16), the decay w ``[B, S, H, K]`` in (0,
1) and the bonus u ``[H, K]``; y ``[B, S, H, V]`` in r's dtype, the ``[K,
V]`` state of each head carried across chunks in f32 and not returned.
The kernels are ``csrc/wkv6.cu`` (bound by bytes, see the note there): on
the tensor-core path (``launch_geometry``'s ``tc``) a block walks the
chunks of (b, h, a slice of V), its decays as running products over
sub-chunks and its products in 3xTF32; the FMA path (``fma``, the
previous design) takes what that path does not (K above 64, rows not in
16-byte vectors).  Launches are counted by path
(``kernel_guard().variants``).  The chunk length is the tensor-core
path's (``CHUNK``).  ``wkv6_plain`` beside it computes the same chunked
form in plain PyTorch (over chunks of ``PLAIN_CHUNK`` unless told
otherwise), for CPU tensors and for comparison on the card, and also
returns the final state, as the reference's oracle ``ref_wkv6`` does.

Both use a form whose exponents are all at most 0: the decay between
positions j < i of a chunk is ``exp(cum_{i-1} - cum_j)`` per channel (the
kernels take it as a product of decays, each at most 1).  The Pallas
kernel's ``k * exp(-cum)`` overflows f32 once a chunk's summed log-decay
passes about -88 (NaN at its chunk of 64 for w <= 0.2); this form follows
the sequential recurrence at any decay, by design.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "wkv6"
#: the tensor-core path's chunk length (``tc::Q`` in csrc/wkv6.cu)
CHUNK = 64
#: its sub-chunk: the diagonal blocks a warp forms with per-pair decays
SUB_CHUNK = 8
#: the FMA path's chunk length (``fma::WQ``)
FMA_CHUNK = 32
#: the plain version's default chunk length
PLAIN_CHUNK = 32

#: the dtypes of r, k, v, by the code csrc/wkv6.cu knows them by
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the paths, by the code csrc/wkv6.cu knows them by
PATHS = ("fma", "tc")
THREADS = 256
#: a block's shared memory on the H100
MAX_SMEM = 232_448
#: the tensor-core path's most channels K
TC_MAX_K = 64
#: the value columns a block, on both paths
SLICE = 32


@dataclass(frozen=True)
class Geometry:
    """One launch of B13, a block per (b, h, ``columns`` value columns).
    ``path``: ``tc`` (chunks of ``chunk`` positions in ``chunk /
    sub_chunk`` sub-chunks, ``stages`` chunk stages in flight) or ``fma``
    (chunks of 32, loads synchronous)."""

    path: str
    grid: tuple[int, int, int]
    threads: int
    chunk: int
    sub_chunk: int
    stages: int
    columns: int
    smem: int

    def blocks(self):
        """Every (b, h, first value column) the blocks own, in launch
        order: each (b, h, slice) once."""
        gx, gh, gb = self.grid
        return [(b, h, x * self.columns) for b in range(gb)
                for h in range(gh) for x in range(gx)]


def tc_smem(elt: int) -> int:
    """Dynamic shared memory of the tensor-core kernel, as ``tc::Layout``
    lays it out: two stages of r and k [64][72], v [64][40] and w [64][64];
    r~, k^ and the pair scores [64][68] f32; the state [2][64][40] f32; the
    decay tables d [28][64], W, P, Q [8][64], T and u [64]."""
    ldv = SLICE + 8
    mat = 64 * 68 * 4
    stage = 2 * 64 * 72 * elt + 64 * ldv * elt + 64 * 64 * 4
    return (2 * stage + 3 * mat + 2 * 64 * ldv * 4 + 28 * 64 * 4
            + 3 * 8 * 64 * 4 + 2 * 64 * 4)


def fma_smem(k: int) -> int:
    """Dynamic shared memory of the FMA kernel (``fma::smem_bytes``)."""
    q, vs = FMA_CHUNK, SLICE
    return 4 * (3 * q * (k + 1) + q * vs + q * (q + 1) + k * vs + k)


def launch_geometry(shape, dtype: torch.dtype, *,
                    aligned: bool = True) -> Geometry:
    """The launch of B13 for ``shape`` = (B, S, H, K, V) and r, k, v in
    ``dtype``; ``aligned``: r, k, v and w start on 16 bytes.  The
    tensor-core path takes K <= 64 with K and V multiples of a 16-byte
    vector; any other shape the FMA path, or none (``ValueError``) where
    its tiles do not fit.  Pure: the same arguments give the same
    geometry."""
    b, s, h, k, v = shape
    elt = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elt
    grid = (-(-v // SLICE), h, b)
    if aligned and k <= TC_MAX_K and k % vec == 0 and v % vec == 0:
        return Geometry(path="tc", grid=grid, threads=THREADS, chunk=CHUNK,
                        sub_chunk=SUB_CHUNK, stages=2, columns=SLICE,
                        smem=tc_smem(elt))
    smem = fma_smem(k)
    if smem > MAX_SMEM:
        raise ValueError(f"wkv6 takes K up to {TC_MAX_K} on its tensor-core "
                         f"path and while its FMA tiles fit in shared "
                         f"memory; K = {k} needs {smem} bytes")
    return Geometry(path="fma", grid=grid, threads=THREADS, chunk=FMA_CHUNK,
                    sub_chunk=FMA_CHUNK, stages=1, columns=SLICE, smem=smem)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = PLAIN_CHUNK,
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
        lib.wkv6_launch.argtypes = [vp] * 6 + [ci] * 9 + [vp]
        lib.wkv6_launch.restype = ci
        lib.wkv6_error.argtypes = [ci]
        lib.wkv6_error.restype = ctypes.c_char_p
    return lib


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch B13.  r, k ``[B, S, H, K]`` and v ``[B, S, H, V]`` of one
    dtype, f32, bf16 or f16; w ``[B, S, H, K]`` and u ``[H, K]``, taken as
    f32 (cast if given otherwise).  Returns y in r's dtype.  Runs on
    PyTorch's current stream, never synchronises; raises on anything the
    kernels do not take or on a refused launch: there is no fallback to
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
        raise TypeError("r, k, v must share float32, bfloat16 or float16; "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w, u = w.float().contiguous(), u.float().contiguous()
    y = torch.empty((b, s, h, vv), dtype=r.dtype, device=r.device)
    if y.numel() == 0:
        return y
    geo = launch_geometry((b, s, h, kk, vv), r.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (r, k, v, w)))
    lib = _lib()
    with torch.cuda.device(r.device):
        code = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), b, s, h, kk, vv, _DTYPES[r.dtype],
            PATHS.index(geo.path), geo.grid[0], geo.smem,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.wkv6_error(code).decode()
        raise RuntimeError(f"wkv6 launch failed at r {tuple(r.shape)}, "
                           f"V={vv}: {msg}")
    kernel_guard().count_launch(KERNEL)
    kernel_guard().count_variant(KERNEL, KERNEL, geo.path)
    return y
