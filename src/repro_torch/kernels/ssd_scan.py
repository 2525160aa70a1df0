"""Mamba2 SSD chunk scan: the CUDA kernels' wrapper (B12), their launch
geometry and the plain version.

``ssd_scan`` replaces the TPU kernel of ``repro/kernels/ssd_scan.py``
(``_ssd_kernel``, ``pl.pallas_call`` at :91): x ``[B, S, H, P]`` (f32,
bf16 or f16), logd (= dt * a, at most 0) and dt ``[B, S, H]``, B and C
``[B, S, N]`` shared by all heads; y ``[B, S, H, P]`` in x's dtype, the
``[P, N]`` state of each head carried across chunks in f32 and not
returned.  The kernels are ``csrc/ssd_scan.cu`` (bound by operations, see
the note there): on the tensor-core path (``launch_geometry``'s ``tc``)
C B^T is formed once per batch row and chunk by a first kernel and a
second walks the chunks of each (b, h) with its products in 3xTF32; the
FMA path (``fma``, the previous design) takes what that path does not
(N above 64, rows not in 16-byte vectors).  Launches are counted by path
(``kernel_guard().variants``).  The chunk length is the kernels' own
(``CHUNK``), taken from no caller.  ``ssd_scan_plain`` beside it computes
the same chunked form in plain PyTorch, for CPU tensors and for
comparison on the card; it also returns the final state, as the
reference's oracle ``ref_ssd_scan`` does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "ssd_scan"
#: the kernels' chunk length (``Q`` in csrc/ssd_scan.cu)
CHUNK = 64

#: the dtypes of x, by the code csrc/ssd_scan.cu knows them by
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the paths, by the code csrc/ssd_scan.cu knows them by
PATHS = ("fma", "tc")
THREADS = 256
#: a block's shared memory on the H100
MAX_SMEM = 232_448
#: the tensor-core path: the most state columns N, state rows p a block
TC_MAX_N = 64
TC_ROWS = 64
#: the FMA path's state rows p a block
FMA_ROWS = 32


@dataclass(frozen=True)
class Geometry:
    """One launch of B12.  ``path``: ``tc`` (the C B^T kernel on
    ``cb_grid``, then the walk on ``grid``, each (b, h, ``rows`` state
    rows) in a block, ``stages`` chunk stages in flight) or ``fma`` (one
    kernel, loads synchronous).  ``sub_chunk``: the tile of C B^T, the
    whole chunk."""

    path: str
    grid: tuple[int, int, int]
    threads: int
    chunk: int
    sub_chunk: int
    stages: int
    rows: int
    smem: int
    cb_grid: tuple[int, int] | None

    def blocks(self):
        """Every (b, h, first state row) the walk's blocks own, in launch
        order: each (b, h, slice) once."""
        gx, gh, gb = self.grid
        return [(b, h, x * self.rows) for b in range(gb) for h in range(gh)
                for x in range(gx)]


def tc_smem(elt: int) -> int:
    """Dynamic shared memory of the tensor-core walk, as ``tc::Layout``
    lays it out: two stages of x [64][72], B [64][72], C and G [64][68] and
    logd / dt [2][64]; the state, two buffers [64][68]."""
    stage = 64 * 72 * elt + 64 * 72 * 4 + 2 * 64 * 68 * 4 + 2 * 64 * 4
    return 2 * stage + 2 * 64 * 68 * 4


def fma_smem(n: int) -> int:
    """Dynamic shared memory of the FMA kernel (``fma::smem_bytes``)."""
    ldn = n + 1
    return 4 * (2 * CHUNK * ldn + CHUNK * (CHUNK + 1) + CHUNK * FMA_ROWS
                + FMA_ROWS * ldn + 3 * CHUNK)


def launch_geometry(shape, dtype: torch.dtype, *,
                    aligned: bool = True) -> Geometry:
    """The launch of B12 for ``shape`` = (B, S, H, P, N) and x in
    ``dtype``; ``aligned``: x, B and C start on 16 bytes.  The tensor-core
    path takes N <= 64 (a multiple of 4) and P a multiple of a 16-byte
    vector; any other shape the FMA path, or none (``ValueError``) where
    its tiles do not fit.  Pure: the same arguments give the same
    geometry."""
    b, s, h, p, n = shape
    elt = torch.empty((), dtype=dtype).element_size()
    chunks = -(-s // CHUNK)
    if aligned and n <= TC_MAX_N and n % 4 == 0 and p % (16 // elt) == 0:
        return Geometry(path="tc", grid=(-(-p // TC_ROWS), h, b),
                        threads=THREADS, chunk=CHUNK, sub_chunk=CHUNK,
                        stages=2, rows=TC_ROWS, smem=tc_smem(elt),
                        cb_grid=(chunks, b))
    smem = fma_smem(n)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan takes N up to {TC_MAX_N} on its "
                         f"tensor-core path and while its FMA tiles fit in "
                         f"shared memory; N = {n} needs {smem} bytes")
    return Geometry(path="fma", grid=(-(-p // FMA_ROWS), h, b),
                    threads=THREADS, chunk=CHUNK, sub_chunk=CHUNK, stages=1,
                    rows=FMA_ROWS, smem=smem, cb_grid=None)


def ssd_scan_plain(x: torch.Tensor, logd: torch.Tensor, dt: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor, *,
                   chunk: int = CHUNK,
                   state0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan in f32 over chunks of ``chunk`` positions.
    Returns ``(y [B, S, H, P] in x's dtype, state [B, H, P, N] f32)``.
    The chunk changes the result only by rounding."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    xf, ld, dtf = x.float(), logd.float(), dt.float()
    bf, cf = bmat.float(), cmat.float()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    for s0 in range(0, s, chunk):
        sl = slice(s0, min(s0 + chunk, s))
        q = sl.stop - s0
        csum = torch.cumsum(ld[:, sl], dim=1).transpose(1, 2)   # [B, H, Q]
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        diff = csum[..., :, None] - csum[..., None, :]
        decay = torch.exp(torch.where(tri, diff, -torch.inf))    # [B,H,Q,Q]
        scores = torch.einsum("bin,bjn->bij", cf[:, sl], bf[:, sl])
        xw = xf[:, sl] * dtf[:, sl, :, None]                     # [B,Q,H,P]
        y_intra = torch.einsum("bhij,bjhp->bihp",
                               scores[:, None] * decay, xw)
        y_inter = torch.einsum("bin,bhpn->bihp", cf[:, sl], state) * \
            torch.exp(csum).transpose(1, 2)[..., None]
        y[:, sl] = (y_intra + y_inter).to(x.dtype)
        end = csum[..., -1:]                                     # [B, H, 1]
        dback = torch.exp(end - csum).transpose(1, 2)[..., None]  # [B,Q,H,1]
        state = state * torch.exp(end)[..., None] + torch.einsum(
            "bjhp,bjn->bhpn", xw * dback, bf[:, sl])
    return y, state


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.ssd_scan_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [vp] * 7 + [ci] * 9 + [vp]
        lib.ssd_scan_launch.restype = ci
        lib.ssd_scan_error.argtypes = [ci]
        lib.ssd_scan_error.restype = ctypes.c_char_p
    return lib


def ssd_scan(x: torch.Tensor, logd: torch.Tensor, dt: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """Launch B12.  x ``[B, S, H, P]`` f32, bf16 or f16; logd, dt ``[B, S,
    H]`` and bmat, cmat ``[B, S, N]``, taken as f32 (cast if given
    otherwise).  Returns y in x's dtype.  Runs on PyTorch's current
    stream, never synchronises; raises on anything the kernels do not take
    or on a refused launch: there is no fallback to the plain version."""
    args = (x, logd, dt, bmat, cmat)
    if not all(t.is_cuda for t in args):
        raise RuntimeError(
            "ssd_scan launches a CUDA kernel; its operands are on "
            f"{[str(t.device) for t in args]} (CPU tensors go through "
            "ssd_scan_plain)")
    if any(t.device != x.device for t in args):
        raise ValueError("ssd_scan's operands are on different devices")
    if x.ndim != 4:
        raise ValueError(f"expected x [B, S, H, P], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1] if bmat.ndim == 3 else -1
    if logd.shape != (b, s, h) or dt.shape != (b, s, h) or \
            bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(
            f"expected logd, dt [{b}, {s}, {h}] and bmat, cmat [{b}, {s}, N]; "
            f"got {tuple(logd.shape)}, {tuple(dt.shape)}, "
            f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError("x must be float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    x = x.contiguous()
    logd, dt, bmat, cmat = (t.float().contiguous()
                            for t in (logd, dt, bmat, cmat))
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    geo = launch_geometry((b, s, h, p, n), x.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, bmat, cmat)))
    # scratch for C B^T; PyTorch's allocator hands its memory on only to
    # later work on this stream, so dropping it is safe
    cb = torch.empty((b, geo.cb_grid[0], CHUNK, CHUNK) if geo.cb_grid
                     else (0,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ssd_scan_launch(
            x.data_ptr(), logd.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), cb.data_ptr(), y.data_ptr(), b, s, h, p, n,
            _DTYPES[x.dtype], PATHS.index(geo.path), geo.grid[0], geo.smem,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.ssd_scan_error(code).decode()
        raise RuntimeError(f"ssd_scan launch failed at x {tuple(x.shape)}, "
                           f"N={n}: {msg}")
    kernel_guard().count_launch(KERNEL)
    kernel_guard().count_variant(KERNEL, KERNEL, geo.path)
    return y
