"""RMSNorm: the CUDA kernels' wrappers, their launch geometry, their
plain versions and the autograd pairing.

``rmsnorm`` / ``rmsnorm_bwd`` replace the TPU kernels of
``repro/kernels/rmsnorm.py`` (``_fwd_kernel`` via ``_call_fwd`` and
``_bwd_kernel`` via ``_rmsnorm_bwd``); the kernels are
``csrc/rmsnorm.cu`` (bound by bytes, see the note there), launched with
the geometry ``launch_geometry`` computes from the shapes and the card's
SM count.  ``RMSNormFn`` pairs them as the reference's ``custom_vjp``
does: the forward saves ``(x, scale)`` and the backward recomputes the
row statistic.  ``rmsnorm_plain`` / ``rmsnorm_bwd_plain`` repeat the same
arithmetic in plain PyTorch, for CPU tensors and for comparison on the
card; the backward's plain version is the explicit formula, not autograd
of the plain forward.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard, resolve_impl

KERNEL = "rmsnorm"
KERNEL_BWD = "rmsnorm_bwd"

#: the dtypes the kernels take (x, g and the scale, each), by the code
#: csrc/rmsnorm.cu knows them by
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: what the geometry is sized to, from the H100's occupancy rules: a
#: block's dynamic shared memory (227 KB, less 1 KB for the kernels' static
#: arrays) and an SM's (228 KB, 1 KB of it reserved for each resident
#: block)
SMEM_BLOCK = 232_448 - 1024
SMEM_SM = 233_472
#: a margin for a kernel's static shared memory (a few bytes)
STATIC_SMEM = 256
#: the kernels' blocks and the blocks an SM their __launch_bounds__ make
#: room for: the register path 256 threads (forward 2 blocks, backward 1:
#: it holds x and g twice), the staged and direct paths 512 (one block an
#: SM)
REG_THREADS = 256
REG_BLOCKS = {False: 2, True: 1}
WIDE_THREADS = 512
#: the most 16-byte vectors of a row a lane holds on the register path
#: (an f32 backward 4: at 8 its x and g spill), and the most f32 of the
#: scale a thread holds on the staged path
MAX_NV = 8
MAX_NV_F32_BWD = 4
MAX_SCALE_REGS = 32
#: the most vectors a thread of the staged backward holds (its scale and
#: its share of ds in registers; f32 at 8 vectors spills)
MAX_NV_STAGED_BWD = 4
#: the most ring slots of the staged path (more measured no faster)
MAX_STAGES = 4
#: the most blocks that sum the backward's partials at the end
MAX_FINISHERS = 64
#: the direct backward keeps its partial ds row in shared memory up to
#: this many bytes
DIRECT_ACC_SMEM = 160 * 1024

PATHS = ("direct", "registers", "staged")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def staged_smem(d: int, elt: int, stages: int, backward: bool,
                threads: int = WIDE_THREADS) -> int:
    """Dynamic shared memory of a staged launch, as ``Staged::bytes`` in
    csrc/rmsnorm.cu lays it out: the ring's mbarriers, the block
    reduction's 64 floats, the ring (``stages`` one-row slots of x, and of
    g backward); backward, the ring's bytes also hold the block's partial
    ds [D] and a float4 a thread."""
    ring = stages * d * elt * (2 if backward else 1)
    if backward:
        ring = max(ring, 4 * d, 16 * threads)
    return _align(8 * stages, 128) + 256 + ring


def registers_smem(d: int, tpr: int, backward: bool,
                   threads: int = REG_THREADS) -> int:
    """Dynamic shared memory of a register-path launch: the scale [D] f32
    and, backward, each row group's share of ds [threads / tpr, D] f32
    (and at least a float4 a thread for the finishers)."""
    acc = max(4 * (threads // tpr) * d, 16 * threads) if backward else 0
    return 4 * _align(d, 4) + acc


@dataclass(frozen=True)
class Geometry:
    """One launch of B9 or B9-bwd.  ``path``: ``registers`` (narrow rows
    in the registers of ``tpr`` lanes, ``units`` warps a block, ``nv``
    16-byte vectors a lane, and the next rows in a second set of
    registers), ``staged`` (a block a row at a time from a ring of
    ``stages`` one-row slots in shared memory; ``nv`` vectors a thread)
    or ``direct`` (a block a row at a time from device memory, ``vec``
    elements a load).  ``finishers``: the backward's blocks that sum the
    partials."""

    rows: int
    path: str
    threads: int
    tpr: int
    stages: int
    nv: int
    vec: int
    smem: int
    grid: int
    finishers: int
    units: int
    blocks_per_sm: int

    @property
    def rows_per_block(self) -> int:
        """The most rows a block takes."""
        return -(-self.rows // self.grid)

    @property
    def row_groups(self) -> int:
        """Rows a pipeline unit holds at once (32 / tpr on the register
        path, else one)."""
        return 32 // self.tpr if self.path == "registers" else 1

    def unit_rows(self, i: int) -> range:
        """The rows of unit ``i`` (block ``i // units``): an even split,
        as ``split_rows`` in csrc/rmsnorm.cu."""
        parts = self.grid * self.units
        return range(self.rows * i // parts, self.rows * (i + 1) // parts)

    def args(self, backward: bool) -> tuple[int, ...]:
        """The launcher's geometry arguments, in order."""
        return (PATHS.index(self.path), self.threads, self.tpr, self.stages,
                self.nv, self.vec, self.grid,
                *((self.finishers,) if backward else ()), self.smem)


def launch_geometry(rows: int, d: int, dtype: torch.dtype, *,
                    backward: bool, sms: int,
                    aligned: bool = True) -> Geometry:
    """The launch of B9 (``backward=False``) or B9-bwd for ``rows`` rows
    of ``d`` elements of ``dtype`` on a card of ``sms`` SMs.  ``aligned``:
    every row tensor's pointer is 16-byte aligned.  Rows whose pointers and
    length allow 16-byte vectors take the register path (at most 8
    vectors a lane of a warp) or the staged one (the ring fits in shared
    memory, the scale in 32 floats a thread); any other, the direct
    kernels.  Pure: the same arguments give the same geometry."""
    elt = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elt
    vectors = aligned and d % vec == 0
    most = MAX_NV_F32_BWD if backward and elt == 4 else MAX_NV
    geo = None
    if vectors and d // vec <= 32 * most:
        geo = _registers(rows, d, vec, backward, sms)
    elif vectors:
        geo = _staged(rows, d, elt, backward, sms)
    if geo is None:
        geo = _direct(rows, d, backward, sms, vec if vectors else 1)
    return geo


def _finishers(grid: int, d: int) -> int:
    return min(grid, MAX_FINISHERS, max(1, d // 32))


def _registers(rows, d, vec, backward, sms):
    nvec = d // vec
    tpr = min(32, _pow2(nvec))
    nv = _pow2(-(-nvec // tpr))
    units, subs = REG_THREADS // 32, 32 // tpr
    smem = registers_smem(d, tpr, backward)
    bpsm = min(SMEM_SM // (smem + 1024 + STATIC_SMEM), REG_BLOCKS[backward])
    grid = min(bpsm * sms, -(-rows // (units * subs)))
    return Geometry(rows=rows, path="registers", threads=REG_THREADS,
                    tpr=tpr, stages=1, nv=nv, vec=vec, smem=smem, grid=grid,
                    finishers=_finishers(grid, d) if backward else 1,
                    units=units, blocks_per_sm=bpsm)


def _staged(rows, d, elt, backward, sms):
    vec = 16 // elt
    nv = _pow2(-(-(d // vec) // WIDE_THREADS))
    grid = min(rows, sms)
    stages = 0
    while stages < min(MAX_STAGES, -(-rows // grid)) and staged_smem(
            d, elt, stages + 1, backward) <= SMEM_BLOCK:
        stages += 1
    if nv * vec > MAX_SCALE_REGS or stages < 1 or (
            backward and nv > MAX_NV_STAGED_BWD):
        return None
    return Geometry(rows=rows, path="staged", threads=WIDE_THREADS,
                    tpr=WIDE_THREADS, stages=stages, nv=nv, vec=vec,
                    smem=staged_smem(d, elt, stages, backward), grid=grid,
                    finishers=_finishers(grid, d) if backward else 1,
                    units=1, blocks_per_sm=1)


def _direct(rows, d, backward, sms, vec):
    threads = WIDE_THREADS
    if backward:
        grid = min(rows, sms)
        acc = 4 * d if 4 * d <= DIRECT_ACC_SMEM else 0
        smem, fin, bpsm = max(acc, 16 * threads), _finishers(grid, d), 1
    else:
        grid, smem, fin, bpsm = min(rows, 2 * sms), 0, 1, 2
    return Geometry(rows=rows, path="direct", threads=threads, tpr=threads,
                    stages=1, nv=1, vec=vec, smem=smem, grid=grid,
                    finishers=fin, units=1, blocks_per_sm=bpsm)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, ds)``: ``dx = inv * (g*s - xhat * mean(g*s * xhat))`` in x's
    dtype and ``ds = sum_rows(g * xhat)`` summed in f32, in scale's dtype."""
    x2, g2 = _rows(x).float(), _rows(g).float()
    s = scale.float()
    var = (x2 * x2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = x2 * inv
    gs = g2 * s
    dot = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (gs - xhat * dot)).to(x.dtype).reshape(x.shape)
    ds = (g2 * xhat).sum(dim=0).to(scale.dtype)
    return dx, ds


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.rmsnorm_fwd_launch.argtypes is None:
        vp, ci, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_float)
        lib.rmsnorm_fwd_launch.argtypes = [vp, vp, vp, i64, ci, ci, ci,
                                           *[ci] * 8, f, vp]
        lib.rmsnorm_fwd_launch.restype = ci
        lib.rmsnorm_bwd_launch.argtypes = [vp, vp, vp, vp, vp, vp, i64, ci,
                                           ci, ci, *[ci] * 9, f, vp]
        lib.rmsnorm_bwd_launch.restype = ci
        lib.rmsnorm_error.argtypes = [ci]
        lib.rmsnorm_error.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor, name: str) -> None:
    if not (x.is_cuda and scale.is_cuda):
        raise RuntimeError(
            f"{name} launches a CUDA kernel; x is on {x.device}, scale on "
            f"{scale.device} (CPU tensors go through {name}_plain)")
    if x.device != scale.device:
        raise ValueError(f"x is on {x.device}, scale on {scale.device}")
    if x.ndim < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"expected x [..., D] and scale [D]; got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError("x and scale must be float32, bfloat16 or float16; "
                        f"got {x.dtype}, {scale.dtype}")


def _geometry(rows: torch.Tensor, *others: torch.Tensor,
              backward: bool) -> Geometry:
    sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    aligned = all(t.data_ptr() % 16 == 0 for t in (rows, *others))
    return launch_geometry(rows.shape[0], rows.shape[1], rows.dtype,
                           backward=backward, sms=sms, aligned=aligned)


def _raise(lib: ctypes.CDLL, code: int, name: str, shape) -> None:
    if code != 0:
        msg = lib.rmsnorm_error(code).decode()
        raise RuntimeError(f"{name} launch failed at {tuple(shape)}: {msg}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Launch the B9 forward.  x ``[..., D]`` (any leading dims, any row
    count, any D), scale ``[D]``; f32, bf16 or f16 each, f32 math, output
    in x's dtype.  Runs on PyTorch's current stream, never synchronises;
    raises on anything the kernel does not take or on a refused launch."""
    _check(x, scale, KERNEL)
    x2, s = _rows(x).contiguous(), scale.contiguous()
    y = torch.empty_like(x2)
    if x2.numel() == 0:
        return y.reshape(x.shape)
    geo = _geometry(x2, y, backward=False)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.rmsnorm_fwd_launch(
            x2.data_ptr(), s.data_ptr(), y.data_ptr(), x2.shape[0],
            x2.shape[1], _DTYPES[x.dtype], _DTYPES[s.dtype],
            *geo.args(backward=False), eps,
            torch.cuda.current_stream().cuda_stream)
    _raise(lib, code, KERNEL, x.shape)
    kernel_guard().count_launch(KERNEL)
    return y.reshape(x.shape)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the B9 backward: ``(dx, ds)`` for the cotangent ``g`` of
    ``rmsnorm(x, scale)``; dx in x's dtype, ds in scale's.  One launch:
    each block writes an f32 partial ds row, and the last blocks to finish
    sum them in block order (the same bits on every launch).  The blocks'
    arrival ticket is a word of this launch's own workspace, so launches
    may run at once on several streams or graph branches.  Any D, as the
    forward."""
    _check(x, scale, KERNEL_BWD)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("g must have x's shape, dtype and device; got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    x2, g2, s = _rows(x).contiguous(), _rows(g).contiguous(), \
        scale.contiguous()
    dx = torch.empty_like(x2)
    ds = torch.empty_like(s)
    if x2.numel() == 0:
        return dx.reshape(x.shape), ds.zero_()
    geo = _geometry(x2, g2, dx, backward=True)
    # scratch for the blocks' partials and, after them, the launch's
    # arrival ticket (zeroed by the launcher); PyTorch's allocator hands
    # its memory on only to later work on this stream, so dropping it is
    # safe
    part = torch.empty(geo.grid * x2.shape[1] + 1, dtype=torch.float32,
                       device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.rmsnorm_bwd_launch(
            x2.data_ptr(), s.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            ds.data_ptr(), part.data_ptr(), x2.shape[0], x2.shape[1],
            _DTYPES[x.dtype], _DTYPES[s.dtype], *geo.args(backward=True),
            eps,
            torch.cuda.current_stream().cuda_stream)
    _raise(lib, code, KERNEL_BWD, x.shape)
    kernel_guard().count_launch(KERNEL_BWD)
    return dx.reshape(x.shape), ds


class RMSNormFn(torch.autograd.Function):
    """B9 forward, B9 backward; the plain versions for CPU tensors
    (``impl`` resolved as ``ops`` resolves it, each direction dispatched
    through the kernel guard).  The forward saves
    ``(x, scale)``, as the reference's VJP saves ``(x2, scale)``."""

    @staticmethod
    def forward(ctx, x, scale, eps, impl):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.impl = eps, impl
        return kernel_guard().run(
            "rmsnorm", resolve_impl(impl, x),
            lambda im: rmsnorm_plain(x, scale, eps) if im == "ref"
            else rmsnorm(x, scale, eps=eps))

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = kernel_guard().run(
            "rmsnorm_bwd", resolve_impl(ctx.impl, x),
            lambda im: rmsnorm_bwd_plain(x, scale, g, ctx.eps)
            if im == "ref" else rmsnorm_bwd(x, scale, g, eps=ctx.eps))
        return dx, ds, None, None
