"""The backward contraction forms of matmul-anchored segments: CUDA
kernels B4 (dlhs) and B6 (drhs), their wrappers and plain versions.

``fused_matmul_dlhs_segment`` replaces the TPU kernel of the same name
in ``repro/kernels/fused_matmul_bwd.py`` (``pl.pallas_call`` at :178):

  dx[rows, n] = g[rows, k] @ w[n, k]^T

with ``w`` the FORWARD weight, read in place along its rows (never
transposed in memory), the lhs prologue applied per cotangent element as
it is loaded and the epilogue (the previous layer's activation backward,
lane reductions, lane splits) on the accumulator before one store.
``fused_matmul_drhs_segment`` replaces the kernel at :343:

  dw[rows, n] = x[m, rows]^T @ g[m, n]

with the contraction over the m (token) rows inside one thread block in
a fixed order, both operands read along their contiguous axis, and a
pure elementwise epilogue (the f32 cast of a cast weight's cotangent,
``+ wd * w``-style adds) on the finished tile before its one store.

Both are generated per segment by ``fused_matmul.py``
(``form="dlhs"`` / ``"drhs"``).  At training shapes both are bound by
operations, so a segment whose product is bf16 x bf16 (``sm90_eligible``)
runs on the Hopper mainloop of ``csrc/fused_matmul_sm90.cuh``: wgmma
m64nTNk16 from a ring of shared-memory stages that TMA fills (both
operands K-major for dlhs, MN-major for drhs, read in place), a [128,
TN] tile a CTA (``sm90_tiles``; a dlhs K split only where the grid
would fill less than half the card), operands that TMA refuses (an lhs
prologue, a base or row stride not a multiple of 16 bytes)
register-staged into the same layout.  f32 and f16 segments stay on the
template of ``csrc/fused_matmul.cuh`` (B3's row block, K split and
workspace for dlhs; ``drhs_blocks`` / ``drhs_grid_blocks`` for drhs).
The offload planner's ``Segment.io_bytes`` reads the same helpers.
``batch`` > 1 contracts each batch slice against its own slice of the
weight (dlhs) or of both operands (drhs); no tile straddles a slice.

The plain versions beside the wrappers take the same row blocks,
contract in f32, round the product to its dtype and run the same
epilogue block program op by op in PyTorch.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels.blockprog import BlockProgram, dtype_name, run_program
from repro_torch.kernels.fused_elementwise import (
    _largest_divisor_leq,
    donation_targets,
    role_block,
)

KERNEL_DLHS = "fused_matmul_dlhs_segment"
KERNEL_DRHS = "fused_matmul_drhs_segment"
#: rows of a drhs output tile at most: one register tile of the template
DRHS_ROWS = fm.MT_MAX


# ---------------------------------------------------------------------------
# Geometry shared by the planner and the kernels: the backward forms', and
# B3's on the sm90 mainloop (64 rows a slice or more) and on the weight
# stream (fewer)
# ---------------------------------------------------------------------------

def drhs_blocks(rows: int, n_dim: int, *, vmem_bytes: int,
                batch: int = 1) -> tuple[int, int]:
    """``(pb, nb)``: the drhs output tile.  The lane block is the
    template's 128 columns; the row block is the largest divisor of the
    per-batch rows that fits both one register tile (``DRHS_ROWS``) and
    the accumulator budget (an f32 [pb, nb] tile in ``vmem_bytes``)."""
    nb = min(n_dim, fm.BN)
    per = rows // batch
    limit = max(min(DRHS_ROWS, vmem_bytes // (4 * nb), per), 1)
    return _largest_divisor_leq(per, limit), nb


def drhs_grid_blocks(rows: int, n_dim: int, *, vmem_bytes: int,
                     batch: int = 1) -> tuple[int, int]:
    """``(row_blocks, n_blocks)`` of the drhs grid, per batch slice: the
    activation is read once per lane block and the cotangent once per
    row block."""
    pb, nb = drhs_blocks(rows, n_dim, vmem_bytes=vmem_bytes, batch=batch)
    return (rows // batch) // pb, -(-n_dim // nb)


#: rows of an sm90 CTA tile (two consumer warpgroups of 64) and the K
#: depth of one stage of its ring (``csrc/fused_matmul_sm90.cuh``)
SM90_TM, SM90_BK = 128, 64
#: the fewest stages a dlhs / fwd K split walks: a split doubles the f32
#: workspace traffic, so a short contraction is never cut
SM90_MIN_SPLIT_STAGES = 8
#: rows of a batch slice below which a bf16 fwd segment leaves the sm90
#: mainloop for the weight stream: wgmma's 64-row minimum
SM90_MIN_ROWS = 64
#: the weight stream (``csrc/fused_matmul_stream.cuh``): output columns
#: and rows of a CTA, K depth of one stage of its ring, and the shared
#: memory that holds the rows of x over one K split ([chunk, 8] bf16)
STREAM_TN, STREAM_ROWS, STREAM_BK = 128, 8, 64
STREAM_X_BYTES = 32 * 1024


def sm90_eligible(form: str, lhs_dtype: str, rhs_dtype: str,
                  per_rows: int) -> bool:
    """Whether a segment runs on the Hopper mainloop: bf16 operands on
    both sides of the product (``lhs_dtype`` after the lhs prologue,
    ``rhs_dtype`` after the weight-side cast prologue), in a backward
    form (dlhs, drhs) or in the forward form with at least
    ``SM90_MIN_ROWS`` rows a batch slice (``per_rows``).  Every f32 and
    f16 segment stays on the FMA template."""
    if lhs_dtype != "bfloat16" or rhs_dtype != "bfloat16":
        return False
    return form in ("dlhs", "drhs") or (form == "fwd" and
                                        per_rows >= SM90_MIN_ROWS)


def stream_eligible(form: str, lhs_dtype: str, rhs_dtype: str,
                    per_rows: int) -> bool:
    """Whether a segment runs on the weight stream: a bf16 x bf16 fwd
    segment with fewer rows a batch slice than wgmma takes (decode's 8)."""
    return form == "fwd" and lhs_dtype == rhs_dtype == "bfloat16" and \
        per_rows < SM90_MIN_ROWS


def sm90_tiles(form: str, rows: int, k_dim: int, n_dim: int,
               batch: int = 1, sms: int = 0) -> tuple[int, int, int]:
    """``(tm, tn, splits)`` of an sm90 segment: a [128, tn] output tile
    per CTA (tn 256 where the output is that wide: wgmma m64n256 reads
    half the shared memory per product of m64n128), and, for dlhs and
    fwd, a K split where the grid would fill less than half of the
    ``sms`` SMs — never below ``SM90_MIN_SPLIT_STAGES`` stages a split.
    drhs never splits K (its runs stay bit-equal)."""
    tn = 256 if n_dim >= 256 else 128
    tiles = batch * -(-(rows // batch) // SM90_TM) * -(-n_dim // tn)
    splits = 1
    if form in ("dlhs", "fwd") and 2 * tiles <= sms:
        k_stages = -(-k_dim // SM90_BK)
        want = min(-(-sms // tiles), k_stages // SM90_MIN_SPLIT_STAGES)
        if want > 1:
            splits = -(-k_stages // -(-k_stages // want))
    return SM90_TM, tn, splits


def sm90_grid_blocks(rows: int, n_dim: int, tm: int, tn: int,
                     batch: int = 1) -> tuple[int, int]:
    """``(row_blocks, col_tiles)`` of the sm90 grid, per batch slice:
    the row tiles that share a column tile of B in L2, and the column
    tiles that each re-read A."""
    return -(-(rows // batch) // tm), -(-n_dim // tn)


def stream_blocks(rows: int, k_dim: int, n_dim: int, sms: int,
                  batch: int = 1) -> tuple[int, int]:
    """``(tn, splits)`` of a weight-stream segment: a CTA owns
    ``STREAM_TN`` output columns of ``STREAM_ROWS`` rows of one batch
    slice and one K split.  K is split until the grid holds up to two
    CTAs on each of the ``sms`` SMs (a stream of bytes needs every SM's
    loads in flight; a partial second round of CTAs would leave most SMs
    idle while it runs), and far enough that one split's rows of x fit
    ``STREAM_X_BYTES`` of shared memory."""
    tiles = batch * -(-(rows // batch) // STREAM_ROWS) * \
        -(-n_dim // STREAM_TN)
    k_stages = -(-k_dim // STREAM_BK)
    max_chunk = STREAM_X_BYTES // (2 * STREAM_ROWS * STREAM_BK)
    want = max(2 * sms // tiles, -(-k_stages // max_chunk))
    splits = max(1, min(k_stages, want))
    return STREAM_TN, -(-k_stages // -(-k_stages // splits))


#: shared memory of the sm90 mainloop's stage ring
#: (``csrc/fused_matmul_sm90.cuh``: ``FM90_RING``)
SM90_RING = 192 * 1024


def sm90_smem_bytes(tn: int) -> int:
    """Dynamic shared memory of an sm90 CTA of ``tn`` output columns:
    as many [128 x 64] A + [tn x 64] B bf16 stages as the ring holds,
    a full and an empty mbarrier a stage, and 1,024 bytes to align the
    ring to the 128-byte swizzle's period.  The generated segment
    carries it as ``S::SMEM``, which the launcher sets as the kernel's
    ``cudaFuncAttributeMaxDynamicSharedMemorySize`` and launches with
    (``Fm90Geom<TN>::SMEM`` is asserted equal at compile time); the
    verifier reads the same value."""
    stage = (SM90_TM + tn) * SM90_BK * 2
    stages = SM90_RING // stage
    return stages * stage + 2 * stages * 8 + 1024


def stream_smem_bytes(kch: int) -> int:
    """Dynamic shared memory of a weight-stream CTA whose K split walks
    ``kch`` stages: the ring of four [64 x 128] bf16 weight stages and x's
    ``STREAM_ROWS`` rows over the split in bf16 (``FmsGeom<S>::SMEM``,
    asserted equal; carried as ``S::SMEM`` as ``sm90_smem_bytes``)."""
    return 4 * STREAM_BK * STREAM_TN * 2 + kch * STREAM_BK * STREAM_ROWS * 2


def stream_grid_blocks(rows: int, n_dim: int, batch: int = 1
                       ) -> tuple[int, int]:
    """``(row_blocks, col_tiles)`` of the weight stream's grid, per batch
    slice: the row groups of ``STREAM_ROWS`` that share a column tile of
    the weight in L2, and the column tiles that each re-read x."""
    return -(-(rows // batch) // STREAM_ROWS), -(-n_dim // STREAM_TN)


def dlhs_rhs_spec(n_dim: int, k_dim: int, batch: int = 1) -> tuple:
    """The block view of a dlhs weight: the forward [n, k] rows."""
    return ("bulk_w", batch * n_dim, k_dim)


def drhs_specs(m_dim: int, rows: int, n_dim: int, batch: int = 1
               ) -> tuple[tuple, tuple]:
    """The block views of a drhs activation [m, rows] and cotangent
    [m, n] (per batch slice)."""
    return (("bulk_m", batch * m_dim, rows // batch),
            ("bulk_w", batch * m_dim, n_dim))


# ---------------------------------------------------------------------------
# Code generation (one name per distinct segment, for planner and wrapper)
# ---------------------------------------------------------------------------

_GEN: dict[tuple, dict] = {}


def dlhs_source(pro: BlockProgram | None, epi: BlockProgram, lhs_specs,
                epi_specs, *, lhs_dtypes, rhs_dtype: str, epi_dtypes,
                out_dtypes, rows: int, k_dim: int, n_dim: int,
                acc_dtype: str, rows_block: int, vmem_bytes: int, sms: int,
                batch: int = 1) -> dict:
    """The generated code of a dlhs segment (``fm.segment_source``)."""
    key = ("dlhs", pro and pro.key, epi.key, tuple(map(tuple, lhs_specs)),
           tuple(map(tuple, epi_specs)), tuple(lhs_dtypes), rhs_dtype,
           tuple(epi_dtypes), tuple(out_dtypes), rows, k_dim, n_dim,
           acc_dtype, rows_block, vmem_bytes, sms, batch)
    gen = _GEN.get(key)
    if gen is None:
        gen = _GEN[key] = fm.segment_source(
            pro, None, epi, tuple(map(tuple, lhs_specs)),
            (dlhs_rhs_spec(n_dim, k_dim, batch),),
            tuple(map(tuple, epi_specs)), lhs_dtypes=tuple(lhs_dtypes),
            rhs_dtypes=(rhs_dtype,), epi_dtypes=tuple(epi_dtypes),
            out_dtypes=tuple(out_dtypes), rows=rows, k_dim=k_dim,
            n_dim=n_dim, acc_dtype=acc_dtype, rows_block=rows_block,
            vmem_bytes=vmem_bytes, sms=sms, form="dlhs", batch=batch)
    return gen


def drhs_source(epi: BlockProgram, epi_specs, *, lhs_dtype: str,
                rhs_dtype: str, epi_dtypes, out_dtypes, m_dim: int,
                rows: int, n_dim: int, acc_dtype: str, vmem_bytes: int,
                batch: int = 1) -> dict:
    """The generated code of a drhs segment (``fm.segment_source``)."""
    key = ("drhs", epi.key, tuple(map(tuple, epi_specs)), lhs_dtype,
           rhs_dtype, tuple(epi_dtypes), tuple(out_dtypes), m_dim, rows,
           n_dim, acc_dtype, vmem_bytes, batch)
    gen = _GEN.get(key)
    if gen is None:
        lhs_spec, rhs_spec = drhs_specs(m_dim, rows, n_dim, batch)
        gen = _GEN[key] = fm.segment_source(
            None, None, epi, (lhs_spec,), (rhs_spec,),
            tuple(map(tuple, epi_specs)), lhs_dtypes=(lhs_dtype,),
            rhs_dtypes=(rhs_dtype,), epi_dtypes=tuple(epi_dtypes),
            out_dtypes=tuple(out_dtypes), rows=rows, k_dim=m_dim,
            n_dim=n_dim, acc_dtype=acc_dtype, rows_block=0,
            vmem_bytes=vmem_bytes, sms=0, form="drhs", batch=batch)
    return gen


def _names(ts) -> tuple[str, ...]:
    return tuple(dtype_name(t.dtype) for t in ts)


def _row_major(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError(f"{what} must be row-major: the kernel reads it in "
                         "place and never copies it")
    return t


# ---------------------------------------------------------------------------
# dlhs (B4)
# ---------------------------------------------------------------------------

def fused_matmul_dlhs_segment_plain(
        pro: BlockProgram | None, epi: BlockProgram, lhs_operands,
        lhs_specs, rhs, epi_operands, epi_specs, *, rows: int, k_dim: int,
        n_dim: int, acc_dtype: torch.dtype, out_cols: Sequence[int],
        out_dtypes: Sequence[torch.dtype], rows_block: int,
        vmem_bytes: int, batch: int = 1) -> tuple:
    """The kernel's plain version: per row block, the prologue on the
    cotangent block, ``[rb, k] @ w[n, k]^T`` in f32 against the block's
    batch slice, the product rounded to its dtype, then the epilogue."""
    rb = fm.row_block(rows, epi_specs, n_dim, rows_block, vmem_bytes, batch)
    lhs_full = [fm._full(s, torch.as_tensor(v), rows, k_dim, n_dim)
                for s, v in zip(lhs_specs, lhs_operands)]
    w = torch.as_tensor(rhs).reshape(batch, n_dim, k_dim).float()
    epi_views = [torch.as_tensor(v).reshape(s[1], s[2])
                 for s, v in zip(epi_specs, epi_operands)]
    outs = [torch.empty((rows, c), dtype=dt, device=w.device)
            for c, dt in zip(out_cols, out_dtypes)]
    per = rows // batch
    for i in range(rows // rb):
        blocks = [role_block(s, v, i, rb, rows)
                  for s, v in zip(lhs_specs, lhs_full)]
        g = blocks[0] if pro is None else \
            run_program(pro, blocks, block_rows=rb)[0]
        acc = (g.float() @ w[(i * rb) // per].t()).to(acc_dtype)
        fm._epilogue_blocks(epi, outs, acc, epi_specs, epi_views, i, rb,
                            rows)
    return tuple(outs)


def fused_matmul_dlhs_segment(
        pro: BlockProgram | None, epi: BlockProgram, lhs_operands,
        lhs_specs, rhs, epi_operands, epi_specs, *, rows: int, k_dim: int,
        n_dim: int, acc_dtype: torch.dtype, out_cols: Sequence[int],
        out_dtypes: Sequence[torch.dtype], rows_block: int,
        vmem_bytes: int, sms: int, batch: int = 1,
        donate: Sequence[tuple[int, int]] = ()) -> tuple:
    """Launch B4 on CUDA tensors: ``rhs`` is the forward ``[n, k]``
    weight (``[batch, n, k]``), row-major, read in place; each ``donate``
    pair ``(bi, j)`` writes output ``j`` into epilogue operand ``bi``'s
    buffer.  One call counts as one launch; raises on anything the
    kernel does not take."""
    w = _row_major(torch.as_tensor(rhs), "the dlhs weight")
    gen = dlhs_source(
        pro, epi, lhs_specs, epi_specs, lhs_dtypes=_names(lhs_operands),
        rhs_dtype=dtype_name(w.dtype), epi_dtypes=_names(epi_operands),
        out_dtypes=tuple(dtype_name(d) for d in out_dtypes), rows=rows,
        k_dim=k_dim, n_dim=n_dim, acc_dtype=dtype_name(acc_dtype),
        rows_block=rows_block, vmem_bytes=vmem_bytes, sms=sms, batch=batch)
    views = [v.reshape(s[1], s[2]).contiguous() if s[0] == "param_k"
             else v.contiguous() for v, s in zip(lhs_operands, lhs_specs)]
    targets = donation_targets(epi_operands, donate, rows=rows,
                               out_cols=out_cols, out_dtypes=out_dtypes)
    views += [w] + fm.epilogue_views(epi_operands, epi_specs)
    return fm.launch_segment(KERNEL_DLHS, gen, views, rows=rows,
                             n_dim=n_dim, out_cols=out_cols,
                             out_dtypes=out_dtypes, targets=targets)


# ---------------------------------------------------------------------------
# drhs (B6)
# ---------------------------------------------------------------------------

def fused_matmul_drhs_segment_plain(
        epi: BlockProgram, lhs, rhs, epi_operands, epi_specs, *,
        m_dim: int, rows: int, n_dim: int, acc_dtype: torch.dtype,
        out_cols: Sequence[int], out_dtypes: Sequence[torch.dtype],
        vmem_bytes: int, batch: int = 1) -> tuple:
    """The kernel's plain version: per output row block (inside one
    batch slice), ``x[m, pb]^T @ g[m, n]`` in f32, rounded to the
    product's dtype, then the elementwise epilogue."""
    pb, _ = drhs_blocks(rows, n_dim, vmem_bytes=vmem_bytes, batch=batch)
    per = rows // batch
    x = torch.as_tensor(lhs).reshape(batch, m_dim, per).float()
    g = torch.as_tensor(rhs).reshape(batch, m_dim, n_dim).float()
    epi_views = [torch.as_tensor(v).reshape(s[1], s[2])
                 for s, v in zip(epi_specs, epi_operands)]
    outs = [torch.empty((rows, c), dtype=dt, device=x.device)
            for c, dt in zip(out_cols, out_dtypes)]
    for i in range(rows // pb):
        b, r0 = divmod(i * pb, per)
        acc = (x[b, :, r0:r0 + pb].t() @ g[b]).to(acc_dtype)
        fm._epilogue_blocks(epi, outs, acc, epi_specs, epi_views, i, pb,
                            rows)
    return tuple(outs)


def fused_matmul_drhs_segment(
        epi: BlockProgram, lhs, rhs, epi_operands, epi_specs, *,
        m_dim: int, rows: int, n_dim: int, acc_dtype: torch.dtype,
        out_cols: Sequence[int], out_dtypes: Sequence[torch.dtype],
        vmem_bytes: int, batch: int = 1,
        donate: Sequence[tuple[int, int]] = ()) -> tuple:
    """Launch B6 on CUDA tensors: ``lhs`` is the ``[m, rows]`` activation
    and ``rhs`` the ``[m, n]`` cotangent (``[batch, m, ...]``), both
    row-major and read in place; each ``donate`` pair ``(bi, j)`` writes
    output ``j`` into epilogue operand ``bi``'s buffer.  One call counts
    as one launch."""
    x = _row_major(torch.as_tensor(lhs), "the drhs activation")
    g = _row_major(torch.as_tensor(rhs), "the drhs cotangent")
    gen = drhs_source(
        epi, epi_specs, lhs_dtype=dtype_name(x.dtype),
        rhs_dtype=dtype_name(g.dtype), epi_dtypes=_names(epi_operands),
        out_dtypes=tuple(dtype_name(d) for d in out_dtypes), m_dim=m_dim,
        rows=rows, n_dim=n_dim, acc_dtype=dtype_name(acc_dtype),
        vmem_bytes=vmem_bytes, batch=batch)
    targets = donation_targets(epi_operands, donate, rows=rows,
                               out_cols=out_cols, out_dtypes=out_dtypes)
    views = [x, g] + fm.epilogue_views(epi_operands, epi_specs)
    return fm.launch_segment(KERNEL_DRHS, gen, views, rows=rows,
                             n_dim=n_dim, out_cols=out_cols,
                             out_dtypes=out_dtypes, targets=targets)
