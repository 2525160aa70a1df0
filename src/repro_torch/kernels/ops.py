"""Kernel entry points: the dispatch shell of the port.

The counterpart of ``repro/kernels/ops.py`` for the kernels ported so
far.  ``impl`` is ``"auto"`` (the hand-written kernel for a CUDA
tensor, the plain version for a CPU tensor), ``"cuda"`` (the kernel;
raises for a CPU tensor) or ``"ref"`` (the plain PyTorch version, on
whatever device the tensors are — how a kernel is compared with it on
the card).  Nothing here catches a kernel's failure.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.offload import program_from_fn
from repro_torch.kernels import adamw_update as _adamw
from repro_torch.kernels import fused_elementwise as _fe
from repro_torch.kernels import fused_matmul as _fm
from repro_torch.kernels import fused_matmul_bwd as _fmb
from repro_torch.kernels.blockprog import BlockProgram
from repro_torch.kernels.decode_attention import (
    paged_decode_attention as _paged_decode_cuda,
    paged_decode_attention_plain,
)
from repro_torch.kernels.guard import kernel_guard, resolve_impl

#: every ported kernel, by the name its launch counter goes under
KERNELS = ("paged_decode_attention", "fused_segment_grid",
           "fused_matmul_segment", "fused_matmul_dlhs_segment",
           "fused_matmul_drhs_segment", "adamw_update")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, impl: str = "auto",
                           **kw) -> torch.Tensor:
    """Decode attention over a paged KV pool (block-table indexed)."""
    if resolve_impl(impl, q) == "ref":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, lengths)
    return _paged_decode_cuda(q, k_pages, v_pages, block_tables, lengths,
                              **kw)


def fused_segment_grid(prog: BlockProgram, operands: Sequence[torch.Tensor],
                       specs: Sequence[tuple], *, rows: int,
                       out_cols: Sequence[int],
                       out_dtypes: Sequence[torch.dtype],
                       rows_block: int = 16, impl: str = "auto") -> tuple:
    """Cross-shape elementwise / lane-reduce segment over per-operand
    block views (what the offload runner emits for grid segments)."""
    if resolve_impl(impl, operands[0]) == "ref":
        return _fe.fused_segment_grid_plain(
            prog, operands, specs, rows=rows, out_cols=out_cols,
            out_dtypes=out_dtypes, rows_block=rows_block)
    return _fe.fused_segment_grid(prog, operands, specs, rows=rows,
                                  out_cols=out_cols, out_dtypes=out_dtypes,
                                  rows_block=rows_block)


def fused_matmul_segment(pro, rhs_pro, epi, lhs_operands, lhs_specs,
                         rhs_operands, rhs_specs, epi_operands, epi_specs, *,
                         rows: int, k_dim: int, n_dim: int,
                         acc_dtype: torch.dtype, out_cols: Sequence[int],
                         out_dtypes: Sequence[torch.dtype],
                         rows_block: int = 512, vmem_bytes: int, sms: int,
                         batch: int = 1, impl: str = "auto") -> tuple:
    """Matmul-anchored segment: lhs prologue -> [rows, K] @ [K, N] in f32
    -> epilogue on the accumulator (what the runner emits for anchors).
    ``vmem_bytes`` is the accumulator budget and ``sms`` the SM count the
    K split fills, both as the planner priced the segment."""
    args = (pro, rhs_pro, epi, lhs_operands, lhs_specs, rhs_operands,
            rhs_specs, epi_operands, epi_specs)
    kw = dict(rows=rows, k_dim=k_dim, n_dim=n_dim, acc_dtype=acc_dtype,
              out_cols=out_cols, out_dtypes=out_dtypes,
              rows_block=rows_block, vmem_bytes=vmem_bytes, batch=batch)
    if resolve_impl(impl, lhs_operands[0]) == "ref":
        return _fm.fused_matmul_segment_plain(*args, **kw)
    return _fm.fused_matmul_segment(*args, **kw, sms=sms)


def fused_matmul_dlhs_segment(pro, epi, lhs_operands, lhs_specs, rhs,
                              epi_operands, epi_specs, *, rows: int,
                              k_dim: int, n_dim: int,
                              acc_dtype: torch.dtype,
                              out_cols: Sequence[int],
                              out_dtypes: Sequence[torch.dtype],
                              rows_block: int = 512, vmem_bytes: int,
                              sms: int, batch: int = 1,
                              impl: str = "auto") -> tuple:
    """dGRAD_LHS-anchored segment: dx[rows, n] = g[rows, k] @ w[n, k]^T
    with ``rhs`` the forward [n, k] weight, read in place."""
    args = (pro, epi, lhs_operands, lhs_specs, rhs, epi_operands, epi_specs)
    kw = dict(rows=rows, k_dim=k_dim, n_dim=n_dim, acc_dtype=acc_dtype,
              out_cols=out_cols, out_dtypes=out_dtypes,
              rows_block=rows_block, vmem_bytes=vmem_bytes, batch=batch)
    if resolve_impl(impl, lhs_operands[0]) == "ref":
        return _fmb.fused_matmul_dlhs_segment_plain(*args, **kw)
    return _fmb.fused_matmul_dlhs_segment(*args, **kw, sms=sms)


def fused_matmul_drhs_segment(epi, lhs, rhs, epi_operands, epi_specs, *,
                              m_dim: int, rows: int, n_dim: int,
                              acc_dtype: torch.dtype,
                              out_cols: Sequence[int],
                              out_dtypes: Sequence[torch.dtype],
                              vmem_bytes: int, batch: int = 1,
                              impl: str = "auto") -> tuple:
    """dGRAD_RHS-anchored segment: dw[rows, n] = x[m, rows]^T @ g[m, n],
    the m rows reduced inside one block in a fixed order."""
    args = (epi, lhs, rhs, epi_operands, epi_specs)
    kw = dict(m_dim=m_dim, rows=rows, n_dim=n_dim, acc_dtype=acc_dtype,
              out_cols=out_cols, out_dtypes=out_dtypes,
              vmem_bytes=vmem_bytes, batch=batch)
    if resolve_impl(impl, lhs) == "ref":
        return _fmb.fused_matmul_drhs_segment_plain(*args, **kw)
    return _fmb.fused_matmul_drhs_segment(*args, **kw)


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, hyper: torch.Tensor, *,
                 impl: str = "auto") -> tuple:
    """One fused AdamW pass over a leaf: ``(p', m', v')``; ``hyper`` =
    [lr, b1, b2, eps, wd, bc1, bc2] in f32."""
    if resolve_impl(impl, p) == "ref":
        return _adamw.adamw_update_plain(p, g, m, v, hyper)
    return _adamw.adamw_update(p, g, m, v, hyper)


def fused_segment(fn: Callable, bulk: Sequence[torch.Tensor],
                  params: Sequence[torch.Tensor] = (), *,
                  out_dtypes: Sequence[torch.dtype], impl: str = "auto",
                  rows_block: int = 16) -> tuple:
    """Multi-output single-shape segment (the legacy entry point):
    ``fn(*bulk_blocks, *param_blocks)`` over bulk operands of one shape
    [..., C] and [C] / scalar params, lowered onto the grid template
    with ``bulk`` and ``param`` roles.  Always returns a tuple."""
    prog, specs, rows, c = program_from_fn(fn, bulk, params,
                                           len(out_dtypes))
    shape = tuple(bulk[0].shape)
    outs = fused_segment_grid(
        prog, [*bulk, *params], specs, rows=rows,
        out_cols=[prog.ops[o].cols for o in prog.outputs],
        out_dtypes=list(out_dtypes), rows_block=rows_block, impl=impl)
    return tuple(o.reshape(shape) if o.shape[1] == c else o for o in outs)


def fused_elementwise(fn: Callable, bulk: Sequence[torch.Tensor],
                      params: Sequence[torch.Tensor] = (), *,
                      out_dtypes: Sequence[torch.dtype] | None = None,
                      n_outputs: int = 1, impl: str = "auto",
                      rows_block: int = 16):
    """Apply ``fn`` in one pass (the legacy entry point); unwraps a
    single output."""
    if out_dtypes is None:
        out_dtypes = [bulk[0].dtype] * n_outputs
    outs = fused_segment(fn, bulk, params, out_dtypes=out_dtypes,
                         impl=impl, rows_block=rows_block)
    return outs[0] if n_outputs == 1 else outs


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last ``reset_launch_counts``."""
    counts = kernel_guard().launches
    return {k: counts.get(k, 0) for k in KERNELS}


def reset_launch_counts() -> None:
    kernel_guard().launches.clear()
