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

from repro_torch.kernels.adamw_update import (
    adamw_update as _adamw_cuda,
    adamw_update_plain,
)
from repro_torch.kernels.fused_elementwise import (
    fused_segment_grid as _grid_cuda,
    fused_segment_grid_plain,
)
from repro_torch.kernels import fused_matmul as _fm
from repro_torch.kernels import fused_matmul_bwd as _fmb
from repro_torch.kernels.blockprog import BlockProgram
from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_cuda,
    decode_attention_plain,
    paged_decode_attention as _paged_decode_cuda,
    paged_decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.guard import kernel_guard, resolve_impl
from repro_torch.kernels.rmsnorm import RMSNormFn
from repro_torch.kernels.rotary import rotary as _rotary_cuda, rotary_plain
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_cuda, ssd_scan_plain
from repro_torch.kernels.wkv6 import wkv6 as _wkv6_cuda, wkv6_plain

#: every ported kernel, by the name its launch counter goes under
KERNELS = ("paged_decode_attention", "fused_segment_grid",
           "fused_matmul_segment", "fused_matmul_dlhs_segment",
           "fused_matmul_drhs_segment", "adamw_update", "flash_attention",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "rmsnorm",
           "rmsnorm_bwd", "rotary", "decode_attention", "ssd_scan", "wkv6")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *, impl: str = "auto",
                           **kw) -> torch.Tensor:
    """Decode attention over a paged KV pool (block-table indexed): q
    ``[B, NQ, H]``, pools ``[P, NK, page, H]``, tables ``[B, NP]``,
    lengths ``[B]``.  On CUDA tensors B1 refuses, with ``ValueError`` /
    ``TypeError``, where the reference's Pallas kernel takes them: a
    dtype other than f32 or bf16, and a head_dim that is not a
    power-of-two count (at most 32) of 16-byte vectors — f32 takes H in
    {4, 8, ..., 128}, bf16 H in {8, 16, ..., 256}."""
    if resolve_impl(impl, q) == "ref":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, lengths)
    return _paged_decode_cuda(q, k_pages, v_pages, block_tables, lengths,
                              **kw)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     head_major: bool = False, impl: str = "auto"
                     ) -> torch.Tensor:
    """Decode attention over a dense cache: q ``[B, NQ, H]``, caches
    ``[B, T, NK, H]`` or, with ``head_major``, ``[B, NK, T, H]``, each
    read in place; ``lengths [B]``.  A row of length 0 gives zeros.  The
    reference's ``kv_block`` / ``interpret`` arguments shape TPU blocks
    only and are not carried over.  On CUDA tensors B11 refuses what B1
    refuses (see ``paged_decode_attention``): a dtype other than f32 or
    bf16, a head_dim that is not a power-of-two count (at most 32) of
    16-byte vectors, and rows not 16-byte aligned."""
    if resolve_impl(impl, q) == "ref":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      head_major=head_major)
    return _decode_cuda(q, k_cache, v_cache, lengths, head_major=head_major)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis of x ``[..., D]`` (any D) with scale
    ``[D]``, differentiable: B9's forward and, under autograd, its backward
    (``RMSNormFn``).  The reference's ``rows_block`` / ``interpret``
    arguments shape TPU blocks only and are not carried over."""
    return RMSNormFn.apply(x, scale, eps, impl)


def rotary(x: torch.Tensor, positions: torch.Tensor, *,
           theta: float = 10000.0, impl: str = "auto") -> torch.Tensor:
    """Half-split RoPE on x ``[R, N, H]`` at ``positions [R]`` (int32 or
    int64), sin / cos made from ``theta`` in the kernel."""
    if resolve_impl(impl, x) == "ref":
        return rotary_plain(x, positions, theta)
    return _rotary_cuda(x, positions, theta=theta)


def ssd_scan(x: torch.Tensor, logd: torch.Tensor, dt: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *,
             impl: str = "auto") -> torch.Tensor:
    """Mamba2 SSD chunk scan (B12): x ``[B, S, H, P]`` (f32 or bf16),
    logd (= dt * a, at most 0) and dt ``[B, S, H]``, B / C ``[B, S, N]``
    shared by all heads; returns y ``[B, S, H, P]`` in x's dtype (the
    final state is not returned, as the reference's ``ops`` returns y
    only).  Any S.  The reference's ``chunk`` / ``interpret`` arguments
    shape TPU blocks only and are not carried over: B12 picks its chunk
    itself, and the result does not depend on it beyond rounding."""
    if resolve_impl(impl, x) == "ref":
        return ssd_scan_plain(x, logd, dt, bmat, cmat)[0]
    return _ssd_cuda(x, logd, dt, bmat, cmat)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, *, impl: str = "auto"
         ) -> torch.Tensor:
    """RWKV6 WKV recurrence (B13): r, k ``[B, S, H, K]`` and v ``[B, S,
    H, V]`` (f32 or bf16), the decay w ``[B, S, H, K]`` in (0, 1), the
    bonus u ``[H, K]``; returns y ``[B, S, H, V]`` in r's dtype.  Any S.
    Its exponents are all at most 0, so it follows the sequential
    recurrence at any decay, where the reference's Pallas kernel
    overflows below a chunk's summed log-decay of about -88 (by design,
    see ``kernels/wkv6.py``).  The reference's ``chunk`` / ``interpret``
    arguments are not carried over: B13 picks its chunk itself."""
    if resolve_impl(impl, r) == "ref":
        return wkv6_plain(r, k, v, w, u)[0]
    return _wkv6_cuda(r, k, v, w, u)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, return_lse: bool = False,
                    impl: str = "auto"):
    """Flash attention forward: q ``[B, S, NQ, H]``, k / v ``[B, T, NK,
    H]`` (GQA), causal / sliding-window masks, ``scale`` (default
    1/sqrt(H)); returns ``out`` or ``(out, lse)``.  The reference's
    ``q_block`` / ``kv_block`` / ``interpret`` arguments shape TPU blocks
    only and are not carried over (B5 picks its tiles from the shapes).
    On CUDA tensors B5 takes bf16 and f16 at head dims that are multiples
    of 8 from 8 to 256 (the wgmma kernel) and f32 at head dims 16 / 32 /
    64 / 128 (the FMA kernel), and refuses, with ``ValueError`` /
    ``TypeError``, where the reference's Pallas kernel takes them: other
    head dims, more than 64 query heads per kv head, other dtypes;
    ``flash_attention.refusal`` names the reason, and the offload planner
    declines a flash pair by it."""
    kw = dict(causal=causal, window=window, scale=scale,
              return_lse=return_lse)
    if resolve_impl(impl, q) == "ref":
        return flash_attention_plain(q, k, v, **kw)
    return _flash_cuda(q, k, v, **kw)


def fused_flash_segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        batch: int, rows: int, head_dim: int, t_dim: int,
                        n_dim: int, scale: float, out_dtype: torch.dtype,
                        impl: str = "auto") -> tuple:
    """Flash-shaped anchored segment: QK^T -> scale / row-softmax -> PV
    as ONE launch of B5, the [S, T] score matrix never touching device
    memory.  Per batch slice q is ``[S, head_dim]`` (``rows`` spans all
    slices), k ``[t_dim, head_dim]`` and v ``[t_dim, n_dim]`` with
    ``n_dim == head_dim``; one head per slice, no mask, the ``scale``
    the planner extracted from the chain.  Returns ``([rows, n_dim],)``."""
    s_pb = rows // batch
    out = flash_attention(
        q.reshape(batch, s_pb, 1, head_dim),
        k.reshape(batch, t_dim, 1, head_dim),
        v.reshape(batch, t_dim, 1, n_dim), causal=False, window=0,
        scale=scale, impl=impl)
    return (out.reshape(rows, n_dim).to(out_dtype),)


def fused_segment_grid(prog: BlockProgram, operands: Sequence[torch.Tensor],
                       specs: Sequence[tuple], *, rows: int,
                       out_cols: Sequence[int],
                       out_dtypes: Sequence[torch.dtype],
                       rows_block: int = 16,
                       out_strides: Sequence | None = None,
                       impl: str = "auto") -> tuple:
    """Cross-shape elementwise / lane-reduce segment over per-operand
    block views (what the offload runner emits for grid segments).
    ``out_strides`` (per output, ``(shape, strides)`` or None) asks the
    kernel to write an output in that layout and return it so; the plain
    version returns every output as ``[rows, cols]``."""
    if resolve_impl(impl, operands[0]) == "ref":
        return fused_segment_grid_plain(
            prog, operands, specs, rows=rows, out_cols=out_cols,
            out_dtypes=out_dtypes, rows_block=rows_block)
    return _grid_cuda(prog, operands, specs, rows=rows, out_cols=out_cols,
                      out_dtypes=out_dtypes, rows_block=rows_block,
                      out_strides=out_strides)


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
        return adamw_update_plain(p, g, m, v, hyper)
    return _adamw_cuda(p, g, m, v, hyper)


def fused_segment(fn: Callable, bulk: Sequence[torch.Tensor],
                  params: Sequence[torch.Tensor] = (), *,
                  out_dtypes: Sequence[torch.dtype], impl: str = "auto",
                  rows_block: int = 16) -> tuple:
    """Multi-output single-shape segment (the legacy entry point):
    ``fn(*bulk_blocks, *param_blocks)`` over bulk operands of one shape
    [..., C] and [C] / scalar params, lowered onto the grid template
    with ``bulk`` and ``param`` roles.  Always returns a tuple."""
    # the offload compiler imports this package: resolve it at call time
    from repro_torch.core.offload import program_from_fn

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
    kernel_guard().variants.clear()
