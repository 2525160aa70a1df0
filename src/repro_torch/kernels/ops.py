"""Kernel entry points: the dispatch shell of the port.

The counterpart of ``repro/kernels/ops.py`` for the kernels ported so
far.  ``impl`` is ``"auto"`` (the hand-written kernel for a CUDA
tensor, the plain version for a CPU tensor), ``"cuda"`` (the kernel;
raises for a CPU tensor) or ``"ref"`` (the plain PyTorch version, on
whatever device the tensors are — how a kernel is compared with it on
the card).  Every call dispatches through the kernel guard
(``KernelGuard.run``, under the reference's kernel names): only an
injected fault (``FaultInjected``) or a quarantine serves a CUDA call by
the plain version; a kernel's real failure propagates.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.adamw_update import (
    adamw_update as _adamw_cuda,
    adamw_update_plain,
)
from repro_torch.kernels.fused_elementwise import (
    donation_targets,
    fused_segment_grid as _grid_cuda,
    fused_segment_grid_plain,
    segment_row_block,
    write_targets,
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

def _dispatch(kernel: str, impl: str, t: torch.Tensor,
              launch: Callable[[], Any], plain: Callable[[], Any]):
    """``launch()`` or ``plain()``, as the guard's chain for ``impl``
    resolved on ``t`` decides."""
    return kernel_guard().run(
        kernel, resolve_impl(impl, t),
        lambda im: plain() if im == "ref" else launch())


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
    lengths ``[B]``; f32, bf16 or f16, as the reference's kernel takes
    them.  On CUDA tensors B1 refuses, with ``ValueError``, where the
    reference's Pallas kernel takes them: a head_dim that is not a
    power-of-two count (at most 32) of 16-byte vectors — f32 takes H in
    {4, 8, ..., 128}, bf16 and f16 H in {8, 16, ..., 256}."""
    return _dispatch(
        "paged_decode_attention", impl, q,
        lambda: _paged_decode_cuda(q, k_pages, v_pages, block_tables,
                                   lengths, **kw),
        lambda: paged_decode_attention_plain(q, k_pages, v_pages,
                                             block_tables, lengths))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     head_major: bool = False, impl: str = "auto"
                     ) -> torch.Tensor:
    """Decode attention over a dense cache: q ``[B, NQ, H]``, caches
    ``[B, T, NK, H]`` or, with ``head_major``, ``[B, NK, T, H]``, each
    read in place; ``lengths [B]``.  A row of length 0 gives zeros.  The
    reference's ``kv_block`` / ``interpret`` arguments shape TPU blocks
    only and are not carried over.  f32, bf16 or f16.  On CUDA tensors
    B11 refuses what B1 refuses (see ``paged_decode_attention``): a
    head_dim that is not a power-of-two count (at most 32) of 16-byte
    vectors, and rows not 16-byte aligned."""
    return _dispatch(
        "decode_attention", impl, q,
        lambda: _decode_cuda(q, k_cache, v_cache, lengths,
                             head_major=head_major),
        lambda: decode_attention_plain(q, k_cache, v_cache, lengths,
                                       head_major=head_major))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis of x ``[..., D]`` (any D) with scale
    ``[D]``, differentiable: B9's forward and, under autograd, its backward
    (``RMSNormFn``).  x and the scale each f32, bf16 or f16, as the
    reference's kernel takes them; f32 math, y and dx in x's dtype, ds in
    the scale's.  The reference's ``rows_block`` / ``interpret`` arguments
    shape TPU blocks only and are not carried over."""
    return RMSNormFn.apply(x, scale, eps, impl)


def rotary(x: torch.Tensor, positions: torch.Tensor, *,
           theta: float = 10000.0, impl: str = "auto") -> torch.Tensor:
    """Half-split RoPE on x ``[R, N, H]`` (f32, bf16 or f16, as the
    reference's kernel takes it) at ``positions [R]`` (int32 or int64),
    sin / cos made from ``theta`` in the kernel; output in x's dtype."""
    return _dispatch("rotary", impl, x,
                     lambda: _rotary_cuda(x, positions, theta=theta),
                     lambda: rotary_plain(x, positions, theta))


def ssd_scan(x: torch.Tensor, logd: torch.Tensor, dt: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *,
             impl: str = "auto") -> torch.Tensor:
    """Mamba2 SSD chunk scan (B12): x ``[B, S, H, P]`` (f32, bf16 or f16,
    as the reference's kernel takes it), logd (= dt * a, at most 0) and
    dt ``[B, S, H]``, B / C ``[B, S, N]`` shared by all heads; returns y
    ``[B, S, H, P]`` in x's dtype (the final state is not returned, as the
    reference's ``ops`` returns y only).  Any S.  The reference's
    ``chunk`` / ``interpret`` arguments shape TPU blocks only and are not
    carried over: B12 picks its chunk itself, and the result does not
    depend on it beyond rounding."""
    return _dispatch("ssd_scan", impl, x,
                     lambda: _ssd_cuda(x, logd, dt, bmat, cmat),
                     lambda: ssd_scan_plain(x, logd, dt, bmat, cmat)[0])


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, *, impl: str = "auto"
         ) -> torch.Tensor:
    """RWKV6 WKV recurrence (B13): r, k ``[B, S, H, K]`` and v ``[B, S,
    H, V]`` (f32, bf16 or f16, as the reference's kernel takes them), the
    decay w ``[B, S, H, K]`` in (0, 1), the bonus u ``[H, K]``; returns y
    ``[B, S, H, V]`` in r's dtype.  Any S.
    Its exponents are all at most 0, so it follows the sequential
    recurrence at any decay, where the reference's Pallas kernel
    overflows below a chunk's summed log-decay of about -88 (by design,
    see ``kernels/wkv6.py``).  The reference's ``chunk`` / ``interpret``
    arguments are not carried over: B13 picks its chunk itself."""
    return _dispatch("wkv6", impl, r, lambda: _wkv6_cuda(r, k, v, w, u),
                     lambda: wkv6_plain(r, k, v, w, u)[0])


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
    return _dispatch("flash_attention", impl, q,
                     lambda: _flash_cuda(q, k, v, **kw),
                     lambda: flash_attention_plain(q, k, v, **kw))


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
    args = (q.reshape(batch, s_pb, 1, head_dim),
            k.reshape(batch, t_dim, 1, head_dim),
            v.reshape(batch, t_dim, 1, n_dim))
    kw = dict(causal=False, window=0, scale=scale)
    out = _dispatch("fused_flash", impl, q,
                    lambda: _flash_cuda(*args, **kw),
                    lambda: flash_attention_plain(*args, **kw))
    return (out.reshape(rows, n_dim).to(out_dtype),)


def _in_place(plain: Callable[[], tuple], operands, donate, **kw
              ) -> Callable[[], tuple]:
    """The plain version of a donating call: computed as it is, then
    each donated output copied into its operand's buffer and returned
    in its place (``write_targets``), as the kernel leaves it.  The
    donations are checked first (``donation_targets``), so that one the
    kernel could not honour raises before anything is written."""
    if not donate:
        return plain

    def in_place():
        targets = donation_targets(operands, donate, **kw)
        return write_targets(plain(), targets)
    return in_place


def fused_segment_grid(prog: BlockProgram, operands: Sequence[torch.Tensor],
                       specs: Sequence[tuple], *, rows: int,
                       out_cols: Sequence[int],
                       out_dtypes: Sequence[torch.dtype],
                       rows_block: int = 16,
                       out_strides: Sequence | None = None,
                       donate: Sequence[tuple[int, int]] = (),
                       impl: str = "auto") -> tuple:
    """Cross-shape elementwise / lane-reduce segment over per-operand
    block views (what the offload runner emits for grid segments).
    ``out_strides`` (per output, ``(shape, strides)`` or None) asks the
    kernel to write an output in that layout and return it so; the plain
    version returns every output as ``[rows, cols]``.  ``donate`` pairs
    ``(operand, output)`` write the output into the operand's buffer (the
    reference's ``input_output_aliases``): the kernel and its plain
    version alike return it there, in ``out_strides``' layout where
    given; a donation the row-block grid's padding drops (as the
    reference's) raises ``ValueError``, as does one whose operand cannot
    hold the output."""
    kw = dict(rows=rows, out_cols=out_cols, out_dtypes=out_dtypes,
              rows_block=rows_block)
    if donate and not segment_row_block(rows, specs, rows_block,
                                        donate=True)[2]:
        raise ValueError(f"donation {tuple(donate)}: row padding of {rows} "
                         "rows drops it (the planner forms none)")
    plain = _in_place(
        lambda: fused_segment_grid_plain(prog, operands, specs, **kw),
        operands, donate, rows=rows, out_cols=out_cols,
        out_dtypes=out_dtypes, out_strides=out_strides)
    return _dispatch(
        "fused_segment_grid", impl, operands[0],
        lambda: _grid_cuda(prog, operands, specs, out_strides=out_strides,
                           donate=donate, **kw),
        plain)


def fused_matmul_segment(pro, rhs_pro, epi, lhs_operands, lhs_specs,
                         rhs_operands, rhs_specs, epi_operands, epi_specs, *,
                         rows: int, k_dim: int, n_dim: int,
                         acc_dtype: torch.dtype, out_cols: Sequence[int],
                         out_dtypes: Sequence[torch.dtype],
                         rows_block: int = 512, vmem_bytes: int, sms: int,
                         batch: int = 1,
                         donate: Sequence[tuple[int, int]] = (),
                         impl: str = "auto") -> tuple:
    """Matmul-anchored segment: lhs prologue -> [rows, K] @ [K, N] in f32
    -> epilogue on the accumulator (what the runner emits for anchors).
    ``vmem_bytes`` is the accumulator budget and ``sms`` the SM count the
    K split fills, both as the planner priced the segment.  ``donate``
    pairs ``(epilogue operand, output)`` write the output into the
    operand's buffer, as ``fused_segment_grid``'s do."""
    args = (pro, rhs_pro, epi, lhs_operands, lhs_specs, rhs_operands,
            rhs_specs, epi_operands, epi_specs)
    kw = dict(rows=rows, k_dim=k_dim, n_dim=n_dim, acc_dtype=acc_dtype,
              out_cols=out_cols, out_dtypes=out_dtypes,
              rows_block=rows_block, vmem_bytes=vmem_bytes, batch=batch)
    plain = _in_place(lambda: _fm.fused_matmul_segment_plain(*args, **kw),
                      epi_operands, donate, rows=rows, out_cols=out_cols,
                      out_dtypes=out_dtypes)
    return _dispatch("fused_matmul", impl, lhs_operands[0],
                     lambda: _fm.fused_matmul_segment(
                         *args, **kw, sms=sms, donate=donate),
                     plain)


def fused_matmul_dlhs_segment(pro, epi, lhs_operands, lhs_specs, rhs,
                              epi_operands, epi_specs, *, rows: int,
                              k_dim: int, n_dim: int,
                              acc_dtype: torch.dtype,
                              out_cols: Sequence[int],
                              out_dtypes: Sequence[torch.dtype],
                              rows_block: int = 512, vmem_bytes: int,
                              sms: int, batch: int = 1,
                              donate: Sequence[tuple[int, int]] = (),
                              impl: str = "auto") -> tuple:
    """dGRAD_LHS-anchored segment: dx[rows, n] = g[rows, k] @ w[n, k]^T
    with ``rhs`` the forward [n, k] weight, read in place; ``donate`` as
    ``fused_matmul_segment``'s."""
    args = (pro, epi, lhs_operands, lhs_specs, rhs, epi_operands, epi_specs)
    kw = dict(rows=rows, k_dim=k_dim, n_dim=n_dim, acc_dtype=acc_dtype,
              out_cols=out_cols, out_dtypes=out_dtypes,
              rows_block=rows_block, vmem_bytes=vmem_bytes, batch=batch)
    plain = _in_place(
        lambda: _fmb.fused_matmul_dlhs_segment_plain(*args, **kw),
        epi_operands, donate, rows=rows, out_cols=out_cols,
        out_dtypes=out_dtypes)
    return _dispatch(
        "fused_matmul_dlhs", impl, lhs_operands[0],
        lambda: _fmb.fused_matmul_dlhs_segment(*args, **kw, sms=sms,
                                               donate=donate),
        plain)


def fused_matmul_drhs_segment(epi, lhs, rhs, epi_operands, epi_specs, *,
                              m_dim: int, rows: int, n_dim: int,
                              acc_dtype: torch.dtype,
                              out_cols: Sequence[int],
                              out_dtypes: Sequence[torch.dtype],
                              vmem_bytes: int, batch: int = 1,
                              donate: Sequence[tuple[int, int]] = (),
                              impl: str = "auto") -> tuple:
    """dGRAD_RHS-anchored segment: dw[rows, n] = x[m, rows]^T @ g[m, n],
    the m rows reduced inside one block in a fixed order; ``donate`` as
    ``fused_matmul_segment``'s."""
    args = (epi, lhs, rhs, epi_operands, epi_specs)
    kw = dict(m_dim=m_dim, rows=rows, n_dim=n_dim, acc_dtype=acc_dtype,
              out_cols=out_cols, out_dtypes=out_dtypes,
              vmem_bytes=vmem_bytes, batch=batch)
    plain = _in_place(
        lambda: _fmb.fused_matmul_drhs_segment_plain(*args, **kw),
        epi_operands, donate, rows=rows, out_cols=out_cols,
        out_dtypes=out_dtypes)
    return _dispatch("fused_matmul_drhs", impl, lhs,
                     lambda: _fmb.fused_matmul_drhs_segment(
                         *args, **kw, donate=donate),
                     plain)


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, hyper: torch.Tensor, *,
                 impl: str = "auto") -> tuple:
    """One fused AdamW pass over a leaf: ``(p', m', v')``; ``hyper`` =
    [lr, b1, b2, eps, wd, bc1, bc2] in f32."""
    return _dispatch("adamw_update", impl, p,
                     lambda: _adamw_cuda(p, g, m, v, hyper),
                     lambda: adamw_update_plain(p, g, m, v, hyper))


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
