"""The instruction offload engine (§IV-B1): the planner, the runner and
the planned backward.

The counterpart of ``repro/core/offload.py``.  The architecture is the
reference's:

  capture once  ``make_fx`` in **fake** tensor mode (no data is touched,
                no in-place write runs) with one fixed decomposition
                table (``repro_torch.core.prims.DECOMPOSITIONS``), so the
                planner sees primitive-level aten ops as a jaxpr would
  plan once     ``plan_offload`` annotates the graph (Algorithm 1,
                ``repro_torch.core.locator``) and segments it into
                maximal near runs over 2-D ``[rows, lanes]`` block views:
                elementwise ops, lane-axis reductions (row statistics),
                lane slices / concats / broadcasts and views that keep
                the 2-D view, and ``mm`` / ``bmm`` anchors in three
                forms — the forward x[M, K] @ w[K, N] (absorbing an
                elementwise lhs prologue, a weight-side dequant prologue
                and the epilogue), ``dlhs`` dx = g @ w^T (the weight a
                transposed view, read in place; lhs prologue and
                epilogue) and ``drhs`` dw = x^T @ g (the activation a
                transposed view; an elementwise epilogue at full width);
                a ``bmm`` whose batch axis leads both operands is the
                same form per batch slice (the views ``torch.einsum``
                writes around it are folded first, the batch axes
                recovered from them), and a batched dlhs QK^T whose
                epilogue is a scale and a row softmax, followed by the
                batched PV product, fuses as ONE flash-shaped segment
                (B5; the [S, T] scores never reach device memory).
                Every candidate is priced and fused or declined by the
                policy (``OffloadPolicy.decide``); both verdicts are
                recorded
  run           the runner walks the graph in order: a fused segment is
                ONE kernel call (``fused_segment_grid`` for elementwise
                segments, ``fused_matmul_segment`` / ``_dlhs_segment`` /
                ``_drhs_segment`` for anchored ones, with ``batch`` for a
                ``bmm``, ``fused_flash_segment`` for the flash pair),
                every other node
                calls its aten op unchanged — in-place KV page writes
                included, so no read moves across a write
  differentiate under autograd the far nodes differentiate as eager
                PyTorch does and each fused segment is a
                ``torch.autograd.Function`` whose backward is the
                segment's cotangent program, captured with
                ``torch.func.vjp`` over the segment's own nodes and
                planned and run through the same planner and runner —
                its recomputed forward anchors ``fwd`` again, its
                gradient contractions ``dlhs`` and ``drhs`` (batched for
                a batched or flash segment, whose backward is planned as
                batched contractions)

``mpu_offload(fn, policy=...)`` caches one plan per (policy, direction,
input signature) in an LRU bounded by the policy's ``max_plans``;
backward plans are cached per segment under "bwd"-tagged keys.

A ``bmm`` whose batch axes were moved into place by a copy (a ``clone``
of a permute, as ``torch.einsum`` writes the model attention's
``bqkgh,bckh->bqkgc``) is declined with that reason: the reference's
``dot_general`` there has batch axes that are not leading, and the
reference never anchors it.

Not planned yet (never formed): segment-boundary donation, the
persistent plan cache and the static plan verifier.
"""
from __future__ import annotations

import dataclasses
import operator
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch
import torch.fx as fx
import torch.utils._pytree as pytree

from repro_torch.core.isa import Loc
from repro_torch.core.locator import GraphAnnotation, annotate_graph, node_val
from repro_torch.core.policy import (
    DecisionReport,
    OffloadPolicy,
    SegmentDecision,
    active_policy_override,
    resolve_policy,
)
from repro_torch.core.prims import (
    DECOMPOSITIONS,
    LAYOUT_PRIMS,
    eqn_tier,
    node_name,
)
from repro_torch.kernels.flash_attention import refusal as flash_refusal
from repro_torch.kernels.blockprog import (
    DTYPES,
    PLACEMENT_KWARGS,
    BlockProgram,
    Input,
    Op,
    _lit,
    dtype_name,
    ew_opcode,
)

#: row-block extents the port's kernels ask the shared helpers for: a
#: program of ``fused_segment_grid`` holds 16 rows (the TPU kernel held
#: 512: a Hopper program keeps its tile in registers and many programs
#: fill the card); a block of ``fused_matmul_segment`` up to 512 rows, as
#: on the TPU, walked in sub-tiles of at most 64
GRID_ROWS_BLOCK = 16
MATMUL_ROWS_BLOCK = 512

# views that move no bytes in PyTorch: free on the far path, and the
# naive accounting does not charge them either
_VIEW_PRIMS = frozenset({"view", "_unsafe_view", "reshape", "squeeze",
                         "unsqueeze", "expand", "select", "slice", "alias",
                         "t", "transpose", "permute"})


# ---------------------------------------------------------------------------
# 2-D block views
# ---------------------------------------------------------------------------

def _bulk_view(shape: Sequence[int]) -> tuple[int, int]:
    """[*, C] -> (prod(leading), C); rank-1 [N] is a column (N, 1)."""
    shape = tuple(shape)
    if len(shape) >= 2:
        r = 1
        for d in shape[:-1]:
            r *= d
        return r, shape[-1]
    if len(shape) == 1:
        return shape[0], 1
    return 1, 1


def _lane(shape: Sequence[int]) -> int:
    return shape[-1] if len(shape) else 1


def _is_param_shape(shape: Sequence[int]) -> bool:
    return all(d == 1 for d in tuple(shape)[:-1])


def _prod(xs) -> int:
    r = 1
    for d in xs:
        r *= d
    return r


def _shape(v) -> tuple[int, ...]:
    val = node_val(v)
    return tuple(int(d) for d in val.shape) if isinstance(
        val, torch.Tensor) else ()


def _dtype(v) -> torch.dtype | None:
    val = node_val(v)
    return val.dtype if isinstance(val, torch.Tensor) else None


def _nbytes(v) -> int:
    val = node_val(v)
    if not isinstance(val, torch.Tensor):
        return 0
    return val.numel() * val.element_size()


def _size(v) -> int:
    val = node_val(v)
    return val.numel() if isinstance(val, torch.Tensor) else 1


def _pad(shape: tuple, n: int) -> tuple:
    return (1,) * (n - len(shape)) + tuple(shape)


@dataclass(frozen=True)
class OperandSpec:
    """How one segment input is blocked by the fused kernel (roles as in
    the reference: ``bulk`` / ``param`` / ``rep`` / ``tile`` / ``bcast``
    for grid and epilogue operands, ``bulk_k`` / ``param_k`` for the lhs
    prologue, ``bulk_w`` / ``param_w`` for the weight prologue)."""

    var: Any
    role: str
    rows: int
    cols: int
    lead: tuple = ()
    out_lead: tuple = ()

    @property
    def meta(self) -> tuple:
        if self.role == "bcast":
            return (self.role, self.rows, self.cols, self.lead,
                    self.out_lead)
        return (self.role, self.rows, self.cols)


@dataclass(frozen=True)
class MatmulAnchor:
    """The ``mm`` / ``bmm`` a matmul-anchored segment is built around: the
    product runs inside the fused kernel, ``pro_eqns`` produce its lhs
    (applied per lhs element as it is loaded), ``rhs_pro_eqns`` its weight
    (applied per weight element; the cast weight is never stored), and
    the segment's ``eqn_idx`` hold the epilogue on the f32 accumulator.

    ``form`` is the contraction as the graph holds it (``mm(lhs, rhs)``,
    lhs [M, K], rhs [K, N]): ``fwd`` (both row-major), ``dlhs`` (rhs is
    the transposed view of a row-major [N, K] weight: dx = g @ w^T) or
    ``drhs`` (lhs is the transposed view of a row-major [K, M]
    activation: dw = x^T @ g; ``k`` is then the contracted token axis).

    A ``bmm`` is the same three forms with a leading batch axis on both
    operands: ``batch`` is its extent (1 for ``mm``), ``batch_shape`` the
    leading axes it folds (recovered from the views around the ``bmm``:
    a [B, H, S, D] einsum gives ``(B, H)``); ``k`` / ``n`` stay per-batch
    extents and ``Segment.rows`` folds the batch into the row axis.

    ``flash`` (a dict) marks a flash-shaped segment: this batched dlhs
    anchor's scaled, row-softmaxed scores feed a second batched product
    with the values, and the whole QK^T -> softmax -> PV chain runs as
    one launch of B5 (the [S, T] scores never reach device memory).
    Keys: ``scale`` (the factor the chain applies to the scores),
    ``t_dim`` (keys per batch slice) and ``consts`` (the scalar constants
    the chain reads, kept as segment operands for its planned backward).
    ``extra_eqns`` hold the absorbed chain and the second product; for a
    flash segment ``k`` is the head dim and ``n`` the value width."""

    eqn_idx: int
    lhs_var: Any
    lhs_specs: list[OperandSpec]
    rhs: Any
    pro_eqns: list[int]
    k: int
    n: int
    out_var: Any
    out_dtype: Any
    form: str = "fwd"
    rhs_specs: list[OperandSpec] = field(default_factory=list)
    rhs_pro_eqns: list[int] = field(default_factory=list)
    extra_eqns: list[int] = field(default_factory=list)
    batch: int = 1
    batch_shape: tuple = ()
    flash: Any = None


@dataclass
class Segment:
    """A maximal near-bank subgraph with per-operand block views."""

    eqn_idx: list[int]
    rows: int
    operand_specs: list[OperandSpec]
    outputs: list[Any]
    out_cols: list[int]
    pre_eqns: list[int]           # hoisted eqns run before the kernel
    post_eqns: list[int]          # escaping views run after the kernel
    span_start: int
    span_end: int
    # the policy's accumulator budget and the machine's SM count: the
    # anchored kernel's row block and K split, as priced and as launched
    smem_budget: int
    sms: int
    l2_bytes: int
    matmul: MatmulAnchor | None = None
    # (kind, cols) of every value the kernel computes: "bulk" rows or a
    # "param" row, cols == 1 for a row statistic
    views: dict = field(default_factory=dict)
    # no lane reduction, slice or concat in the body: an anchored
    # epilogue may run in the GEMM's tile (``fused_matmul.in_tile``)
    elementwise: bool = True

    @property
    def all_eqn_idx(self) -> list[int]:
        if self.matmul is None:
            return sorted({*self.eqn_idx, *self.post_eqns})
        return sorted({*self.matmul.pro_eqns, *self.matmul.rhs_pro_eqns,
                       *self.matmul.extra_eqns, self.matmul.eqn_idx,
                       *self.eqn_idx, *self.post_eqns})

    def io_bytes(self) -> int:
        """Fused HBM bytes this segment moves: one read per operand, one
        write per output and the contraction's re-reads, from the
        kernels' own grid helpers (``fused_matmul.matmul_row_blocks`` /
        ``column_tiles`` for f32 / f16 fwd and dlhs, ``drhs_grid_blocks``
        for f32 / f16 drhs, ``sm90_tiles`` / ``sm90_grid_blocks`` for a
        bf16 segment on the Hopper mainloop, ``stream_blocks`` /
        ``stream_grid_blocks`` for a bf16 fwd segment of fewer than 64
        rows a slice on the weight stream) through ``operand_streams`` (the
        H100's L2 serves the re-reads of blocks that run side by side);
        a batched weight re-streams once per per-batch row block.  fwd /
        dlhs add the f32 workspace, written and read once per K split,
        unless the epilogue runs in the tile.  A flash segment reads q
        once and k and v once per q tile (``flash_attention.q_blocks`` of
        its head dim and dtype, from B5's ``tile_rows``), and its [S, T]
        scores contribute zero bytes.  Planner and kernels
        share the helpers."""
        from repro_torch.kernels import fused_matmul as fm
        from repro_torch.kernels import fused_matmul_bwd as fmb
        from repro_torch.kernels.flash_attention import q_blocks

        total = sum(_nbytes(sp.var) for sp in self.operand_specs)
        total += sum(_nbytes(v) for v in self.outputs)
        mm = self.matmul
        if mm is None:
            return total
        lhs_b = sum(_nbytes(sp.var) for sp in mm.lhs_specs)
        rhs_b = sum(_nbytes(sp.var) for sp in mm.rhs_specs)
        if mm.flash is not None:
            return total + lhs_b + rhs_b * q_blocks(
                self.rows // mm.batch, 1, mm.k, _dtype(mm.lhs_var))
        metas = [sp.meta for sp in self.operand_specs]
        workspace = 0
        ks = 0
        cts = (mm.form, dtype_name(_dtype(mm.lhs_var)),
               dtype_name(_dtype(mm.rhs)), self.rows // mm.batch)
        if fmb.sm90_eligible(*cts):
            tm, tn, ks = fmb.sm90_tiles(mm.form, self.rows, mm.k, mm.n,
                                        mm.batch, self.sms)
            row_blocks, col_tiles = fmb.sm90_grid_blocks(
                self.rows, mm.n, tm, tn, mm.batch)
        elif fmb.stream_eligible(*cts):
            _, ks = fmb.stream_blocks(self.rows, mm.k, mm.n, self.sms,
                                      mm.batch)
            row_blocks, col_tiles = fmb.stream_grid_blocks(
                self.rows, mm.n, mm.batch)
        elif mm.form == "drhs":
            row_blocks, col_tiles = fmb.drhs_grid_blocks(
                self.rows, mm.n, vmem_bytes=self.smem_budget,
                batch=mm.batch)
        else:
            row_blocks = fm.matmul_row_blocks(
                self.rows, metas, min(mm.n, fm.BN), MATMUL_ROWS_BLOCK,
                self.smem_budget, mm.batch)
            col_tiles = fm.column_tiles(mm.n)
            workspace = fm.workspace_bytes(
                self.rows, metas, mm.k, mm.n, rows_block=MATMUL_ROWS_BLOCK,
                vmem_bytes=self.smem_budget, sms=self.sms,
                elt=_dtype(mm.rhs_specs[0].var).itemsize,
                elementwise=self.elementwise, out_cols=self.out_cols,
                batch=mm.batch)
        if ks and not fm.in_tile(ks, self.elementwise, self.out_cols, mm.n):
            workspace = 4 * self.rows * mm.n * ks
        lhs_n, rhs_n = fm.operand_streams(lhs_b, row_blocks, col_tiles,
                                          l2_bytes=self.l2_bytes,
                                          sms=self.sms)
        return total + lhs_b * lhs_n + rhs_b * rhs_n + 2 * workspace


@dataclass
class OffloadPlan:
    annotation: GraphAnnotation
    segments: list[Segment]
    naive_hbm_bytes: int
    fused_hbm_bytes: int
    decisions: list[SegmentDecision] = field(default_factory=list)
    policy: OffloadPolicy | None = None
    # symbols of the plan's anchored segments: one CUDA translation unit
    library: list[str] = field(default_factory=list)

    def report(self) -> DecisionReport:
        return DecisionReport(policy=self.policy or OffloadPolicy(),
                              decisions=list(self.decisions),
                              naive_bytes=self.naive_hbm_bytes,
                              fused_bytes=self.fused_hbm_bytes)

    @property
    def traffic_reduction(self) -> float:
        return self.naive_hbm_bytes / max(self.fused_hbm_bytes, 1)

    @property
    def eqns(self) -> list:
        """The graph's call nodes, which segment indices point into."""
        return [n for n in self.annotation.graph.nodes
                if n.op == "call_function"]


@dataclass
class OffloadStats:
    """Plan-cache counters of one wrapper: ``traces`` counts graph
    captures (one per plan miss); ``capture_s`` and ``plan_s`` are the
    host seconds spent capturing and planning (runner build included)."""

    plan_hits: int = 0
    plan_misses: int = 0
    traces: int = 0
    evictions: int = 0
    capture_s: float = 0.0
    plan_s: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    @property
    def hit_rate(self) -> float:
        total = self.plan_hits + self.plan_misses
        return self.plan_hits / total if total else 0.0

    def as_dict(self) -> dict[str, float]:
        return {**dataclasses.asdict(self), "hit_rate": self.hit_rate}


def _eqn_io_bytes(node) -> int:
    """One node's naive round trip: every operand read, every output
    written (views move nothing)."""
    if node_name(node) in _VIEW_PRIMS:
        return 0
    return sum(_nbytes(v) for v in {*node.all_input_nodes, node})


def _far_decision_bytes(eqns: Sequence, idxs: Sequence[int]) -> int:
    """The far side of the cost decision: what these ops stream unfused.
    Views are free (a value read through a view streams its source),
    and an operand read twice by one op streams once."""
    folded: dict[Any, int] = {}

    def read_bytes(v) -> int:
        return folded.get(v, _nbytes(v))

    total = 0
    for j in idxs:
        node = eqns[j]
        if node_name(node) in _VIEW_PRIMS:
            folded[node] = sum(read_bytes(v) for v in node.all_input_nodes)
            continue
        for v in {*node.all_input_nodes, node}:
            total += read_bytes(v)
    return total


def _classify_operand(shape: tuple, out_shape: tuple, rows: int
                      ) -> tuple | None:
    """Block view of an operand (padded to the output's rank) against
    its op's output; the reference's rules."""
    if shape == out_shape:
        r, c = _bulk_view(shape)
        return ("bulk", r, c)
    n = len(out_shape)
    if len(shape) == n and n >= 1:
        if any(d not in (1, od) for d, od in zip(shape, out_shape)):
            return None
        lead = shape[:-1]
        if all(d == 1 for d in lead):
            return ("param", 1, shape[-1])
        r_op = _prod(lead)
        cols = shape[-1]
        if r_op == rows:
            return ("bulk", rows, cols)
        k = len(lead)
        while k > 0 and lead[k - 1] == 1:
            k -= 1
        if lead[:k] == out_shape[:k]:
            return ("rep", r_op, cols)
        j = 0
        while j < len(lead) and lead[j] == 1:
            j += 1
        if lead[j:] == out_shape[j:n - 1]:
            return ("tile", r_op, cols)
        return ("bcast", r_op, cols, tuple(lead), tuple(out_shape[:-1]))
    if _is_param_shape(shape):
        return ("param", 1, _lane(shape))
    return None


def _same_view_src(node) -> Any | None:
    """For a layout node that keeps its operand's 2-D view (a view, a
    size-1 select, a full-range slice, a no-op expand), that operand."""
    name = node_name(node)
    if name not in LAYOUT_PRIMS:
        return None
    src = node.args[0] if node.args else None
    if not isinstance(src, fx.Node):
        return None
    ishape, oshape = _shape(src), _shape(node)
    if name == "select":
        dim = node.args[1] % max(len(ishape), 1)
        if ishape[dim] != 1:
            return None
    elif name == "slice":
        dim = node.args[1] % len(ishape) if len(node.args) > 1 else 0
        start = node.args[2] if len(node.args) > 2 else 0
        end = node.args[3] if len(node.args) > 3 else None
        step = node.args[4] if len(node.args) > 4 else 1
        if not ((start in (0, None)) and (end is None or end >= ishape[dim])
                and step == 1):
            return None
    elif name == "expand":
        if ishape != oshape:
            return None
    elif name == "cat":
        return None
    if _bulk_view(ishape) != _bulk_view(oshape):
        return None
    return src


def _supported_dtype(v) -> bool:
    dt = _dtype(v)
    return dt is None or dtype_name(dt) in DTYPES


def _row_major(v) -> bool:
    val = node_val(v)
    return isinstance(val, torch.Tensor) and val.is_contiguous()


def _transposed_row_major(v) -> bool:
    """The transposed view (last two axes) of a row-major matrix or batch
    of matrices."""
    val = node_val(v)
    return isinstance(val, torch.Tensor) and val.dim() in (2, 3) and \
        val.transpose(-1, -2).is_contiguous()


def mm_form(node) -> str | None:
    """The contraction form of an ``mm`` / ``bmm`` node from its operands'
    strides (``fwd`` / ``dlhs`` / ``drhs``; a ``bmm``'s batch axis leads
    both operands), or None when an operand is neither row-major nor the
    transposed view of a row-major tensor."""
    lhs, rhs = node.args[0], node.args[1]
    if not isinstance(lhs, fx.Node) or not isinstance(rhs, fx.Node):
        return None
    if _row_major(lhs) and _row_major(rhs):
        return "fwd"
    if _row_major(lhs) and _transposed_row_major(rhs):
        return "dlhs"
    if _transposed_row_major(lhs) and _row_major(rhs):
        return "drhs"
    return None


# ---------------------------------------------------------------------------
# The views around a batched contraction
# ---------------------------------------------------------------------------

# ops that only re-describe a tensor's memory (no data moves, no offset)
_VIEW_STEPS = frozenset({"view", "_unsafe_view", "reshape", "unsqueeze",
                         "squeeze", "permute", "alias", "expand",
                         "transpose", "t"})


def _view_step(node) -> bool:
    """A view node whose operand is a graph value: ``expand`` only when it
    broadcasts nothing."""
    name = node_name(node) if isinstance(node, fx.Node) else None
    if name not in _VIEW_STEPS or not node.args or \
            not isinstance(node.args[0], fx.Node):
        return False
    return name != "expand" or _shape(node) == _shape(node.args[0])


def _view_root(v):
    """Follow view steps back from ``v`` to the first value that is not a
    view."""
    while _view_step(v):
        v = v.args[0]
    return v


def _moved_by_copy(v, batch: int) -> bool:
    """Whether a ``bmm`` operand's ``batch`` axes were moved into place by
    a copy: ``v`` is a view of a ``clone`` whose source holds the axes
    that make up the batch (its leading ones) at smaller strides than an
    axis behind them — how ``torch.einsum`` brings non-leading batch axes
    to the front (the model attention's ``bqkgh,bckh->bqkgc``).  The
    contraction a jaxpr holds there has batch axes that are not leading;
    the reference never anchors it.  Broadcast (stride-0) axes move
    nothing."""
    root = _view_root(v)
    if node_name(root) != "clone" or not isinstance(root.args[0], fx.Node):
        return False
    src = node_val(root.args[0])
    j, extent = 0, 1
    while extent < batch and j < src.dim():
        extent *= src.shape[j]
        j += 1
    if extent != batch:
        return False
    live = [(d > 1 and st > 0, st) for d, st in zip(src.shape, src.stride())]
    lead = [st for ok, st in live[:j] if ok]
    rest = [st for ok, st in live[j:] if ok]
    return bool(lead and rest) and min(lead) < max(rest)


def _batch_shape(node) -> tuple:
    """The leading axes a ``bmm``'s batch axis folds, recovered from a
    view of its product or of its lhs' source ([B, H, S, D] -> (B, H)),
    else ``(batch,)``."""
    b, m, n = _shape(node)
    cands = [(_shape(u), (m, n)) for u in node.users if _view_step(u)]
    cands.append((_shape(_view_root(node.args[0])), _shape(node.args[0])[1:]))
    for shape, tail in cands:
        if len(shape) >= 3 and shape[-2:] == tuple(tail) and \
                _prod(shape[:-2]) == b:
            return tuple(shape[:-2])
    return (b,)


def _contiguous(v) -> bool:
    val = node_val(v)
    return isinstance(val, torch.Tensor) and val.is_contiguous()


def _fold_bmm_views(gm: fx.GraphModule) -> None:
    """Collapse the chains of views around each ``bmm`` whose batch axes
    lead (``torch.einsum`` writes ``view -> permute -> view`` where a
    jaxpr holds one ``dot_general``): a contiguous operand reached through
    views of a contiguous value of the same size becomes one ``view`` of
    that value, and the last contiguous view of the product reached
    through single-use views becomes one ``view`` of the product.  Element
    order is the same on both ends, so the values are unchanged; the views
    left without users are removed."""
    aten = torch.ops.aten
    gone: list = []

    def refold(n, root) -> None:
        shape = list(_shape(n))
        chain = []
        u = n.args[0]
        while u is not root:
            chain.append(u)
            u = u.args[0]
        n.target = aten.view.default
        n.args, n.kwargs = (root, shape), {}
        n.meta["val"] = node_val(root).view(shape)
        gone.extend(chain)

    for node in list(gm.graph.nodes):
        if node_name(node) != "bmm" or any(
                _moved_by_copy(a, _shape(node)[0]) for a in node.args[:2]):
            continue
        for a in node.args[:2]:
            if not (_view_step(a) and _contiguous(a)):
                continue
            root, u = None, a
            while _view_step(u):
                u = u.args[0]
                if _contiguous(u) and _size(u) == _size(a):
                    root = u
            if root is not None and root is not a.args[0]:
                refold(a, root)
        last, u = None, node
        while len(u.users) == 1:
            nxt = next(iter(u.users))
            if not _view_step(nxt) or nxt.args[0] is not u:
                break
            u = nxt
            if _contiguous(u) and _size(u) == _size(node):
                last = u
        if last is not None and last.args[0] is not node:
            refold(last, node)
    for n in dict.fromkeys(gone):
        if not n.users:
            gm.graph.erase_node(n)
    if gone:
        gm.graph.lint()
        gm.recompile()


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def plan_offload(gm: fx.GraphModule, *,
                 policy: OffloadPolicy | None = None) -> OffloadPlan:
    """Algorithm-1 annotation + maximal cross-shape segment extraction
    over a captured graph, gated by the policy's decision backend."""
    policy = resolve_policy(policy)
    bulk_threshold = policy.bulk_threshold
    ann = annotate_graph(gm.graph)
    eqns = [n for n in gm.graph.nodes if n.op == "call_function"]

    consumers: dict[Any, list[int]] = {}
    for i, n in enumerate(eqns):
        for v in n.all_input_nodes:
            consumers.setdefault(v, []).append(i)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outvar_set = set(out_node.all_input_nodes)

    segments: list[Segment] = []
    decisions: list[SegmentDecision] = []
    current: list[int] = []
    cur_rows: int | None = None
    n_compute = 0
    specs: dict[Any, tuple] = {}
    produced: dict[Any, tuple[str, int]] = {}
    reduced_vars: set[Any] = set()
    mm: dict[str, Any] | None = None
    hoisted: list[int] = []
    declined_anchors: set[int] = set()
    # small values made from constants alone (rope frequencies from an
    # arange, a scalar tensor): the trace-time constants of a jaxpr
    const_nodes = {n for n in gm.graph.nodes if n.op == "get_attr"}
    for node in eqns:
        tgt = node.target
        if isinstance(node_val(node), torch.Tensor) and \
                _size(node) < bulk_threshold and \
                not (isinstance(tgt, torch._ops.OpOverload)
                     and tgt._schema.is_mutable) and \
                all(v in const_nodes for v in node.all_input_nodes):
            const_nodes.add(node)

    def reset():
        nonlocal current, cur_rows, n_compute, specs, produced, \
            reduced_vars, mm, hoisted
        current, cur_rows, n_compute = [], None, 0
        specs, produced, reduced_vars, mm, hoisted = {}, {}, set(), None, []

    def _merge_spec(new_specs, v, cls) -> bool:
        old = specs.get(v) or new_specs.get(v)
        if old is not None and old != cls:
            return False
        new_specs[v] = cls
        return True

    def _produced_fits(v, oshape, c_out) -> bool:
        """A value the segment made, read by an op with output
        ``oshape``: it must line up row for row (or be a param) and
        have the output's lanes or one lane."""
        kind, cols = produced[v]
        if cols not in (1, c_out):
            return False
        vshape = _pad(_shape(v), len(oshape))
        if v in reduced_vars:
            # a row statistic broadcasts over the lanes only in its
            # keepdim form ([B, S, 1] against [B, S, D]); a rank-reduced
            # [B, S] would broadcast against the trailing dims instead
            return vshape[:-1] == oshape[:-1] and vshape[-1] == 1
        if kind == "param":
            return _is_param_shape(vshape)
        return vshape[:-1] == oshape[:-1] or \
            _prod(vshape[:-1]) == _prod(oshape[:-1]) == cur_rows and \
            len(vshape) == len(oshape)

    def try_admit_elementwise(i, node) -> bool:
        nonlocal cur_rows, n_compute
        if ew_opcode(node.target, node.args, node.kwargs) is None:
            return False
        if not isinstance(node_val(node), torch.Tensor):
            return False
        nonlit = node.all_input_nodes
        if not all(_supported_dtype(v) for v in (*nonlit, node)):
            return False
        continuation = any(v in produced for v in nonlit)
        if ann.eqn_loc[node] not in (Loc.N, Loc.B) and not continuation:
            return False
        if _size(node) < bulk_threshold and not continuation:
            return False
        oshape = _shape(node)

        if mm is not None and mm["form"] == "drhs":
            # a drhs epilogue runs on the finished [pb, 128] tile: pure
            # elementwise ops at the full output width, over full-width,
            # column and param operands only
            if any(v in reduced_vars for v in nonlit):
                return False
            r_out, c_out = _bulk_view(oshape)
            if r_out != cur_rows or c_out != mm["n"]:
                return False
            new_specs = {}
            for v in nonlit:
                if v in produced:
                    if produced[v] != ("bulk", mm["n"]) or \
                            _bulk_view(_shape(v)) != (cur_rows, mm["n"]):
                        return False
                    continue
                cls = _classify_operand(_pad(_shape(v), len(oshape)), oshape,
                                        cur_rows)
                if cls is None or cls[0] not in ("bulk", "param") or \
                        cls[2] not in (1, mm["n"]) or \
                        not _merge_spec(new_specs, v, cls):
                    return False
            specs.update(new_specs)
            produced[node] = ("bulk", c_out)
            current.append(i)
            n_compute += 1
            return True

        if any(v in reduced_vars for v in nonlit) and cur_rows is not None \
                and _prod(oshape) == cur_rows:
            # reduced space: every value is one element per row
            rows = cur_rows
            new_specs: dict[Any, tuple] = {}
            for v in nonlit:
                if v in produced:
                    if produced[v][1] != 1:
                        return False
                    continue
                sz = _size(v)
                if sz == rows:
                    cls = ("bulk", rows, 1)
                elif sz == 1:
                    cls = ("param", 1, 1)
                else:
                    return False
                if not _merge_spec(new_specs, v, cls):
                    return False
            specs.update(new_specs)
            produced[node] = ("bulk", 1)
            reduced_vars.add(node)
            current.append(i)
            n_compute += 1
            return True

        r_out, c_out = _bulk_view(oshape)
        rows = r_out if cur_rows is None else cur_rows
        if r_out != rows:
            return False
        new_specs = {}
        for v in nonlit:
            if v in produced:
                if not _produced_fits(v, oshape, c_out):
                    return False
                continue
            cls = _classify_operand(_pad(_shape(v), len(oshape)), oshape,
                                    rows)
            if cls is None or not _merge_spec(new_specs, v, cls):
                return False
        specs.update(new_specs)
        produced[node] = ("bulk", c_out)
        cur_rows = rows
        current.append(i)
        n_compute += 1
        return True

    def try_admit_reduce(i, node) -> bool:
        """Lane-axis sum / amax: the row statistic completes inside one
        [rows, lanes] block and fuses as a (rows, 1) column."""
        nonlocal cur_rows, n_compute
        if mm is not None and mm["form"] == "drhs":
            return False            # lanes are blocked: no row statistics
        v = node.args[0] if node.args else None
        if not isinstance(v, fx.Node) or v in reduced_vars:
            return False
        vshape = _shape(v)
        if not vshape:
            return False
        dims = node.args[1] if len(node.args) > 1 else None
        if not isinstance(dims, (list, tuple)) or \
                [d % len(vshape) for d in dims] != [len(vshape) - 1]:
            return False
        dt = _dtype(node)
        if dt is None or not dt.is_floating_point or \
                not _supported_dtype(v) or not _supported_dtype(node):
            return False
        if set(node.kwargs) - {"dtype"}:
            return False
        r_op = _prod(vshape[:-1])
        cols = vshape[-1]
        rows = r_op if cur_rows is None else cur_rows
        if r_op != rows:
            return False
        new_specs: dict[Any, tuple] = {}
        if v in produced:
            if produced[v] != ("bulk", cols):
                return False
        else:
            if len(vshape) < 2 or _size(v) < bulk_threshold:
                return False
            if not _merge_spec(new_specs, v, ("bulk", rows, cols)):
                return False
        specs.update(new_specs)
        produced[node] = ("bulk", 1)
        reduced_vars.add(node)
        cur_rows = rows
        current.append(i)
        n_compute += 1
        return True

    def try_admit_layout(i, node) -> bool:
        """Views that keep the 2-D view of a value the segment made, lane
        slices, lane concats and broadcasts."""
        nonlocal cur_rows
        name = node_name(node)
        if not isinstance(node_val(node), torch.Tensor):
            return False
        dt = _dtype(node)
        if not dt.is_floating_point or not _supported_dtype(node):
            return False
        oshape = _shape(node)
        r_out, c_out = _bulk_view(oshape)
        src = _same_view_src(node)
        if src is not None:
            if src not in produced:
                return False          # external views are hoisted instead
            if src in reduced_vars:
                if _prod(oshape) != cur_rows:
                    return False
                produced[node] = ("bulk", 1)
                reduced_vars.add(node)
                current.append(i)
                return True
            kind, cols = produced[src]
            if kind == "param":
                if not _is_param_shape(oshape) or _lane(oshape) != cols:
                    return False
                produced[node] = ("param", cols)
            else:
                if (r_out, c_out) != (cur_rows, cols):
                    return False
                produced[node] = ("bulk", cols)
            current.append(i)
            return True

        if mm is not None and mm["form"] == "drhs":
            return False            # lanes are blocked: no lane remaps
        continuation = any(v in produced for v in node.all_input_nodes)
        if _size(node) < bulk_threshold and not continuation:
            return False
        rows = r_out if cur_rows is None else cur_rows
        if r_out != rows or len(oshape) < 2:
            return False
        new_specs: dict[Any, tuple] = {}

        def external_bulk(v, want_cols=None) -> bool:
            r_in, c_in = _bulk_view(_shape(v))
            if r_in != rows or (want_cols is not None and c_in != want_cols):
                return False
            return _merge_spec(new_specs, v, ("bulk", rows, c_in))

        if name == "slice":
            v = node.args[0]
            ishape = _shape(v)
            dim = node.args[1] % len(ishape)
            step = node.args[4] if len(node.args) > 4 else 1
            if dim != len(ishape) - 1 or len(ishape) != len(oshape) or \
                    step < 1:
                return False
            if v in produced:
                if produced[v][0] != "bulk" or v in reduced_vars:
                    return False
            elif not external_bulk(v):
                return False
        elif name == "cat":
            tensors = node.args[0]
            dim = node.args[1] if len(node.args) > 1 else 0
            if dim % len(oshape) != len(oshape) - 1:
                return False
            for v in tensors:
                if not isinstance(v, fx.Node) or \
                        _shape(v)[:-1] != oshape[:-1]:
                    return False
                if v in produced:
                    if produced[v][0] != "bulk" or v in reduced_vars:
                        return False
                elif not external_bulk(v):
                    return False
        elif name == "expand":
            v = node.args[0]
            ishape = _pad(_shape(v), len(oshape))
            if v in produced:
                if not _produced_fits(v, oshape, c_out):
                    return False
            else:
                cls = _classify_operand(ishape, oshape, rows)
                if cls is None or not _merge_spec(new_specs, v, cls):
                    return False
        else:
            return False
        specs.update(new_specs)
        produced[node] = ("bulk", c_out)
        cur_rows = rows
        current.append(i)
        return True

    def _chain_convertible(anchor_i, var, m_rows, k_dim, roles):
        """Whether the open run can be absorbed as a prologue producing
        ``var`` (the dot's lhs or weight): elementwise ops and 2-D-view
        keeping views only, every value [m_rows, k_dim] (or a param for
        the weight), none escaping.  Returns (pro_eqns, specs)."""
        bulk_role, param_role = roles
        if var not in produced or reduced_vars:
            return None
        cur_set = set(current)
        for j in current:
            e = eqns[j]
            if ew_opcode(e.target, e.args, e.kwargs) is None and \
                    _same_view_src(e) is None:
                return None
            oshape = _shape(e)
            param_view = bulk_role == "bulk_w" and \
                _is_param_shape(oshape) and _lane(oshape) in (1, k_dim[1])
            want = (m_rows, k_dim) if bulk_role == "bulk_k" else k_dim
            if not param_view and _bulk_view(oshape) != want:
                return None
            if param_view and e is var:
                return None
            if e in outvar_set:
                return None
            cons = consumers.get(e, [])
            if any(c not in cur_set and c != anchor_i for c in cons):
                return None              # chain value escapes: keep split
            if e is not var and anchor_i in cons:
                return None              # only the operand may feed the dot
        seen: set[Any] = set()
        out_specs: list[OperandSpec] = []
        r, c = (m_rows, k_dim) if bulk_role == "bulk_k" else k_dim
        for j in current:
            for v in eqns[j].all_input_nodes:
                if v in produced or v in seen:
                    continue
                seen.add(v)
                cls = specs.get(v)
                if cls is None:
                    return None
                if cls[0] == "bulk" and (cls[1], cls[2]) == (r, c):
                    out_specs.append(OperandSpec(v, bulk_role, r, c))
                elif cls[0] == "param" and cls[2] in (1, c):
                    out_specs.append(OperandSpec(v, param_role, 1, cls[2]))
                else:
                    return None
        return list(current), out_specs

    def out_of_slice(node) -> str | None:
        """Why an anchor candidate is declined outright, or None."""
        if node_name(node) == "bmm" and any(
                _moved_by_copy(a, _shape(node)[0]) for a in node.args[:2]):
            return ("batched anchor (bmm): batch axes not leading — a copy "
                    "(clone of a permute) moved them into place; runs "
                    "unfused, as the reference leaves a dot_general with "
                    "non-leading batch axes")
        if mm_form(node) is None:
            return ("strided mm: an operand is neither row-major nor the "
                    "transposed view of a row-major tensor; runs unfused")
        return None

    def try_admit_anchor(i, node) -> bool:
        nonlocal mm, cur_rows, n_compute, current, specs, produced
        if mm is not None:
            return try_admit_flash(i, node)  # one anchor per segment,
            #                                  except the flash pair
        name = node_name(node)
        if name not in ("mm", "bmm") or i in declined_anchors:
            return False
        lhs_v, rhs_v = node.args[0], node.args[1]
        if not isinstance(lhs_v, fx.Node) or not isinstance(rhs_v, fx.Node):
            return False
        dt = _dtype(node)
        if dt is None or not dt.is_floating_point:
            return False
        if any(_dtype(v).itemsize > 4 or not _supported_dtype(v)
               for v in (lhs_v, rhs_v, node)):
            return False
        if _size(node) < bulk_threshold:
            return False
        lshape, rshape, oshape = _shape(lhs_v), _shape(rhs_v), _shape(node)
        batch = oshape[0] if name == "bmm" else 1
        batch_shape = _batch_shape(node) if name == "bmm" else ()
        m_rows, n_cols = batch * oshape[-2], oshape[-1]
        k_dim = lshape[-1]
        if rshape[-2:] != (k_dim, n_cols) or rshape[:-2] != lshape[:-2]:
            return False
        form = mm_form(node)
        if form == "drhs":
            return admit_drhs(i, node, lhs_v, rhs_v, dt, batch, batch_shape)
        rhs_pro_eqns: list[int] = []
        rhs_specs = [OperandSpec(rhs_v, "bulk_w", batch * k_dim, n_cols)]
        if rhs_v in produced:
            # a weight prologue only on the unbatched forward form: the
            # dlhs kernel reads its weight along the rows of the forward
            # tensor, a batched one per batch slice
            if lhs_v in produced or form != "fwd" or batch > 1:
                return False
            conv = _chain_convertible(i, rhs_v, None, (k_dim, n_cols),
                                      ("bulk_w", "param_w"))
            if conv is None:
                return False
            rhs_pro_eqns, rhs_specs = conv
            pro_eqns: list[int] = []
            lhs_specs = [OperandSpec(lhs_v, "bulk_k", m_rows, k_dim)]
            span0, n_pro = current[0], n_compute
        elif current:
            conv = _chain_convertible(i, lhs_v, m_rows, k_dim,
                                      ("bulk_k", "param_k"))
            if conv is None:
                return False
            pro_eqns, lhs_specs = conv
            span0, n_pro = current[0], n_compute
        else:
            pro_eqns = []
            lhs_specs = [OperandSpec(lhs_v, "bulk_k", m_rows, k_dim)]
            span0, n_pro = i, 0
        mm = dict(form=form, eqn_idx=i, lhs_var=lhs_v, lhs_specs=lhs_specs,
                  rhs=rhs_v, rhs_specs=rhs_specs, rhs_pro_eqns=rhs_pro_eqns,
                  pro_eqns=pro_eqns, k=k_dim, n=n_cols, out_var=node,
                  out_dtype=dt, span_start=span0, extra_eqns=[],
                  batch=batch, batch_shape=batch_shape, flash=None,
                  pro_views=dict(produced))
        current, specs = [], {}
        produced = {node: ("bulk", n_cols)}
        cur_rows, n_compute = m_rows, n_pro + _rounding_op(form, dt)
        return True

    def admit_drhs(i, node, lhs_v, rhs_v, dt, batch, batch_shape) -> bool:
        """dw = x^T @ g opens a segment of its own: neither operand may
        come from the open run (a shared cotangent chain is split), and
        the epilogue that follows is elementwise at full width.  Batched,
        each batch slice reduces its own token rows."""
        nonlocal mm, cur_rows, n_compute, current, specs, produced
        if current or lhs_v in produced or rhs_v in produced:
            return False
        rows, m_dim = _shape(lhs_v)[-2:]
        n_cols = _shape(rhs_v)[-1]
        mm = dict(form="drhs", eqn_idx=i, lhs_var=lhs_v,
                  lhs_specs=[OperandSpec(lhs_v, "bulk_m", batch * m_dim,
                                         rows)],
                  rhs=rhs_v,
                  rhs_specs=[OperandSpec(rhs_v, "bulk_w", batch * m_dim,
                                         n_cols)],
                  rhs_pro_eqns=[], pro_eqns=[], k=m_dim, n=n_cols,
                  out_var=node, out_dtype=dt, span_start=i, extra_eqns=[],
                  batch=batch, batch_shape=batch_shape, flash=None,
                  pro_views={})
        current, specs = [], {}
        produced = {node: ("bulk", n_cols)}
        cur_rows, n_compute = batch * rows, _rounding_op("drhs", dt)
        return True

    def scalar_value(v) -> float | None:
        """The value of a scalar the graph computes from constants alone
        (a literal, or a tensor constant and its casts), else None."""
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        if not isinstance(v, fx.Node) or v not in const_nodes or \
                _size(v) != 1:
            return None
        env: dict = {}

        def value(n):
            if n not in env:
                if n.op == "get_attr":
                    env[n] = getattr(gm, n.target)
                else:
                    env[n] = n.target(*fx.map_arg(n.args, value),
                                      **fx.map_arg(n.kwargs, value))
            return env[n]
        return float(value(v).reshape(()).item())

    def try_admit_flash(i, node) -> bool:
        """Second-anchor admission: ride a batched ``dlhs`` anchor whose
        open epilogue is exactly a scalar scale and a row softmax of the
        scores (the capture's ``amax / sub / exp / sum / div``, through
        views that keep the block view) when ``node`` is the batched PV
        product.  The pair fuses as one flash-shaped segment, dispatched
        to B5: the [S, T] scores never reach device memory.  Anything
        else (a mask, other value lanes, a chain value read outside)
        falls back to flush-then-readmit: two ordinary segments.  So
        does a pair whose operands B5 refuses (``flash_attention.refusal``:
        f32 outside head dims 16 / 32 / 64 / 128, 16-bit head dims that
        are not multiples of 8 up to 256, other dtypes), with that reason
        in ``explain()`` — where the reference's Pallas kernel takes any
        head dim."""
        nonlocal mm, cur_rows, current, specs, produced
        if (mm["form"] != "dlhs" or mm["flash"] is not None or
                mm["pro_eqns"] or mm["rhs_pro_eqns"] or
                not mm["batch_shape"] or node_name(node) != "bmm"):
            return False
        if any(scalar_value(v) is None for v in specs):
            return False             # an operand that is not a scale
        lhs_v, rhs_v = node.args[0], node.args[1]
        if lhs_v not in produced or rhs_v in produced or \
                mm_form(node) != "fwd":
            return False
        lshape, rshape, out = _shape(lhs_v), _shape(rhs_v), node
        batch, t_dim = mm["batch"], mm["n"]
        if lshape[0] != batch or lshape[0] * lshape[1] != cur_rows or \
                lshape[2] != t_dim or rshape[:2] != (batch, t_dim):
            return False
        n2 = rshape[2]
        # B5's accumulator and PV tile take a value width equal to the
        # head dim; other widths stay two ordinary anchored segments
        if n2 != mm["k"]:
            return False
        dt = _dtype(out)
        if not dt.is_floating_point or dt.itemsize > 4 or \
                _dtype(rhs_v) != _dtype(mm["lhs_var"]):
            return False

        chain = list(current)
        pos = 0

        def through_views(x):
            nonlocal pos
            while pos < len(chain) and _same_view_src(eqns[chain[pos]]) is x:
                x = eqns[chain[pos]]
                pos += 1
            return x

        def step(op, *args):
            """The next chain node if it is ``op(*args, ...)``."""
            nonlocal pos
            if pos < len(chain):
                e = eqns[chain[pos]]
                if node_name(e) == op and tuple(e.args[:len(args)]) == args:
                    pos += 1
                    return e
            return None

        def row_stat(op, x):
            """The next chain node if it is ``op(x, [last], keepdim)``."""
            e = step(op, x)
            rank = len(_shape(x))
            if e is None or e.kwargs or e.args[2:3] != (True,) or \
                    [d % rank for d in e.args[1]] != [rank - 1]:
                return None
            return e

        x = through_views(mm["out_var"])
        scale = 1.0
        while pos < len(chain):          # leading scalar scale ops
            e = eqns[chain[pos]]
            nm, a = node_name(e), e.args
            if nm not in ("mul", "div") or len(a) != 2 or e.kwargs:
                break
            if a[0] is x:
                sv = scalar_value(a[1])
            elif nm == "mul" and a[1] is x:
                sv = scalar_value(a[0])
            else:
                break
            if sv is None or (nm == "div" and sv == 0.0):
                return False
            scale = scale / sv if nm == "div" else scale * sv
            pos += 1
            x = through_views(e)
        stat = row_stat("amax", x)
        xs = stat and step("sub", x, stat)
        ex = xs and step("exp", xs)
        den = ex and row_stat("sum", ex)
        p = den and step("div", ex, den)
        if p is None or through_views(p) is not lhs_v or pos != len(chain):
            return False                 # not a plain scaled softmax
        chain_set = set(chain)
        for v in [mm["out_var"], *(eqns[j] for j in chain)]:
            if v in outvar_set or any(c not in chain_set and c != i
                                      for c in consumers.get(v, [])):
                return False             # a chain value escapes
        # B5 must take what ops.fused_flash_segment passes it: one head
        # per slice (G = 1), head_dim mm["k"], the operands' dtype
        why = flash_refusal(mm["k"], _dtype(mm["lhs_var"]))
        if why is None and _dtype(mm["rhs"]) != _dtype(mm["lhs_var"]):
            why = "q and k differ in dtype"
        if why is not None:
            decisions.append(SegmentDecision(
                tier="anchor", form="flash", eqns=0, rows=cur_rows,
                roles=(), near_bytes=0, far_bytes=0, near_us=0.0,
                far_us=0.0, fused=False, batch=mm["batch_shape"],
                reason=f"flash pair declined: flash_attention (B5) "
                       f"refuses its operands ({why}); the scores and "
                       f"the PV product are planned on their own"))
            return False
        mm["flash"] = dict(scale=scale, t_dim=t_dim,
                           consts={v: specs[v] for v in specs})
        mm["extra_eqns"] = chain + [i]
        mm["rhs_specs"] = mm["rhs_specs"] + [
            OperandSpec(rhs_v, "bulk_v", batch * t_dim, n2)]
        mm["n"], mm["out_var"], mm["out_dtype"] = n2, out, dt
        current = []
        produced = {out: ("bulk", n2)}
        reduced_vars.clear()
        return True

    def try_admit(i, node) -> bool:
        if mm is not None and mm["flash"] is not None:
            return False     # the PV product closes a flash segment
        tier = eqn_tier(node_name(node) or "")
        if tier == "near":
            return try_admit_elementwise(i, node)
        if tier == "layout":
            return try_admit_layout(i, node)
        if tier == "reduce":
            return try_admit_reduce(i, node)
        if tier == "anchor":
            return try_admit_anchor(i, node)
        return False

    def hoistable(i, node) -> bool:
        """A small op (or a view of an outside value) the open segment can
        pass over: it reads nothing the segment made and runs unfused
        just ahead of the kernel (``pre_eqns``)."""
        if mm is None and not current:
            return False
        if not isinstance(node_val(node), torch.Tensor):
            return False
        if any(v in produced for v in node.all_input_nodes):
            return False
        if _same_view_src(node) is not None or node in const_nodes or \
                node_name(node) == "t":
            return True                  # moves no data / a constant
        if _size(node) >= bulk_threshold:
            return False
        return eqn_tier(node_name(node) or "") in ("near", "layout")

    def flush():
        if mm is None and n_compute < 1:
            reset()
            return
        seg_idx = list(current)
        seg_set = set(seg_idx)
        if mm is None:
            span_start, span_end = seg_idx[0], seg_idx[-1]
        else:
            span_start = mm["span_start"]
            span_end = max([mm["eqn_idx"], *seg_idx, *mm["extra_eqns"]])
        pre = sorted(i for i in hoisted if i < span_end)

        member_set = set(seg_set)
        if mm is not None:
            member_set.add(mm["eqn_idx"])
            member_set.update(mm["pro_eqns"])
            member_set.update(mm["rhs_pro_eqns"])
            member_set.update(mm["extra_eqns"])

        def escapes(v) -> bool:
            return v in outvar_set or any(
                ci not in member_set for ci in consumers.get(v, []))

        # a 2-D-view-keeping view whose value escapes runs after the
        # kernel on the kernel's output instead of being stored twice
        post: list[int] = []
        for i in reversed(seg_idx):
            node = eqns[i]
            src = _same_view_src(node)
            if src is not None and escapes(node) and src in produced and \
                    all(ci not in member_set or ci in post
                        for ci in consumers.get(node, [])):
                post.append(i)
                member_set.discard(i)
        post.sort()
        seg_idx = [i for i in seg_idx if i not in post]

        def escapes_kernel(v) -> bool:
            return v in outvar_set or any(
                ci not in member_set for ci in consumers.get(v, []))

        produced_f: dict[Any, tuple[str, int]] = {}
        out_candidates: list[Any] = []
        if mm is not None:
            produced_f[mm["out_var"]] = ("bulk", mm["n"])
            out_candidates.append(mm["out_var"])
        for i in seg_idx:
            out = eqns[i]
            produced_f[out] = produced[out]
            out_candidates.append(out)

        # a flash segment's scalar constants stay operands: its planned
        # backward replays the chain that reads them
        operand_specs: list[OperandSpec] = [
            OperandSpec(v, *cls) for v, cls in
            (mm["flash"]["consts"].items() if mm is not None and
             mm["flash"] is not None else ())]
        seen: set[Any] = set()
        for i in seg_idx:
            for v in eqns[i].all_input_nodes:
                if v in produced_f or v in seen:
                    continue
                seen.add(v)
                cls = specs.get(v)
                if cls is None:             # output of a hoisted eqn
                    vshape = _shape(v)
                    if not _is_param_shape(vshape) and _size(v) != 1:
                        reset()             # cannot block it: not a segment
                        return
                    cls = ("param", 1, _lane(vshape))
                operand_specs.append(OperandSpec(v, *cls))

        outputs, out_cols = [], []
        for v in out_candidates:
            if escapes_kernel(v):
                kind, cols = produced_f[v]
                if kind != "bulk":
                    reset()                 # a param value escapes
                    return
                outputs.append(v)
                out_cols.append(cols)
        if not outputs:
            reset()
            return

        anchor_spec = None
        if mm is not None:
            anchor_spec = MatmulAnchor(
                eqn_idx=mm["eqn_idx"], lhs_var=mm["lhs_var"],
                lhs_specs=mm["lhs_specs"], rhs=mm["rhs"],
                pro_eqns=mm["pro_eqns"], k=mm["k"], n=mm["n"],
                out_var=mm["out_var"], out_dtype=mm["out_dtype"],
                form=mm["form"], rhs_specs=mm["rhs_specs"],
                rhs_pro_eqns=mm["rhs_pro_eqns"], extra_eqns=mm["extra_eqns"],
                batch=mm["batch"], batch_shape=mm["batch_shape"],
                flash=mm["flash"])
        seg = Segment(
            eqn_idx=seg_idx, rows=cur_rows,
            operand_specs=operand_specs, outputs=outputs, out_cols=out_cols,
            pre_eqns=pre, post_eqns=post,
            span_start=span_start, span_end=span_end, matmul=anchor_spec,
            smem_budget=policy.budget, sms=policy.machine.sms,
            l2_bytes=policy.machine.l2_bytes,
            elementwise=not any(
                eqn_tier(node_name(eqns[j]) or "") == "reduce" or
                node_name(eqns[j]) in ("slice", "cat") and
                _same_view_src(eqns[j]) is None for j in seg_idx),
            views={**(mm["pro_views"] if mm is not None else {}),
                   **produced})

        far_b = _far_decision_bytes(eqns, seg.all_eqn_idx)
        roles = [f"{sp.role}[{sp.rows}x{sp.cols}]"
                 for sp in seg.operand_specs]
        if anchor_spec is not None:
            roles = [f"{sp.role}[{sp.rows}x{sp.cols}]"
                     for sp in (*anchor_spec.lhs_specs,
                                *anchor_spec.rhs_specs)] + roles
        decision = policy.decide(
            tier="anchor" if anchor_spec is not None else "elementwise",
            n_compute=n_compute, near_bytes=seg.io_bytes(), far_bytes=far_b)
        if anchor_spec is not None and decision.fused:
            why = _anchor_epilogue_misfit(seg, eqns, policy.budget)
            if why is not None:
                decision = decision._with(fused=False, reason=why)
        form = None
        if anchor_spec is not None:
            form = "flash" if anchor_spec.flash is not None \
                else anchor_spec.form
        decision = decision._with(
            form=form, rows=cur_rows, roles=tuple(roles),
            batch=anchor_spec.batch_shape if anchor_spec is not None
            else ())
        decisions.append(decision)
        if decision.fused:
            segments.append(seg)
        reset()

    for i, node in enumerate(eqns):
        if eqn_tier(node_name(node) or "") == "anchor" and \
                i not in declined_anchors:
            why = out_of_slice(node)
            if why is not None:
                declined_anchors.add(i)
                bmm = node_name(node) == "bmm"
                decisions.append(SegmentDecision(
                    tier="anchor", form="bmm" if bmm else "strided",
                    eqns=0, rows=_bulk_view(_shape(node))[0], roles=(),
                    near_bytes=0, far_bytes=_eqn_io_bytes(node),
                    near_us=0.0, far_us=0.0, fused=False, reason=why,
                    batch=_batch_shape(node) if bmm else ()))
        if try_admit(i, node):
            continue
        if hoistable(i, node):
            hoisted.append(i)
            continue
        flush()
        if not try_admit(i, node):
            reset()
    flush()

    seg_eqns = {i for s in segments for i in s.all_eqn_idx}
    naive = fused = 0
    for i, node in enumerate(eqns):
        io_bytes = _eqn_io_bytes(node)
        naive += io_bytes
        if i not in seg_eqns:
            fused += io_bytes
    for s in segments:
        fused += s.io_bytes()
    return OffloadPlan(ann, segments, naive, fused, decisions=decisions,
                       policy=policy)


def _rounding_op(form: str, dtype: torch.dtype) -> int:
    """1 when a gradient contraction rounds its f32 accumulator to a
    16-bit product, else 0: the fused op it holds besides its epilogue.
    The JAX package's transpose rule writes that rounding out — the
    cotangent product accumulates in f32 (``preferred_element_type``)
    and a ``convert_element_type`` epilogue rounds it — while ``aten.mm``
    folds it into the op; counting it keeps the greedy decision on the
    same program (a forward product is bf16-out in both, and bare)."""
    return int(form in ("dlhs", "drhs") and dtype.itemsize == 2)


def _anchor_epilogue_misfit(seg: Segment, eqns, budget: int) -> str | None:
    """Why an anchored segment's epilogue cannot run on the card, or
    None: a lane reduction needs the accumulator's whole row in one
    block's shared memory (``fused_matmul.row_fits``)."""
    from repro_torch.kernels.fused_matmul import row_fits, row_smem_bytes

    has_reduce = any(eqn_tier(node_name(eqns[i]) or "") == "reduce"
                     for i in seg.eqn_idx)
    if has_reduce and not row_fits(seg.matmul.n, budget):
        return (f"lane-reduce epilogue over N={seg.matmul.n}: its f32 row "
                f"and reduction scratch ({row_smem_bytes(seg.matmul.n)} B) "
                f"exceed the {budget} B shared-memory budget")
    return None


# ---------------------------------------------------------------------------
# Segment -> block programs
# ---------------------------------------------------------------------------

def _program(eqns: Sequence, eqn_idx: Sequence[int], in_vars: Sequence,
             inputs: Sequence[Input], out_vars: Sequence, *,
             views: dict) -> BlockProgram:
    """Lower a run of graph nodes onto a block program."""
    env: dict[Any, int] = {}
    ops: list[Op] = []
    for k, (v, inp) in enumerate(zip(in_vars, inputs)):
        env[v] = len(ops)
        ops.append(Op("in", inp.dtype, inp.cols,
                      param=inp.role in ("param", "param_k", "param_w"),
                      arg=k))

    def ref(a):
        if isinstance(a, fx.Node):
            return ("v", env[a])
        return ("c", _lit(a))

    for i in eqn_idx:
        node = eqns[i]
        name = node_name(node)
        dt = dtype_name(_dtype(node))
        kind, cols = views[node]
        param = kind == "param"
        src = _same_view_src(node)
        if src is not None:
            op = Op("same", dt, ops[env[src]].cols, param=ops[env[src]].param,
                    args=(ref(src),))
        elif name in ("sum", "amax"):
            op = Op("reduce", dt, 1, code="sum" if name == "sum" else "max",
                    args=(ref(node.args[0]),),
                    kwargs=tuple(sorted((k, _lit(x))
                                        for k, x in node.kwargs.items())))
        elif name == "slice":
            x = node.args[0]
            start = node.args[2] if len(node.args) > 2 else 0
            end = node.args[3] if len(node.args) > 3 else None
            step = node.args[4] if len(node.args) > 4 else 1
            width = _lane(_shape(x))
            start, end, step = slice(start, end, step).indices(width)
            op = Op("slice", dt, cols, args=(ref(x),),
                    params=(start, end, step))
        elif name == "cat":
            op = Op("cat", dt, cols, args=tuple(ref(v) for v in node.args[0]))
        elif name == "expand":
            op = Op("expand", dt, cols, param=param,
                    args=(ref(node.args[0]),))
        else:
            code = ew_opcode(node.target, node.args, node.kwargs)
            op = Op("ew", dt, cols, param=param, code=code,
                    name=node.target.name().partition("::")[2],
                    args=tuple(ref(a) for a in node.args),
                    kwargs=tuple(sorted((k, _lit(x))
                                        for k, x in node.kwargs.items()
                                        if k not in PLACEMENT_KWARGS)))
        env[node] = len(ops)
        ops.append(op)
    return BlockProgram(tuple(inputs), tuple(ops),
                        tuple(env[v] for v in out_vars))


def program_from_fn(fn: Callable, bulk: Sequence[torch.Tensor],
                    params: Sequence[torch.Tensor], n_outputs: int
                    ) -> tuple[BlockProgram, list[tuple], int, int]:
    """Lower ``fn(*bulk_blocks, *param_blocks)`` (elementwise ops and
    lane reductions) onto a block program with ``bulk`` [rows, C] and
    ``param`` [1, C] (or [1, 1]) operands — what the single-shape
    ``kernels.ops.fused_elementwise`` / ``fused_segment`` run.  Returns
    the program, the operand specs, rows and C."""
    from torch.fx.experimental.proxy_tensor import make_fx

    shape = tuple(bulk[0].shape)
    c = shape[-1] if len(shape) > 1 else 1
    rows = bulk[0].numel() // c
    b2 = [torch.as_tensor(a).reshape(rows, c) for a in bulk]
    p2 = [torch.as_tensor(p).reshape(1, -1) for p in params]
    gm = make_fx(lambda *xs: fn(*xs), tracing_mode="fake",
                 decomposition_table=DECOMPOSITIONS)(*b2, *p2)
    specs = [("bulk", rows, c)] * len(b2) + \
        [("param", 1, p.shape[1]) for p in p2]
    inputs = [Input(s[0], s[1], s[2], dtype_name(t.dtype))
              for s, t in zip(specs, [*b2, *p2])]
    eqns = [n for n in gm.graph.nodes if n.op == "call_function"]
    views = {}
    for node in eqns:
        if node_name(node) not in ("sum", "amax", "expand") and \
                _same_view_src(node) is None and \
                ew_opcode(node.target, node.args, node.kwargs) is None:
            raise ValueError(f"{node.target} cannot run in a fused "
                             "elementwise segment")
        val = node.meta["val"]
        param = val.ndim < 2 or val.shape[0] == 1 and rows != 1
        views[node] = ("param" if param else "bulk",
                       val.shape[-1] if val.ndim else 1)
    res = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    prog = _program(eqns, range(len(eqns)),
                    [n for n in gm.graph.nodes if n.op == "placeholder"],
                    inputs, res[:n_outputs], views=views)
    return prog, specs, rows, c


def _inputs_of(spec_list: Sequence[OperandSpec]) -> list[Input]:
    return [Input(sp.role, sp.rows, sp.cols, dtype_name(_dtype(sp.var))
                  if _dtype(sp.var) is not None else "float32",
                  sp.lead, sp.out_lead) for sp in spec_list]


@dataclass(frozen=True)
class SegmentPrograms:
    """The block programs of one planned segment: ``body`` (the grid
    body or the epilogue), and for anchored segments ``lhs`` / ``rhs``
    (the prologues, None when the operand is read as it is)."""

    body: BlockProgram
    lhs: BlockProgram | None = None
    rhs: BlockProgram | None = None


def segment_programs(eqns: Sequence, seg: Segment) -> SegmentPrograms:
    mm = seg.matmul
    in_vars = [sp.var for sp in seg.operand_specs]
    inputs = _inputs_of(seg.operand_specs)
    if mm is None:
        return SegmentPrograms(_program(eqns, seg.eqn_idx, in_vars, inputs,
                                        seg.outputs, views=seg.views))
    acc = Input("acc", seg.rows, mm.n, dtype_name(mm.out_dtype))
    body = _program(eqns, seg.eqn_idx, [mm.out_var, *in_vars],
                    [acc, *inputs], seg.outputs, views=seg.views)
    lhs = rhs = None
    if mm.pro_eqns:
        lhs = _program(eqns, mm.pro_eqns, [sp.var for sp in mm.lhs_specs],
                       _inputs_of(mm.lhs_specs), [mm.lhs_var],
                       views=seg.views)
    if mm.rhs_pro_eqns:
        rhs = _program(eqns, mm.rhs_pro_eqns,
                       [sp.var for sp in mm.rhs_specs],
                       _inputs_of(mm.rhs_specs), [mm.rhs], views=seg.views)
    return SegmentPrograms(body, lhs, rhs)


def _segment_arg_vars(seg: Segment) -> list[Any]:
    """The segment's inputs in the dispatch's positional order: matmul
    lhs side, matmul rhs side, then the body operands."""
    arg_vars: list[Any] = []
    if seg.matmul is not None:
        arg_vars += [s.var for s in seg.matmul.lhs_specs]
        arg_vars += [s.var for s in seg.matmul.rhs_specs]
    arg_vars += [s.var for s in seg.operand_specs]
    return arg_vars


def _segment_kernel(seg: Segment, progs: SegmentPrograms, *, impl: str
                    ) -> Callable:
    """The fused call of one planned segment, its static arguments bound
    once: the grid kernel for an elementwise segment, the anchored GEMM
    of the segment's form otherwise.  ``call(*vals)`` takes the operands
    in ``_segment_arg_vars`` order and returns the outputs in their graph
    shapes."""
    from repro_torch.kernels import ops as kops

    out_dtypes = [_dtype(v) for v in seg.outputs]
    shapes = [_shape(v) for v in seg.outputs]
    # an output the graph holds in a permuted dense layout (an einsum's)
    # gets that layout back, so the views that follow it see the strides
    # they were traced with (a broadcast layout stays contiguous: any view
    # of a contiguous tensor is valid)
    strides = [node_val(v).stride() if not node_val(v).is_contiguous()
               and _dense(node_val(v)) else None
               for v in seg.outputs]
    epi_meta = tuple(s.meta for s in seg.operand_specs)
    mm = seg.matmul
    common = dict(acc_dtype=mm.out_dtype if mm else None,
                  out_cols=seg.out_cols, out_dtypes=out_dtypes,
                  vmem_bytes=seg.smem_budget, impl=impl)
    if mm is None:
        # the grid kernel writes such an output in its layout itself
        out_strides = [(shp, st) if st is not None else None
                       for shp, st in zip(shapes, strides)]

        def run(vals):
            return kops.fused_segment_grid(
                progs.body, vals, epi_meta, rows=seg.rows,
                out_cols=seg.out_cols, out_dtypes=out_dtypes,
                rows_block=GRID_ROWS_BLOCK, out_strides=out_strides,
                impl=impl)
    elif mm.flash is not None:
        def run(vals):
            # q, the transposed view of k, v; the chain's scalar
            # constants (vals[3:]) are folded into the extracted scale
            return kops.fused_flash_segment(
                vals[0], vals[1].transpose(-1, -2), vals[2], batch=mm.batch,
                rows=seg.rows, head_dim=mm.k, t_dim=mm.flash["t_dim"],
                n_dim=mm.n, scale=mm.flash["scale"],
                out_dtype=mm.out_dtype, impl=impl)
    elif mm.form == "drhs":
        def run(vals):
            # vals[0] is the [rows, m] transposed view of the activation
            return kops.fused_matmul_drhs_segment(
                progs.body, vals[0].transpose(-1, -2), vals[1], vals[2:],
                epi_meta, m_dim=mm.k, rows=seg.rows, n_dim=mm.n,
                batch=mm.batch, **common)
    else:
        n_lhs, n_rhs = len(mm.lhs_specs), len(mm.rhs_specs)
        lhs_meta = tuple(s.meta for s in mm.lhs_specs)
        rhs_meta = tuple(s.meta for s in mm.rhs_specs)
        kw = dict(rows=seg.rows, k_dim=mm.k, n_dim=mm.n,
                  rows_block=MATMUL_ROWS_BLOCK, sms=seg.sms, batch=mm.batch,
                  **common)
        if mm.form == "dlhs":
            def run(vals):
                # vals[n_lhs] is the [k, n] transposed view of the weight
                return kops.fused_matmul_dlhs_segment(
                    progs.lhs, progs.body, vals[:n_lhs], lhs_meta,
                    vals[n_lhs].transpose(-1, -2), vals[n_lhs + 1:],
                    epi_meta, **kw)
        else:
            def run(vals):
                return kops.fused_matmul_segment(
                    progs.lhs, progs.rhs, progs.body, vals[:n_lhs],
                    lhs_meta, vals[n_lhs:n_lhs + n_rhs], rhs_meta,
                    vals[n_lhs + n_rhs:], epi_meta, **kw)

    def call(*vals):
        # a 0-dim CPU tensor (a constant such as ``torch.tensor(2.0)``)
        # joins CUDA operands, as it may in an eager op
        dev = next((v.device for v in vals if v.is_cuda), None)
        if dev is not None:
            vals = [v.to(dev) if v.dim() == 0 and not v.is_cuda else v
                    for v in vals]
        outs = []
        for o, shp, st in zip(run(list(vals)), shapes, strides):
            if st is not None and o.stride() == tuple(st) and \
                    tuple(o.shape) == tuple(shp):
                outs.append(o)          # written in its layout
                continue
            o = o.view(shp)
            if st is not None:
                o = torch.empty_strided(shp, st, dtype=o.dtype,
                                        device=o.device).copy_(o)
            outs.append(o)
        return tuple(outs)
    call.segment = seg
    return call


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s strides lay its elements out without gaps or
    overlaps (a permutation of a contiguous layout)."""
    expect = 1
    for stride, size in sorted((st, sz) for sz, st in zip(t.shape, t.stride())
                               if sz > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _segment_replay(eqns: Sequence, seg: Segment) -> Callable:
    """The segment's own nodes replayed over full tensors, in graph order
    — the plain dispatch a backward plan differentiates (what the
    reference's ``_segment_fn`` on the ``ref`` path is).  Takes the
    operands in ``_segment_arg_vars`` order; returns the outputs."""
    arg_vars = _segment_arg_vars(seg)
    post = set(seg.post_eqns)
    idx = [j for j in seg.all_eqn_idx if j not in post]

    def replay(*vals):
        env = dict(zip(arg_vars, vals))
        for j in idx:
            node = eqns[j]
            env[node] = node.target(*fx.map_arg(node.args, env.__getitem__),
                                    **fx.map_arg(node.kwargs,
                                                 env.__getitem__))
        return tuple(env[v] for v in seg.outputs)
    return replay


# ---------------------------------------------------------------------------
# Capture and the runner
# ---------------------------------------------------------------------------

def _linearize_order(gm: fx.GraphModule) -> None:
    """Schedule a captured program that differentiates itself (it seeds
    a cotangent with ``ones_like``) as jax's linearization orders it:
    an elementwise node after the seed that reads no cotangent (a
    derivative factor such as ``2 * x`` of ``x ** 2``) moves to just
    after its last input, so it runs with the forward values it reads.
    A program without a seed (every forward capture of a model) keeps
    its order."""
    seeds = [n for n in gm.graph.nodes if node_name(n) == "ones_like"]
    if not seeds:
        return
    nodes = list(gm.graph.nodes)
    tangent, moved = set(seeds), set()
    for node in nodes[nodes.index(seeds[0]) + 1:]:
        if node.op != "call_function":
            continue
        if any(v in tangent for v in node.all_input_nodes):
            tangent.add(node)
            continue
        if eqn_tier(node_name(node) or "") != "near" or \
                not node.all_input_nodes:
            continue
        nodes.remove(node)
        j = max(nodes.index(v) for v in node.all_input_nodes) + 1
        while nodes[j] in moved:            # after earlier moved nodes
            j += 1
        nodes.insert(j, node)
        moved.add(node)
    for prev, node in zip(nodes, nodes[1:]):
        if prev.next is not node:
            prev.append(node)
    gm.graph.lint()
    gm.recompile()


def _schedule_epilogues(gm: fx.GraphModule) -> None:
    """Move the elementwise nodes that read a contraction's product (and
    otherwise only values defined before it) to just after the ``mm``,
    in their order, so that they can become its epilogue.  A cotangent
    program lists autograd's derivative steps in its own order — the
    f32 cast of a cast weight's gradient comes after the other operand's
    product, for one — where a jaxpr puts them after the product they
    transform."""
    nodes = list(gm.graph.nodes)
    for m in [n for n in nodes if node_name(n) in ("mm", "bmm")]:
        at = nodes.index(m)
        avail, chain = set(nodes[:at + 1]), [m]
        for c in nodes[at + 1:]:
            if c.op == "call_function" and \
                    eqn_tier(node_name(c) or "") == "near" and \
                    any(v in chain for v in c.all_input_nodes) and \
                    all(v in avail for v in c.all_input_nodes):
                chain.append(c)
                avail.add(c)
        for c in chain[1:]:
            nodes.remove(c)
        nodes[at + 1:at + 1] = chain[1:]
    for prev, node in zip(nodes, nodes[1:]):
        if prev.next is not node:
            prev.append(node)
    gm.graph.lint()
    gm.recompile()


def capture(fn: Callable, args: Sequence) -> tuple[fx.GraphModule, Any,
                                                   list[bool]]:
    """Capture ``fn(*args)`` as an aten graph in fake tensor mode.

    Tensor leaves of ``args`` become the graph's placeholders in pytree
    order; every other leaf is a static value baked into the graph (and
    part of the plan-cache key).  Returns the graph module, the output
    tree spec and which leaves are tensors."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, in_spec = pytree.tree_flatten(list(args))
    is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
    statics = [None if t else x for x, t in zip(leaves, is_tensor)]
    out_spec_box: list = []

    def flat_fn(*tensors):
        it = iter(tensors)
        full = [next(it) if t else s for t, s in zip(is_tensor, statics)]
        out = fn(*pytree.tree_unflatten(full, in_spec))
        flat, spec = pytree.tree_flatten(out)
        out_spec_box.append(spec)
        return flat

    # one fresh tensor per leaf: a tensor passed twice must not be traced
    # as one input (the plan serves every call of the same signature)
    tensors = [x.detach() for x, t in zip(leaves, is_tensor) if t]
    gm = make_fx(flat_fn, tracing_mode="fake",
                 decomposition_table=DECOMPOSITIONS)(*tensors)
    _linearize_order(gm)
    _fold_bmm_views(gm)
    return gm, out_spec_box[-1], is_tensor


def _build_runner(gm: fx.GraphModule, plan: OffloadPlan, impl: str, *,
                  grad_policy: OffloadPolicy | None = None
                  ) -> fx.GraphModule:
    """Bake the plan into a new graph: every node the plan leaves far is
    copied in graph order, and each fused segment becomes ONE call of its
    kernel (after its hoisted ``pre_eqns``, before its escaping views).
    fx generates straight-line Python for the graph, so running a plan
    costs what eager dispatch of the same calls costs.

    The runner runs under autograd: far nodes are aten calls, which
    autograd differentiates as it does eager PyTorch.  With
    ``grad_policy`` each segment call is differentiable too
    (``_segment_vjp``: its backward re-plans the segment's cotangent
    program under that policy); without it (a backward plan's own
    runner) a segment is a plain kernel call."""
    eqns = [n for n in gm.graph.nodes if n.op == "call_function"]
    seg_by_start = {s.span_start: s for s in plan.segments}
    plan.library = _register_library(eqns, plan)
    graph = fx.Graph()
    env: dict[Any, Any] = {}

    def copy(node):
        env[node] = graph.node_copy(node, lambda x: env[x])

    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            copy(node)
    i = 0
    while i < len(eqns):
        seg = seg_by_start.get(i)
        if seg is None:
            copy(eqns[i])
            i += 1
            continue
        for j in seg.pre_eqns:
            copy(eqns[j])
        progs = None if seg.matmul is not None and \
            seg.matmul.flash is not None else segment_programs(eqns, seg)
        fn = _segment_kernel(seg, progs, impl=impl)
        if grad_policy is not None:
            fn = _segment_vjp(eqns, seg, fn, policy=grad_policy)
        call = graph.call_function(
            fn, tuple(env[v] for v in _segment_arg_vars(seg)))
        for k, var in enumerate(seg.outputs):
            env[var] = graph.call_function(operator.getitem, (call, k))
        for j in seg.post_eqns:
            copy(eqns[j])
        i = seg.span_end + 1
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    graph.output(fx.map_arg(out_node.args[0], lambda x: env[x]))
    return fx.GraphModule(gm, graph)


def segment_call(eqns: Sequence, seg: Segment) -> dict:
    """Everything one fused call of ``seg`` needs besides the operand
    values: its programs, the operands' 2-D views and dtypes, the
    outputs, and (anchored) the contraction extents and batch.  What a
    kernel check on the card builds its inputs from.  A flash segment
    (``kind="flash"``) has no programs: B5 computes its fixed chain."""
    mm = seg.matmul
    flash = mm is not None and mm.flash is not None
    progs = None if flash else segment_programs(eqns, seg)
    specs = ([sp.meta for sp in mm.lhs_specs] + [sp.meta for sp in
                                                   mm.rhs_specs]
             if mm is not None else [])
    specs += [sp.meta for sp in seg.operand_specs]
    return dict(
        kind="grid" if mm is None else "flash" if flash else "matmul",
        progs=progs, form=mm.form if mm is not None else None,
        batch=mm.batch if mm is not None else 1,
        batch_shape=mm.batch_shape if mm is not None else (),
        scale=mm.flash["scale"] if flash else None,
        t_dim=mm.flash["t_dim"] if flash else 0,
        specs=specs, dtypes=[_dtype(v) for v in _segment_arg_vars(seg)],
        rows=seg.rows, out_cols=list(seg.out_cols),
        out_dtypes=[_dtype(v) for v in seg.outputs],
        n_lhs=len(mm.lhs_specs) if mm is not None else 0,
        n_rhs=len(mm.rhs_specs) if mm is not None else 0,
        k=mm.k if mm is not None else 0, n=mm.n if mm is not None else 0,
        acc_dtype=mm.out_dtype if mm is not None else None,
        vmem_bytes=seg.smem_budget, sms=seg.sms)


def kernel_symbol(call: dict) -> str:
    """The generated kernel's name: one per distinct segment."""
    from repro_torch.kernels.fused_elementwise import triton_source

    if call["kind"] == "grid":
        return triton_source(call["progs"].body, rows=call["rows"],
                             specs=call["specs"],
                             rows_block=GRID_ROWS_BLOCK)[0]
    if call["kind"] == "flash":
        return "flash_attention"
    return _matmul_gen(call)["name"]


def _matmul_gen(call: dict) -> dict:
    """The generated code of an anchored segment, through the same
    function its wrapper calls at launch (so the planner registers the
    symbol the launch looks up)."""
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import fused_matmul_bwd as fmb

    nl, nr = call["n_lhs"], call["n_rhs"]
    specs, dts = call["specs"], [dtype_name(d) for d in call["dtypes"]]
    outs = tuple(dtype_name(d) for d in call["out_dtypes"])
    if call["form"] == "dlhs":
        return fmb.dlhs_source(
            call["progs"].lhs, call["progs"].body, tuple(specs[:nl]),
            tuple(specs[nl + nr:]), lhs_dtypes=tuple(dts[:nl]),
            rhs_dtype=dts[nl], epi_dtypes=tuple(dts[nl + nr:]),
            out_dtypes=outs, rows=call["rows"], k_dim=call["k"],
            n_dim=call["n"], acc_dtype=dtype_name(call["acc_dtype"]),
            rows_block=MATMUL_ROWS_BLOCK, vmem_bytes=call["vmem_bytes"],
            sms=call["sms"], batch=call["batch"])
    if call["form"] == "drhs":
        return fmb.drhs_source(
            call["progs"].body, tuple(specs[2:]), lhs_dtype=dts[0],
            rhs_dtype=dts[1], epi_dtypes=tuple(dts[2:]), out_dtypes=outs,
            m_dim=call["k"], rows=call["rows"], n_dim=call["n"],
            acc_dtype=dtype_name(call["acc_dtype"]),
            vmem_bytes=call["vmem_bytes"], batch=call["batch"])
    return fm.segment_source(
        call["progs"].lhs, call["progs"].rhs, call["progs"].body,
        tuple(specs[:nl]), tuple(specs[nl:nl + nr]),
        tuple(specs[nl + nr:]), lhs_dtypes=tuple(dts[:nl]),
        rhs_dtypes=tuple(dts[nl:nl + nr]), epi_dtypes=tuple(dts[nl + nr:]),
        out_dtypes=tuple(dtype_name(d) for d in call["out_dtypes"]),
        rows=call["rows"], k_dim=call["k"], n_dim=call["n"],
        acc_dtype=dtype_name(call["acc_dtype"]),
        rows_block=MATMUL_ROWS_BLOCK, vmem_bytes=call["vmem_bytes"],
        sms=call["sms"], batch=call["batch"])


def _register_library(eqns: Sequence, plan: OffloadPlan) -> list[str]:
    """Put every anchored segment of the plan in one CUDA translation
    unit (built at the first launch of any of them)."""
    from repro_torch.kernels import fused_matmul as fm

    gens = [_matmul_gen(segment_call(eqns, s)) for s in plan.segments
            if s.matmul is not None and s.matmul.flash is None]
    return fm.prepare_library(gens) if gens else []


# ---------------------------------------------------------------------------
# Grad through offload: a differentiable fused-segment call.
#
# A fused kernel has no derivative of its own.  Each segment call of a
# forward runner is a ``torch.autograd.Function`` whose forward is the
# kernel and whose backward re-plans the segment's cotangent program
# through the same planner: ``make_fx`` (fake mode) of ``torch.func.vjp``
# over the segment's replayed nodes, so the recomputed forward anchors
# fwd again and the cotangent contractions anchor dlhs (dx = g @ w^T)
# and drhs (dw = x^T @ g).  Backward plans live in a per-segment cache
# keyed ("bwd", policy, signatures), apart from every forward plan cache
# (keyed "fwd" in ``mpu_offload``); module-level counters expose them.
# ---------------------------------------------------------------------------

_BWD_STATS = OffloadStats()
_BWD_PLANS: list[OffloadPlan] = []
_BWD_PLANS_KEEP = 256       # a bounded window of recent backward plans


def bwd_plan_stats() -> OffloadStats:
    """Plan-cache counters of segment backward (cotangent) planning."""
    return _BWD_STATS


def bwd_plans() -> list[OffloadPlan]:
    """Recently compiled backward plans (most recent last)."""
    return list(_BWD_PLANS)


def clear_bwd_plans() -> None:
    _BWD_PLANS.clear()
    _BWD_STATS.reset()


def _bwd_signature(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), tuple(t.stride()), str(t.dtype), str(t.device))


def _segment_bwd_runner(eqns: Sequence, seg: Segment, *,
                        policy: OffloadPolicy) -> Callable:
    """``run_bwd(primals, cts)`` -> one gradient per primal (None for a
    non-float one), with the cotangent program planned through
    ``_build_runner`` once per (policy, signature) and cached on the
    segment."""
    from torch.fx.experimental.proxy_tensor import make_fx

    replay = _segment_replay(eqns, seg)
    cache: dict = seg.__dict__.setdefault("_bwd_plan_cache", {})

    def compile_for(primals, cts):
        diff = [i for i, v in enumerate(primals) if v.is_floating_point()]
        rest = [i for i, v in enumerate(primals) if i not in diff]
        outs = [j for j, v in enumerate(seg.outputs)
                if _dtype(v).is_floating_point]

        def ct_fn(fprimals, others, cts_f):
            def f(*fp):
                vals = [None] * len(primals)
                for i, v in zip(diff, fp):
                    vals[i] = v
                for i, v in zip(rest, others):
                    vals[i] = v
                res = replay(*vals)
                return tuple(res[j] for j in outs)
            _, vjp_fn = torch.func.vjp(f, *fprimals)
            return vjp_fn(tuple(cts_f))

        t0 = time.perf_counter()
        gm = make_fx(ct_fn, tracing_mode="fake",
                     decomposition_table=DECOMPOSITIONS)(
            [primals[i].detach() for i in diff],
            [primals[i].detach() for i in rest],
            [cts[j].detach() for j in outs])
        gm.graph.eliminate_dead_code()
        _schedule_epilogues(gm)
        _fold_bmm_views(gm)
        t1 = time.perf_counter()
        plan = plan_offload(gm, policy=policy)
        run = _build_runner(gm, plan, policy.impl)
        _BWD_STATS.capture_s += t1 - t0
        _BWD_STATS.plan_s += time.perf_counter() - t1
        _BWD_PLANS.append(plan)
        del _BWD_PLANS[:-_BWD_PLANS_KEEP]
        return run, plan, diff, rest, outs

    def entry_for(primals, cts):
        key = ("bwd", policy, seg.matmul.batch_shape if seg.matmul
               else (), tuple(map(_bwd_signature, primals)),
               tuple(_bwd_signature(c) for c in cts if c is not None))
        entry = cache.get(key)
        if entry is None:
            _BWD_STATS.plan_misses += 1
            _BWD_STATS.traces += 1
            entry = cache[key] = compile_for(primals, cts)
        else:
            _BWD_STATS.plan_hits += 1
        return entry

    def run_bwd(primals, cts):
        run, _, diff, rest, outs = entry_for(primals, cts)
        flat = run(*[primals[i] for i in diff], *[primals[i] for i in rest],
                   *[cts[j] for j in outs])
        grads = [None] * len(primals)
        for i, g in zip(diff, flat):
            grads[i] = g
        return grads

    run_bwd.entry_for = entry_for
    return run_bwd


class _SegmentFn(torch.autograd.Function):
    """One fused segment under autograd: the kernel forward, the planned
    cotangent program backward."""

    @staticmethod
    def forward(ctx, seg_call, *vals):
        outs = seg_call.kernel(*vals)
        ctx.seg_call = seg_call
        ctx.save_for_backward(*vals)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.seg_call.bwd(ctx.saved_tensors, cts)
        return (None, *grads)


def _segment_vjp(eqns: Sequence, seg: Segment, kernel: Callable, *,
                 policy: OffloadPolicy) -> Callable:
    """The differentiable call of one segment: the plain kernel call
    when no input needs a gradient, ``_SegmentFn`` otherwise."""
    bwd = _segment_bwd_runner(eqns, seg, policy=policy)

    def call(*vals):
        if torch.is_grad_enabled() and any(
                isinstance(v, torch.Tensor) and v.requires_grad
                for v in vals):
            return _SegmentFn.apply(call, *vals)
        return kernel(*vals)

    call.kernel = kernel
    call.bwd = bwd
    call.segment = seg
    return call


def _warm_backward(run: fx.GraphModule) -> list[OffloadPlan]:
    """Plan the backward of every differentiable segment call of a
    forward runner now, from its graph's shapes (empty tensors of the
    planned shapes and strides stand in for the values), as the first
    backward would.  Returns the backward plans."""
    plans = []
    for node in run.graph.nodes:
        call = node.target
        if node.op != "call_function" or not hasattr(call, "bwd"):
            continue
        seg = call.segment
        primals = [_empty_like_val(v) for v in _segment_arg_vars(seg)]
        if not any(v.is_floating_point() for v in primals):
            continue
        cts = [_empty_like_val(v, contiguous=True) for v in seg.outputs]
        plans.append(call.bwd.entry_for(primals, cts)[1])
    return plans


def _empty_like_val(v, contiguous: bool = False) -> torch.Tensor:
    val = node_val(v)
    if contiguous:
        return torch.empty(tuple(val.shape), dtype=val.dtype,
                           device=val.device)
    return torch.empty_strided(tuple(val.shape), tuple(val.stride()),
                               dtype=val.dtype, device=val.device)


@dataclass
class _Compiled:
    """One plan-cache entry."""

    gm: fx.GraphModule
    plan: OffloadPlan
    run: fx.GraphModule
    out_spec: Any
    is_tensor: list[bool]


def _leaf_signature(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return ("t", tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    return ("s", type(leaf).__name__, repr(leaf))


def mpu_offload(fn: Callable, *, policy: OffloadPolicy | None = None
                ) -> Callable:
    """Offload transform with a bounded, policy-keyed plan cache.

    ``wrapped(*args)`` looks up (effective policy, "fwd", input
    signature) in the cache; on a miss it captures ``fn`` in fake mode,
    plans it and builds the runner (evicting the least recently used
    plan beyond ``max_plans``); then it runs the plan on ``args``.  The
    effective policy is the innermost ``offload_policy(...)`` scope,
    else ``policy``, else the default.

    The runner is differentiable: calling ``wrapped`` under autograd
    and differentiating its outputs runs each fused segment's planned
    backward (``_segment_vjp``).

    ``wrapped`` exposes ``stats`` (OffloadStats), ``policy``,
    ``warm(*a)`` (plan a signature without running it),
    ``warm_backward(*a)`` (plan its segments' backward too),
    ``plan_for(*a)``, ``explain(*a)`` (the DecisionReport) and
    ``cache_size()``.  Introspection never mutates the LRU or the
    counters."""
    cache: OrderedDict[Any, _Compiled] = OrderedDict()
    stats = OffloadStats()
    cache_bound = (policy or OffloadPolicy()).max_plans

    def effective_policy() -> OffloadPolicy:
        override = active_policy_override()
        if override is not None:
            return override
        return policy if policy is not None else OffloadPolicy()

    def compile_for(pol: OffloadPolicy, args) -> _Compiled:
        t0 = time.perf_counter()
        gm, out_spec, is_tensor = capture(fn, args)
        t1 = time.perf_counter()
        plan = plan_offload(gm, policy=pol)
        run = _build_runner(gm, plan, pol.impl, grad_policy=pol)
        stats.capture_s += t1 - t0
        stats.plan_s += time.perf_counter() - t1
        return _Compiled(gm, plan, run, out_spec, is_tensor)

    def entry_for(args, count: bool = True) -> tuple[_Compiled, list]:
        pol = effective_policy()
        leaves, in_spec = pytree.tree_flatten(list(args))
        key = ("fwd", pol, str(in_spec),
               tuple(_leaf_signature(x) for x in leaves))
        entry = cache.get(key)
        if entry is None:
            entry = compile_for(pol, args)
            if count:
                stats.plan_misses += 1
                stats.traces += 1
                cache[key] = entry
                while len(cache) > cache_bound:
                    cache.popitem(last=False)
                    stats.evictions += 1
        elif count:
            cache.move_to_end(key)
            stats.plan_hits += 1
        return entry, leaves

    def wrapped(*args):
        entry, leaves = entry_for(args)
        tensors = [x for x, t in zip(leaves, entry.is_tensor) if t]
        out = entry.run(*tensors)
        return pytree.tree_unflatten(list(out), entry.out_spec)

    def warm(*args) -> OffloadPlan:
        """Plan ``args``' signature now, as a first call would (counted
        as that call's miss), without running it."""
        return entry_for(args)[0].plan

    def warm_backward(*args) -> list[OffloadPlan]:
        """Plan the backward of every fused segment of ``args``' plan
        now, as the first backward would (``bwd_plan_stats`` counts the
        misses); the plans' kernels can then be built together."""
        return _warm_backward(entry_for(args)[0].run)

    wrapped.stats = stats
    wrapped.policy = policy
    wrapped.warm = warm
    wrapped.warm_backward = warm_backward
    wrapped.plan_for = lambda *args: entry_for(args, count=False)[0].plan
    wrapped.explain = lambda *args: \
        entry_for(args, count=False)[0].plan.report()
    wrapped.cache_size = lambda: len(cache)
    return wrapped


def offload_report(fn: Callable, *args,
                   policy: OffloadPolicy | None = None) -> OffloadPlan:
    """Capture + plan only: the OffloadPlan for ``fn(*args)``."""
    gm, _, _ = capture(fn, args)
    return plan_offload(gm, policy=policy)
