"""Matmul-anchored fused segments: the CUDA kernels, their wrapper and
their plain version (B3).

``fused_matmul_segment`` replaces the TPU kernel of the same name in
``repro/kernels/fused_matmul.py`` (``pl.pallas_call`` at :240): the
[rows, K] x [K, N] contraction of an anchored segment with an f32
accumulator, the lhs prologue applied per lhs element, the weight
prologue (bf16 -> f32 dequant cast, scales) per weight element so the
cast weight is never stored, and the epilogue (elementwise ops, lane
splits, lane reductions) on the accumulator before one store.

Which GEMM a segment is generated onto (``gemm_path``) follows from
what bounds it on the H100:

- a bf16 x bf16 product (after both prologues) of at least 64 rows a
  batch slice — the training forward, 2,048 tokens — is bound by
  operations, so it runs on the wgmma mainloop of
  ``csrc/fused_matmul_sm90.cuh`` (shared with B4 / B6): x read K-major
  and w[K, N] MN-major by TMA, an f32 master weight cast by the loading
  warpgroup through 16-byte loads;
- a bf16 product of fewer rows — the decode step's 8 — makes 16
  operations a weight element, below wgmma's 64-row minimum and bound by
  bytes, so it runs on the weight stream of
  ``csrc/fused_matmul_stream.cuh``: x staged once, the weight through a
  cp.async ring, a grid of column tiles x K splits that holds two CTAs on
  every SM;
- f32 and f16 products run on the FMA template of
  ``csrc/fused_matmul.cuh`` (see the note there for how it splits N and
  K over the card).

The prologues and the epilogue are CUDA code generated from the
segment's block programs (``codegen.py``): scalar accessors for the FMA
template, 8-lane ones (``_chunk_accessors``) that read each fwd operand
along its contiguous axis for the sm90 and stream paths.  The same
generator serves the two backward forms of ``fused_matmul_bwd.py`` (B4
dlhs, B6 drhs): ``segment_source(form=...)`` emits each form's operand
accessors, and ``launch_segment`` is the one launcher of all three; an
sm90 or stream segment has a TMA / cp.async launcher and a
register-staged one, of which ``launch_segment`` picks one by the
operands' bases (``sm90_variant``).  All anchored segments of a plan go
into ONE translation unit (``prepare_library``), so a plan costs one
``nvcc``, keyed by source hash into ``build/``; segments that are the
same (28 layers of one model) share one function.

The accumulator budget is shared memory: an epilogue that reduces over
the lanes holds the row of f32 sums in one block's shared memory
(``row_fits``); the planner declines an anchor whose lane-reduce row
cannot be held.

``fused_matmul_segment_plain`` beside it takes the same row blocks,
multiplies ``[rb, K] @ [K, N]`` in f32, and runs the same epilogue block
program op by op in PyTorch.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blockprog import BlockProgram, Input, dtype_name, run_program
from repro_torch.kernels.codegen import (
    Emitter,
    bcast_row_expr,
    ctype,
    read_after_write,
)
from repro_torch.kernels.fused_elementwise import (
    _largest_divisor_leq,
    donation_targets,
    role_block,
)
from repro_torch.kernels.guard import kernel_guard

KERNEL = "fused_matmul_segment"

#: output tile columns and K depth of the GEMM template (emitted into the
#: translation unit as ``FM_BN`` / ``FM_BK``, which ``csrc/fused_matmul.cuh``
#: reads)
BN, BK = 128, 32
#: rows of the tile one block holds in registers at a time: 32 keeps the
#: f32 accumulator and both staged operands in 255 registers a thread
MT_MAX = 32
#: static shared memory of a lane-reduce epilogue: ``fm_red[32]`` floats
_RED_SMEM_BYTES = 32 * 4

_CT = {"float32": "float", "bfloat16": "__nv_bfloat16",
       "float16": "__half", "int32": "int", "int64": "long long",
       "bool": "bool"}


# ---------------------------------------------------------------------------
# Geometry shared by the planner (Segment.io_bytes) and the kernel.  The
# accumulator budget ``vmem_bytes`` (the reference's name) and the SM
# count ``sms`` come from the caller: the planner passes its policy's.
# ---------------------------------------------------------------------------

def _block_budget(block: int, n_dim: int, vmem_bytes: int) -> int:
    """Clamp a row block so ``block x n_dim`` f32 fits the accumulator
    budget.  Never below 8 rows."""
    return max(min(block, vmem_bytes // (4 * max(n_dim, 1))), 8)


def _row_block(rows: int, epi_specs: Sequence[tuple],
               rows_block: int, n_dim: int, vmem_bytes: int,
               batch: int = 1) -> int:
    """Row-block extent: the largest divisor of the rep/tile/bcast gcd
    (or of ``rows``) that fits the clamped block budget; with ``batch``
    > 1 it divides the per-batch rows too, so no block straddles a batch
    slice."""
    limit = max(min(_block_budget(rows_block, n_dim, vmem_bytes), rows), 1)
    g = 0
    for spec in epi_specs:
        role, op_rows = spec[0], spec[1]
        if role == "rep":
            g = math.gcd(g, rows // op_rows)
        elif role == "tile":
            g = math.gcd(g, op_rows)
        elif role == "bcast":
            g = math.gcd(g, spec[4][-1])
    if batch > 1:
        g = math.gcd(g, rows // batch)
    return _largest_divisor_leq(g if g else rows, limit)


def matmul_row_blocks(rows: int, epi_specs: Sequence[tuple],
                      n_dim: int, rows_block: int, vmem_bytes: int,
                      batch: int = 1) -> int:
    """Per-batch row blocks the kernel launches: the weight slice streams
    once per row block."""
    return (rows // batch) // _row_block(rows, epi_specs, rows_block,
                                         n_dim, vmem_bytes, batch)


def row_block(rows: int, epi_specs: Sequence[tuple], n_dim: int,
              rows_block: int, vmem_bytes: int, batch: int = 1) -> int:
    """The row block of the Hopper kernel: a block accumulates an
    [rb, BN] tile (the N axis is split over blocks), so the budget clamps
    ``rb x min(N, BN)`` f32, through the reference's ``_row_block``."""
    return _row_block(rows, epi_specs, rows_block, min(n_dim, BN),
                      vmem_bytes, batch)


def k_splits(rows: int, rb: int, k_dim: int, n_dim: int, sms: int,
             elt: int = 2) -> tuple[int, int]:
    """``(splits, chunk)``: how the K axis is cut over thread blocks.
    Enough splits that the grid holds about two blocks on each of the
    ``sms`` SMs, never more than the K tiles, and never so many that the
    f32 partials (written and read once per split) outweigh the weight
    stream."""
    tiles = -(-n_dim // BN) * (rows // rb)
    k_tiles = -(-k_dim // BK)
    want = -(-2 * sms // tiles)
    cap = max(1, (k_dim * elt * (rows // rb)) // (8 * rows))
    splits = max(1, min(k_tiles, want, cap))
    chunk = -(-k_tiles // splits)
    return -(-k_tiles // chunk), chunk * BK


def in_tile(ks: int, elementwise: bool, out_cols: Sequence[int],
            n_dim: int) -> bool:
    """Whether the epilogue runs on the finished tile inside the GEMM
    kernel (no workspace, no second kernel): the block owns the whole
    contraction (one K split) and the epilogue is elementwise (no lane
    reduction, slice or concat) with every output at the full width."""
    return ks == 1 and elementwise and all(c == n_dim for c in out_cols)


def workspace_bytes(rows: int, epi_specs: Sequence[tuple], k_dim: int,
                    n_dim: int, rows_block: int, vmem_bytes: int,
                    sms: int, *, elt: int, elementwise: bool,
                    out_cols: Sequence[int], batch: int = 1) -> int:
    """Bytes of the f32 partial-product workspace of one fwd or dlhs
    call (none when the epilogue runs in the tile).  ``elt`` is the
    weight's element size."""
    rb = row_block(rows, epi_specs, n_dim, rows_block, vmem_bytes, batch)
    ks = k_splits(rows, rb, k_dim, n_dim, sms, elt)[0]
    if in_tile(ks, elementwise, out_cols, n_dim):
        return 0
    return 4 * rows * n_dim * ks


def column_tiles(n_dim: int) -> int:
    """Column tiles of the template's grid: ``BN`` output lanes each."""
    return -(-n_dim // BN)


def operand_streams(lhs_bytes: int, row_blocks: int, col_tiles: int, *,
                    l2_bytes: int, sms: int) -> tuple[int, int]:
    """How often a contraction's two operands come from device memory.
    Row blocks are the grid's fastest axis, so the ``row_blocks`` blocks
    that read one column tile of the rhs (the weight; the drhs
    cotangent) run side by side and share it in L2 — once, unless there
    are more of them than the card holds (two a SM).  Every column tile
    re-reads the whole lhs: once when it fits in half the L2, else once
    per tile."""
    rhs = 1 if row_blocks <= 2 * sms else row_blocks
    lhs = 1 if 2 * lhs_bytes <= l2_bytes else col_tiles
    return lhs, rhs


def row_smem_bytes(n_dim: int) -> int:
    """Shared memory of a lane-reduce epilogue block: the f32 row of the
    accumulator and the reduction scratch."""
    return 4 * n_dim + _RED_SMEM_BYTES


def epilogue_smem_bytes(n_dim: int, reduce: bool) -> int:
    """Dynamic shared memory of a workspace epilogue block: the f32 row
    of the accumulator where the epilogue reduces over the lanes (its
    ``fm_red`` scratch is static), none otherwise.  The generated
    launcher sets it (above 48 KB) and launches with it."""
    return 4 * n_dim if reduce else 0


def row_fits(n_dim: int, vmem_bytes: int) -> bool:
    """Whether a lane-reduce epilogue's shared memory (one f32 row of
    the accumulator and the reduction scratch) fits the budget."""
    return row_smem_bytes(n_dim) <= vmem_bytes


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _full(spec: tuple, v: torch.Tensor, rows: int, k: int, n: int,
          batch: int = 1) -> torch.Tensor:
    role, op_rows, c = spec[0], spec[1], spec[2]
    if role in ("param_k", "param_w"):
        return v.reshape(1, c)
    if role == "bulk_k":
        return v.reshape(rows, k)
    return v.reshape(batch * k, n)


def _epilogue_blocks(epi: BlockProgram, outs, acc_rows, epi_specs,
                     epi_views, i: int, rb: int, rows: int) -> None:
    """Run the epilogue program on row block ``i`` (``acc_rows`` is the
    block's rounded accumulator) and store every output's rows."""
    eblocks = [role_block(s, v, i, rb, rows)
               for s, v in zip(epi_specs, epi_views)]
    for o, val in zip(outs, run_program(epi, [acc_rows, *eblocks],
                                        block_rows=rb)):
        o[i * rb:(i + 1) * rb] = val


def fused_matmul_segment_plain(
        pro: BlockProgram | None, rhs_pro: BlockProgram | None,
        epi: BlockProgram, lhs_operands, lhs_specs, rhs_operands, rhs_specs,
        epi_operands, epi_specs, *, rows: int, k_dim: int, n_dim: int,
        acc_dtype: torch.dtype, out_cols: Sequence[int],
        out_dtypes: Sequence[torch.dtype], rows_block: int,
        vmem_bytes: int, batch: int = 1) -> tuple:
    """The kernel's plain version: per row block, the lhs prologue on the
    block, ``[rb, K] @ [K, N]`` in f32 against the block's batch slice of
    the weight, the product rounded to its dtype, then the epilogue
    program over the same role views."""
    rb = row_block(rows, epi_specs, n_dim, rows_block, vmem_bytes, batch)
    lhs_full = [_full(s, torch.as_tensor(v), rows, k_dim, n_dim)
                for s, v in zip(lhs_specs, lhs_operands)]
    rhs_full = [_full(s, torch.as_tensor(v), rows, k_dim, n_dim, batch)
                for s, v in zip(rhs_specs, rhs_operands)]
    rhs = (rhs_full[0] if rhs_pro is None else
           run_program(rhs_pro, rhs_full, block_rows=k_dim)[0])
    epi_views = [torch.as_tensor(v).reshape(s[1], s[2])
                 for s, v in zip(epi_specs, epi_operands)]
    dev = rhs.device
    outs = [torch.empty((rows, c), dtype=dt, device=dev)
            for c, dt in zip(out_cols, out_dtypes)]
    rhs32 = rhs.float().reshape(batch, k_dim, n_dim)
    per = rows // batch
    for i in range(rows // rb):
        blocks = [role_block(s, v, i, rb, rows)
                  for s, v in zip(lhs_specs, lhs_full)]
        lhs = blocks[0] if pro is None else \
            run_program(pro, blocks, block_rows=rb)[0]
        acc = (lhs.float() @ rhs32[(i * rb) // per]).to(acc_dtype)
        _epilogue_blocks(epi, outs, acc, epi_specs, epi_views, i, rb, rows)
    return tuple(outs)


# ---------------------------------------------------------------------------
# CUDA code generation
# ---------------------------------------------------------------------------

class CudaEmitter(Emitter):
    """Block-program emission in CUDA C++: one thread evaluates one
    (row, lane) at a time; row values are per-thread scalars."""

    def __init__(self, prog, rows_of, ptr_of, acc_expr=None):
        super().__init__(prog, rows_of)
        self.ptr_of = ptr_of            # per input: the Args member
        self.acc_expr = acc_expr        # lane -> accumulator expression
        self.red_buf = "fm_red"

    def assign(self, name, expr, ct):
        decl = {"f": "float", "i": "long long", "b": "bool"}[ct]
        self.line(f"const {decl} {name} = {expr};")

    def float_lit(self, x):
        s = repr(float(x))
        return s + "f" if ("e" in s or "." in s) else s + ".f"

    def bool_lit(self, x):
        return "true" if x else "false"

    def nan(self):
        return "__int_as_float(0x7fc00000)"

    def inf(self, pos):
        return "__int_as_float(0x7f800000)" if pos else \
            "__int_as_float(0xff800000)"

    def round(self, expr, dtype):
        if dtype == "bfloat16":
            return f"fm_rbf({expr})"
        if dtype == "float16":
            return f"fm_rh({expr})"
        return expr

    def convert(self, expr, have, want):
        if want == "f":
            return f"({expr} ? 1.f : 0.f)" if have == "b" else \
                f"(float)({expr})"
        if want == "b":
            return f"(({expr}) != 0)"
        return f"(long long)({expr})"

    def select(self, c, a, b):
        return f"(({c}) ? ({a}) : ({b}))"

    def logic(self, code, a, b):
        if code == "not":
            return f"(!({a}))"
        return f"(({a}) {'&&' if code == 'and' else '||'} ({b}))"

    def unary(self, code, x):
        table = {
            "neg": f"(-({x}))", "abs": f"fabsf({x})", "exp": f"expf({x})",
            "log": f"logf({x})", "log1p": f"log1pf({x})",
            "expm1": f"expm1f({x})", "tanh": f"tanhf({x})",
            "sqrt": f"sqrtf({x})", "rsqrt": f"rsqrtf({x})",
            "sigmoid": f"(1.f / (1.f + expf(-({x}))))",
            "sin": f"sinf({x})", "cos": f"cosf({x})", "erf": f"erff({x})",
            "floor": f"floorf({x})", "ceil": f"ceilf({x})",
            "recip": f"(1.f / ({x}))",
        }
        return table[code]

    def binary(self, code, a, b):
        if code in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[code]
            return f"({a} {sym} {b})"
        return {"max": f"fmaxf({a}, {b})", "min": f"fminf({a}, {b})",
                "pow": f"powf({a}, {b})"}[code]

    def load(self, k, lane):
        inp: Input = self.prog.inputs[k]
        if inp.role == "acc":
            return self.acc_expr("0" if lane is None else lane)
        row = self.rows_of[k]
        ptr = self.ptr_of[k]
        if lane is None:
            idx = "0" if row is None else f"(size_t)({row})"
            if inp.cols > 1:
                idx = f"{idx} * {inp.cols}"
            val = f"{ptr}[{idx}]"
            return f"fm_f({val})" if ctype(inp.dtype) == "f" else \
                f"({val})"
        idx = f"({lane})" if row is None else \
            f"(size_t)({row}) * {inp.cols} + ({lane})"
        val = f"{ptr}[{idx}]"
        val = f"fm_f({val})" if ctype(inp.dtype) == "f" else f"({val})"
        zero = "0.f" if ctype(inp.dtype) == "f" else "0"
        if lane == "L" and self.lane_bound is not None and \
                self.lane_bound <= inp.cols:
            return val
        return f"((({lane}) >= 0 && ({lane}) < {inp.cols}) ? {val} : {zero})"

    lane_bound: int | None = None

    def reduction(self, r, op, src, cols_in):
        acc = self.fresh()
        init = "0.f" if op.code == "sum" else "__int_as_float(0xff800000)"
        self.line(f"float {acc} = {init};")
        self.line(f"for (int L = threadIdx.x; L < {cols_in}; "
                  "L += blockDim.x) {")
        self.indent += 1
        self.lane_bound = cols_in
        x = self.lane_values(src, "L")
        self.lane_bound = None
        if op.code == "sum":
            self.line(f"{acc} += {x};")
        else:
            self.line(f"{acc} = fmaxf({acc}, {x});")
        self.indent -= 1
        self.line("}")
        res = self.fresh()
        fn = "fm_block_sum" if op.code == "sum" else "fm_block_max"
        self.line(f"const float {res} = "
                  f"{self.round(f'{fn}({acc}, {self.red_buf})', op.dtype)};")
        self.row_memo[r] = res

    def store(self, j, vid, op):
        ct = _CT[op.dtype]
        out = f"a.o{j}"
        if op.cols == 1 and not self.lanedep[vid]:
            x = self.row_memo[vid]
            self.line(f"if (threadIdx.x == 0 && {self.first_chunk}) "
                      f"{out}[row] = {self._to(x, op.dtype, ct)};")
            return
        lo, hi = self.lane_range(op.cols)
        self.line(f"for (int L = {lo}; L < {hi}; L += blockDim.x) {{")
        self.indent += 1
        self.lane_bound = op.cols
        x = self.lane_values(vid, "L")
        self.lane_bound = None
        self.line(f"{out}[(size_t)row * {op.cols} + L] = "
                  f"{self._to(x, op.dtype, ct)};")
        self.indent -= 1
        self.line("}")

    first_chunk = "true"

    def lane_range(self, cols):
        return "threadIdx.x", str(cols)

    @staticmethod
    def _to(x, dtype, ct):
        if ctype(dtype) == "f":
            return f"fm_to<{ct}>({x})"
        return f"({ct})({x})"


class _ChunkEmitter(CudaEmitter):
    """Epilogue without lane reductions: block x covers a lane chunk."""

    first_chunk = "blockIdx.x == 0"

    def __init__(self, *a, chunk: int, **kw):
        super().__init__(*a, **kw)
        self.chunk = chunk

    def lane_range(self, cols):
        return (f"blockIdx.x * {self.chunk} + threadIdx.x",
                f"min({cols}, (int)(blockIdx.x + 1) * {self.chunk})")


def _rows_of(specs: Sequence[tuple], rows: int, rb: int) -> list:
    out = []
    for spec in specs:
        role, op_rows = spec[0], spec[1]
        if role in ("bulk", "acc"):
            out.append("row")
        elif role == "param":
            out.append(None)
        elif role == "rep":
            out.append(f"(pid / {(rows // op_rows) // rb})")
        elif role == "tile":
            out.append(f"((pid % {op_rows // rb}) * {rb} + lr)")
        elif role == "bcast":
            brows, e = bcast_row_expr(spec[3], spec[4], rb, "pid")
            e = e.replace("//", "/")
            out.append(e if brows == 1 else f"({e} * {rb} + lr)")
        else:
            raise ValueError(f"role {role!r} in an epilogue")
    return out


#: lanes of one block of the workspace epilogue kernel: 2,048 on the FMA
#: template; one a thread (256) after the sm90 mainloop and the weight
#: stream, whose few rows (decode's 8) and many K splits would otherwise
#: leave the kernel a handful of blocks
_EPI_CHUNK = 2048
_EPI_CHUNK_NARROW = 256
#: threads of a lane-reduce epilogue block (a row) after those paths
_EPI_ROW_THREADS = 1024


class _ElemEmitter(CudaEmitter):
    """A drhs epilogue: pure elementwise at full output width, evaluated
    for one (row, lane) element of the finished tile and stored once."""

    def store(self, j, vid, op):
        self.lane_bound = op.cols
        x = self.lane_values(vid, "L") if self.lanedep[vid] else \
            self.row_memo[vid]
        self.lane_bound = None
        self.line(f"a.o{j}[(size_t)row * {op.cols} + L] = "
                  f"{self._to(x, op.dtype, _CT[op.dtype])};")


class _Slots:
    """Emission in which the inputs ``slots`` names, read at lane ``L``,
    come from values loaded beforehand: ``fmt`` of the input's slot (the
    loads are issued together, ahead of their first use); any other read
    goes to memory."""

    def __init__(self, *a, slots: dict, fmt: str, **kw):
        super().__init__(*a, **kw)
        self.slots, self.fmt = slots, fmt

    def load(self, k, lane):
        if lane == "L" and k in self.slots:
            return self.fmt.format(self.slots[k])
        return super().load(k, lane)


class _SlotElemEmitter(_Slots, _ElemEmitter):
    """An in-tile epilogue whose float operands at lane ``L`` are
    ``v[slot]``, loaded by the segment's ``epi_ld``."""


class _VecEmitter(_Slots, CudaEmitter):
    """A prologue evaluated at lane ``L`` = ``L0 + e`` of an 8-lane
    chunk: its float bulk inputs at ``L`` are element ``e`` of the
    chunk's loaded values, ``v[slot][e]``."""


def _split_epilogue(epi, rows_of, ptrs, round_acc: str, rb: int,
                    n_dim: int) -> list[str]:
    """An in-tile epilogue of the sm90 mainloop in two steps, so that the
    caller issues several elements' operand loads before it uses any:
    ``epi_ld`` loads the float operands element (row, L) reads at its own
    lane, ``epi_at`` computes from them and the accumulator and stores.
    ``epi_prefetch`` asks L2 for a row's full-width operands."""
    slots = {k: j for j, k in enumerate(
        k for k, inp in enumerate(epi.inputs)
        if inp.role != "acc" and inp.cols > 1 and ctype(inp.dtype) == "f")}
    nb = max(len(slots), 1)
    ld = CudaEmitter(epi, rows_of, ptrs)
    ld.lane_bound = n_dim
    em = _SlotElemEmitter(epi, rows_of, ptrs, lambda lane: f"{round_acc}(acc)",
                          slots=slots, fmt="v[{}]")
    em.indent = 2
    em.body()
    head = [f"    const int pid = row / {rb}, lr = row % {rb};",
            "    (void)pid; (void)lr; (void)a; (void)v;"]
    bulk = [i for i, inp in enumerate(epi.inputs[1:])
            if inp.role == "bulk" and inp.cols == n_dim]
    return [f"  static constexpr int EPI_NB = {nb};",
            "  static __device__ __forceinline__ void epi_ld("
            f"const Args& a, int row, int L, float (&v)[{nb}]) {{"] + head + [
        f"    v[{j}] = {ld.load(k, 'L')};" for k, j in slots.items()] + [
        "  }",
        "  static __device__ __forceinline__ void epi_at("
        f"const Args& a, int row, int L, float acc, const float (&v)[{nb}]) {{"
    ] + head + em.lines + [
        "  }",
        "  static __device__ __forceinline__ void epi_prefetch("
        "const Args& a, int row, int col, int n) {",
        "    (void)a; (void)row; (void)col; (void)n;"] + [
        f"    fm_prefetch(a.e{i} + (size_t)row * {n_dim} + col, n);"
        for i in bulk] + ["  }"]


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _chunk_slots(prog, width: int, dtypes) -> dict:
    """input -> slot of the float bulk inputs an 8-lane accessor loads:
    the bare operand, or each full-width float row input of a prologue."""
    if prog is None:
        return {0: 0}
    slots = {}
    for i, inp in enumerate(prog.inputs):
        if inp.role in ("bulk_k", "bulk_w") and inp.cols == width and \
                dtypes[i] in ("float32", "bfloat16", "float16"):
            slots[i] = len(slots)
    return slots


def _chunk_accessors(prog, fn: str, row_var: str, width: int, ptrs,
                     dtypes, base=None) -> list[str]:
    """The 8-lane accessors of a fwd operand, read along its contiguous
    (lane) axis: ``{fn}_ld`` loads each float bulk input's 8 lanes from
    ``L0`` (16-byte loads where the chunk is whole and aligned, zeros
    past ``lim`` lanes) and ``{fn}_at`` applies the prologue to element
    ``e`` of them.  ``base`` overrides the address of a bare operand."""
    slots = _chunk_slots(prog, width, dtypes)
    inputs = [(ptrs[i], width) for i in slots]
    if prog is None:
        body = ["    return v[0][e];"]
    else:
        rows_of = [row_var if inp.role in ("bulk_k", "bulk_w") else None
                   for inp in prog.inputs]
        em = _VecEmitter(prog, rows_of, [f"a.{p}" for p in ptrs],
                         slots=slots, fmt="v[{}][e]")
        em.indent = 2
        em.lane_memo = {}
        out = prog.outputs[0]
        em.ensure_row_deps(out)
        em.lane_bound = width
        x = em.lane_values(out, "L")
        x = x if ctype(prog.ops[out].dtype) == "f" else f"(float)({x})"
        body = em.lines + [f"    return {x};"]
    nb = max(len(inputs), 1)
    ld = []
    for j, (ptr, cols) in enumerate(inputs):
        addr = base or f"a.{ptr} + (size_t){row_var} * {cols} + L0"
        ld.append(f"    fm_ld8({addr}, lim, v[{j}]);")
    sig = f"const Args& a, int {row_var}, int L0, int b"
    return [f"  static constexpr int {fn.upper()}_NB = {nb};",
            f"  static __device__ __forceinline__ void {fn}_ld({sig}, "
            f"int lim, float (&v)[{nb}][8]) {{",
            f"    (void)a; (void){row_var}; (void)L0; (void)b; (void)lim; "
            "(void)v;"] + ld + ["  }",
            f"  static __device__ __forceinline__ float {fn}_at({sig}, "
            f"const float (&v)[{nb}][8], int e) {{",
            "    (void)a; (void)b; (void)v;", "    const int L = L0 + e;",
            "    (void)L;"] + \
        body + ["  }"]


def gemm_path(form: str, lhs_ct: str, rhs_ct: str, per_rows: int) -> str:
    """The GEMM a segment is generated onto: ``sm90`` (the wgmma
    mainloop), ``stream`` (the weight stream of a bf16 fwd segment below
    64 rows a slice) or ``fma`` (the template's f32 FMA path: f32 and
    f16 products)."""
    from repro_torch.kernels import fused_matmul_bwd as fmb

    if fmb.sm90_eligible(form, lhs_ct, rhs_ct, per_rows):
        return "sm90"
    if fmb.stream_eligible(form, lhs_ct, rhs_ct, per_rows):
        return "stream"
    return "fma"


def segment_source(pro, rhs_pro, epi, lhs_specs, rhs_specs, epi_specs, *,
                   lhs_dtypes, rhs_dtypes, epi_dtypes, out_dtypes,
                   rows: int, k_dim: int, n_dim: int, acc_dtype: str,
                   rows_block: int, vmem_bytes: int, sms: int,
                   form: str = "fwd", batch: int = 1) -> dict:
    """Generate one anchored segment's CUDA code.  Returns its symbol
    name, source text and launch geometry (everything static is baked
    in; the launcher takes only pointers and the stream).

    ``form`` is the contraction: ``fwd`` (x[rows, K] @ w[K, N]),
    ``dlhs`` (g[rows, K] @ w[N, K]^T, the weight given as its forward
    [N, K] rows) or ``drhs`` (x[K, rows]^T @ g[K, N], K the contracted
    token axis).  ``batch`` > 1 contracts each of ``batch`` row slices
    against its own slice of the weight (fwd, dlhs) or of both operands
    (drhs).  The GEMM is the one ``gemm_path`` names."""
    if form not in ("fwd", "dlhs", "drhs"):
        raise ValueError(f"contraction form {form!r}")
    if (rhs_pro is not None and (form != "fwd" or batch > 1)) or \
            (pro is not None and form == "drhs"):
        raise ValueError(f"a {form} anchor with batch {batch} takes no "
                         "prologue on that operand")
    from repro_torch.kernels import fused_matmul_bwd as fmb

    per = rows // batch
    if form == "drhs":
        rb, _ = fmb.drhs_blocks(rows, n_dim, vmem_bytes=vmem_bytes,
                                batch=batch)
        ks, kch = 1, -(-k_dim // BK) * BK
    else:
        rb = row_block(rows, epi_specs, n_dim, rows_block, vmem_bytes, batch)
    mt = min(_pad8(rb), MT_MAX)
    nsub = -(-rb // mt)
    lhs_ct = pro.ops[pro.outputs[0]].dtype if pro else lhs_dtypes[0]
    rhs_ct = rhs_pro.ops[rhs_pro.outputs[0]].dtype if rhs_pro else \
        rhs_dtypes[0]
    if form != "drhs":
        elt = 2 if rhs_dtypes[0] in ("bfloat16", "float16") else 4
        ks, kch = k_splits(rows, rb, k_dim, n_dim, sms, elt)
    # a bf16 segment runs on the Hopper mainloop or (fwd below 64 rows a
    # slice) the weight stream: each its own tile and K split (KCH counts
    # its 64-deep stages); rb stays the reference's row block, which the
    # epilogue's pid / lr read
    path = gemm_path(form, lhs_ct, rhs_ct, per)
    if path == "sm90":
        _, tn, ks = fmb.sm90_tiles(form, rows, k_dim, n_dim, batch, sms)
        kch = -(-(-(-k_dim // fmb.SM90_BK)) // ks)
    elif path == "stream":
        tn, ks = fmb.stream_blocks(rows, k_dim, n_dim, sms, batch)
        kch = -(-(-(-k_dim // fmb.STREAM_BK)) // ks)
    reduce = bool(epi.reductions)
    elementwise = not reduce and not any(op.kind in ("slice", "cat")
                                         for op in epi.ops)
    tile_epi = in_tile(ks, elementwise,
                       [epi.ops[o].cols for o in epi.outputs], n_dim)
    if form == "drhs" and not tile_epi:
        raise ValueError("a drhs epilogue is elementwise at full width")
    smem = epilogue_smem_bytes(n_dim, reduce)
    if reduce and not row_fits(n_dim, vmem_bytes):
        raise ValueError(f"lane-reduce epilogue over N={n_dim} does not fit "
                         "the shared-memory budget")
    shape_key = repr((form, batch, tile_epi, pro, rhs_pro, epi, lhs_specs,
                      rhs_specs,
                      epi_specs, lhs_dtypes, rhs_dtypes, epi_dtypes,
                      out_dtypes, rows, k_dim, n_dim, acc_dtype, rb, ks,
                      kch))
    if path == "sm90":
        tma = _sm90_tma(form, pro, rhs_pro, lhs_specs, k_dim, n_dim, per)
        shape_key += repr(("sm90", tn, tma))
    elif path == "stream":
        # the weight by cp.async where its rows are whole 16-byte chunks
        # and no prologue is evaluated; x is always register-staged
        tma = (rhs_pro is None and n_dim % 8 == 0,)
        shape_key += repr(("stream", tn, tma))
    name = "fm_" + hashlib.sha1(shape_key.encode()).hexdigest()[:16]

    members = ([f"const {_CT[d]}* __restrict__ l{i};"
                for i, d in enumerate(lhs_dtypes)]
               + [f"const {_CT[d]}* __restrict__ w{i};"
                  for i, d in enumerate(rhs_dtypes)]
               + [f"const {_CT[d]}* __restrict__ e{i};"
                  for i, d in enumerate(epi_dtypes)]
               + [f"{_CT[d]}* __restrict__ o{i};"
                  for i, d in enumerate(out_dtypes)])
    src = [f"struct {name}_Args {{"] + [f"  {m}" for m in members] + ["};"]

    def accessor(fn, row_var, lane_var, body):
        return [f"  static __device__ __forceinline__ float {fn}("
                f"const Args& a, int {row_var}, int {lane_var}, int b) {{",
                "    (void)b;"] + body + ["  }"]

    def prologue(prog, fn, row_var, lane_var, roles_ptr, width):
        if prog is None:
            ptr = roles_ptr[0]
            return accessor(fn, row_var, lane_var, [
                f"    return fm_f(a.{ptr}[(size_t){row_var} * {width} + "
                f"{lane_var}]);"])
        rows_of = [row_var if inp.role in ("bulk_k", "bulk_w") else None
                   for inp in prog.inputs]
        em = CudaEmitter(prog, rows_of, [f"a.{p}" for p in roles_ptr])
        em.indent = 2
        em.lane_memo = {}
        out = prog.outputs[0]
        em.ensure_row_deps(out)
        em.lane_bound = width
        x = em.lane_values(out, lane_var)
        x = x if ctype(prog.ops[out].dtype) == "f" else f"(float)({x})"
        return accessor(fn, row_var, lane_var,
                        em.lines + [f"    return {x};"])

    gemm_smem = fmb.sm90_smem_bytes(tn) if path == "sm90" else \
        fmb.stream_smem_bytes(kch) if path == "stream" else 0
    head_fields = (f"  static constexpr int ROWS = {rows}, K = {k_dim}, "
                   f"N = {n_dim}, PER = {per}, BATCH = {batch}, TN = {tn}, "
                   f"KS = {ks}, KCH = {kch}, SMEM = {gemm_smem};"
                   ) if path != "fma" else ""
    if path == "sm90":
        src = ['#include "fused_matmul_sm90.cuh"'] + src + [
            f"struct {name}_S {{",
            f"  using Args = {name}_Args;", head_fields,
            f"  static constexpr bool DRHS = {_cbool(form == 'drhs')}, "
            f"FWD = {_cbool(form == 'fwd')}, IN_TILE = {_cbool(tile_epi)};"]
    elif path == "stream":
        src = ['#include "fused_matmul_stream.cuh"'] + src + [
            f"struct {name}_S {{",
            f"  using Args = {name}_Args;", head_fields,
            f"  static constexpr bool IN_TILE = {_cbool(tile_epi)};"]
    else:
        src += [f"struct {name}_S {{",
                f"  using Args = {name}_Args;",
                f"  static constexpr int ROWS = {rows}, K = {k_dim}, "
                f"N = {n_dim}, RB = {rb}, MT = {mt}, NSUB = {nsub}, "
                f"KS = {ks}, KCH = {kch}, PER = {per};",
                "  static constexpr bool WMMA = false, "
                f"A_ROW_FAST = {_cbool(form == 'drhs')}, "
                f"B_K_FAST = {_cbool(form == 'dlhs')}, "
                f"IN_TILE = {_cbool(tile_epi)};"]
    lhs_ptrs = [f"l{i}" for i in range(len(lhs_dtypes))]
    rhs_ptrs = [f"w{i}" for i in range(len(rhs_dtypes))]
    if form == "drhs":
        # A(r, k) = x[b][k][r - b * PER]: the activation read in place
        src += accessor("lhs", "r", "k", [
            f"    return fm_f(a.l0[((size_t)b * {k_dim} + k) * {per} + "
            f"(r - b * {per})]);"])
        src += accessor("rhs", "k", "n", [
            f"    return fm_f(a.w0[((size_t)b * {k_dim} + k) * {n_dim} + "
            "n]);"])
    elif form == "fwd" and path != "fma":
        # 8 lanes at a time along each operand's contiguous axis: x's k,
        # the weight's n (w[b][k][n] read in place)
        src += _chunk_accessors(pro, "lhs", "r", k_dim, lhs_ptrs,
                                lhs_dtypes)
        src += _chunk_accessors(
            rhs_pro, "rhs", "k", n_dim, rhs_ptrs, rhs_dtypes,
            base=None if batch == 1 else
            f"a.w0 + ((size_t)b * {k_dim} + k) * {n_dim} + L0")
    else:
        src += prologue(pro, "lhs", "r", "L", lhs_ptrs, k_dim)
        if form == "dlhs":
            # B(k, n) = w[b][n][k]: the forward weight's rows, in place
            src += accessor("rhs", "k", "n", [
                f"    return fm_f(a.w0[(size_t)b * {n_dim * k_dim} + "
                f"(size_t)n * {k_dim} + k]);"])
        elif rhs_pro is None and batch > 1:
            src += accessor("rhs", "k", "L", [
                f"    return fm_f(a.w0[(size_t)b * {k_dim * n_dim} + "
                f"(size_t)k * {n_dim} + L]);"])
        else:
            src += prologue(rhs_pro, "rhs", "k", "L", rhs_ptrs, n_dim)

    all_specs = [("acc", rows, n_dim)] + list(epi_specs)
    rows_of = _rows_of(all_specs, rows, rb)
    ptrs = [None] + [f"a.e{i}" for i in range(len(epi_dtypes))]
    round_acc = {"bfloat16": "fm_rbf", "float16": "fm_rh"}.get(acc_dtype, "")
    if tile_epi and path == "sm90":
        src += _split_epilogue(epi, rows_of, ptrs, round_acc, rb, n_dim)
    elif tile_epi:
        em = _ElemEmitter(epi, rows_of, ptrs, lambda lane: f"{round_acc}(acc)")
        em.indent = 2
        em.body()
        src += ["  static __device__ __forceinline__ void epi("
                "const Args& a, int row, int L, float acc) {",
                f"    const int pid = row / {rb}, lr = row % {rb};",
                "    (void)pid; (void)lr;"] + em.lines + ["  }"]
    src += ["};"]

    k = 0
    assign = []
    for pre, dts, const in (("l", lhs_dtypes, True), ("w", rhs_dtypes, True),
                            ("e", epi_dtypes, True), ("o", out_dtypes, False)):
        for i, d in enumerate(dts):
            q = "const " if const else ""
            assign.append(f"  a.{pre}{i} = ({q}{_CT[d]}*)p[{k}];")
            k += 1
    n_tiles = -(-n_dim // BN)

    def head(suffix=""):
        return [f'extern "C" int {name}_launch{suffix}(void* const* p, '
                'void* stream) {', f"  {name}_Args a;"] + assign
    gen = {"name": name, "rb": rb, "ks": 0 if tile_epi else ks, "kch": kch,
           "n_ptrs": k if tile_epi else k + 1, "path": path,
           "smem": gemm_smem, "epi_smem": 0 if tile_epi else smem}
    if path != "fma":
        # one launcher a variant: each operand by TMA (sm90) or cp.async
        # (the stream's weight) where its layout allows, and (if any is)
        # every operand register-staged, for a base that those refuse;
        # ``launch_segment`` picks by the pointers
        staged = (False,) * len(tma)
        variants = [("", tma)] + [("_staged", staged)] * any(tma)
        gen.update(tn=tn, tma=tma, tma_ops=[i for i, ok in zip(
            (0, len(lhs_dtypes)) if path == "sm90" else (len(lhs_dtypes),),
            tma) if ok])

        def run(ab, ws):
            if path == "stream":
                return f"fms_run<{name}_S, {_cbool(ab[0])}>(a, {ws}, s)"
            return (f"fm90_run<{name}_S, {_cbool(ab[0])}, {_cbool(ab[1])}>"
                    f"(a, {ws}, s)")

        # the dynamic shared memory the first variant's GEMM kernel may
        # take, as its launcher set it (read back after a launch)
        kern = (f"fms_gemm<{name}_S, {_cbool(tma[0])}>" if path == "stream"
                else f"fm90_gemm<{name}_S, {_cbool(tma[0])}, "
                f"{_cbool(tma[1])}>")
        src += [f'extern "C" int {name}_smem(void) {{',
                "  cudaFuncAttributes fa;",
                f"  const cudaError_t e = cudaFuncGetAttributes(&fa, {kern});",
                "  return e == cudaSuccess ? "
                "(int)fa.maxDynamicSharedSizeBytes : -(int)e;", "}"]
    if tile_epi:
        if path != "fma":
            for suffix, ab in variants:
                src += head(suffix) + [
                    "  cudaStream_t s = (cudaStream_t)stream;",
                    f"  return {run(ab, 'nullptr')};", "}"]
        else:
            src += head() + [
                "  cudaStream_t s = (cudaStream_t)stream;",
                f"  fm_gemm<{name}_S><<<dim3({rows // rb}, {n_tiles}, 1), "
                "FM_THREADS, 0, s>>>(a, nullptr);",
                "  return (int)cudaGetLastError();", "}"]
        return {**gen, "source": "\n".join(src) + "\n"}

    # the epilogue kernel reading the workspace
    if reduce:
        def acc_expr(lane):
            return f"fm_row[{lane}]" if lane == "L" else \
                f"((({lane}) >= 0 && ({lane}) < {n_dim}) ? fm_row[{lane}] : 0.f)"
        em = CudaEmitter(epi, rows_of, ptrs, acc_expr)
        grid = f"dim3({rows})"
    else:
        def acc_expr(lane):
            val = f"{round_acc}(fm_acc_sum<{ks}, {rows}, {n_dim}>(ws, row, {lane}))"
            return val if lane == "L" else \
                f"((({lane}) >= 0 && ({lane}) < {n_dim}) ? {val} : 0.f)"
        width = max(epi.ops[o].cols for o in epi.outputs)
        chunk = _EPI_CHUNK if path == "fma" else _EPI_CHUNK_NARROW
        em = _ChunkEmitter(epi, rows_of, ptrs, acc_expr, chunk=chunk)
        grid = f"dim3({-(-width // chunk)}, {rows})"
    em.indent = 1
    em.body()
    # a lane-reduce epilogue walks its row in a few passes, a load latency
    # a lane each: after the sm90 mainloop and the weight stream (decode's
    # 8 rows: 8 blocks) a block of 1,024 threads takes a row
    threads = "FM_EPI_THREADS" if path == "fma" or not reduce else \
        str(_EPI_ROW_THREADS)
    epi_head = [f"__global__ void __launch_bounds__({threads}) {name}_epi("
                f"{name}_Args a, const float* __restrict__ ws) {{"]
    if reduce:
        epi_head += ["  extern __shared__ float fm_row[];",
                     "  __shared__ float fm_red[32];",
                     "  const int row = blockIdx.x;"]
    else:
        epi_head += ["  const int row = blockIdx.y;"]
    epi_head += [f"  const int pid = row / {rb};",
                 f"  const int lr = row % {rb};",
                 "  (void)pid; (void)lr;"]
    if reduce:
        if path != "fma":
            # few rows (decode's 8) over many K splits: several lanes'
            # split sums in flight a thread
            epi_head += ["#pragma unroll 4"]
        epi_head += [f"  for (int c = threadIdx.x; c < {n_dim}; c += blockDim.x)",
                     f"    fm_row[c] = {round_acc}(fm_acc_sum<{ks}, {rows}, "
                     f"{n_dim}>(ws, row, c));",
                     "  __syncthreads();"]
    src += epi_head + em.lines + ["}"]

    for suffix, ab in variants if path != "fma" else [("", None)]:
        src += head(suffix) + [
            f"  float* ws = (float*)p[{k}];",
            "  cudaStream_t s = (cudaStream_t)stream;"]
        if path != "fma":
            src += [f"  cudaError_t e = (cudaError_t){run(ab, 'ws')};"]
        else:
            src += [f"  fm_gemm<{name}_S><<<dim3({rows // rb}, {n_tiles}, "
                    f"{ks}), FM_THREADS, 0, s>>>(a, ws);",
                    "  cudaError_t e = cudaGetLastError();"]
        src += ["  if (e != cudaSuccess) return (int)e;"]
        if smem > 48 * 1024:
            src += [f"  e = cudaFuncSetAttribute({name}_epi, "
                    f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
                    "  if (e != cudaSuccess) return (int)e;"]
        src += [f"  {name}_epi<<<{grid}, {threads}, {smem}, s>>>(a, ws);",
                "  return (int)cudaGetLastError();", "}"]
    return {**gen, "source": "\n".join(src) + "\n"}


def _sm90_tma(form: str, pro, rhs_pro, lhs_specs, k_dim: int, n_dim: int,
              per: int) -> tuple[bool, bool]:
    """Which operands of an sm90 segment TMA can load, from the shapes:
    rows of a multiple of 16 bytes (8 bf16), an lhs that is the bare
    [rows, K] activation or cotangent for dlhs and fwd, and a bare bf16
    weight for fwd (a prologue is evaluated by the loading threads).
    The bases are checked at launch."""
    if form == "drhs":
        return per % 8 == 0, n_dim % 8 == 0
    a = pro is None and lhs_specs[0][0] == "bulk_k" and k_dim % 8 == 0
    if form == "fwd":
        return a, rhs_pro is None and n_dim % 8 == 0
    return a, k_dim % 8 == 0


def _cbool(x: bool) -> str:
    return "true" if x else "false"


# ---------------------------------------------------------------------------
# One translation unit per plan
# ---------------------------------------------------------------------------

_HEADER = (f"constexpr int FM_BN = {BN};  // output columns of a block\n"
           f"constexpr int FM_BK = {BK};   // K depth of one staged tile\n"
           '#include "fused_matmul.cuh"\n\n')
_SEGMENTS: dict[str, str] = {}          # symbol -> source of its segment
_LIB_OF: dict[str, ctypes.CDLL] = {}    # symbol -> built library
_PENDING: dict[str, list[str]] = {}     # symbol -> the TU it was prepared in


def translation_unit(symbols: Sequence[str]) -> str:
    return _HEADER + "\n".join(_SEGMENTS[s] for s in sorted(set(symbols)))


def prepare_library(gens: Sequence[dict]) -> list[str]:
    """Register the generated segments of one plan as one translation
    unit, built at the first launch of any of them.  Returns the
    symbols (deduplicated)."""
    syms = sorted({g["name"] for g in gens})
    for g in gens:
        _SEGMENTS[g["name"]] = g["source"]
    for s in syms:
        if s not in _LIB_OF:
            _PENDING[s] = syms
    return syms


def start_library(symbols: Sequence[str], *, verbose: bool = False):
    """Start the ``nvcc`` of the translation unit of ``symbols`` (for
    ``finish_library``), so that several builds run together."""
    return list(symbols), _build.start_generated(
        translation_unit(symbols), verbose=verbose)


def finish_library(started) -> tuple[ctypes.CDLL, str]:
    """Wait for a started build; returns the library and the compiler's
    output (``-Xptxas -v`` resource usage when verbose)."""
    symbols, (name, handle) = started
    lib, log = _build.finish_generated(name, handle)
    for s in symbols:
        _LIB_OF[s] = lib
        _PENDING.pop(s, None)
    return lib, log


def build_library(symbols: Sequence[str], *, verbose: bool = False
                  ) -> tuple[ctypes.CDLL, str]:
    """Build (or load) the translation unit of ``symbols``."""
    return finish_library(start_library(symbols, verbose=verbose))


def _symbol_lib(name: str) -> ctypes.CDLL:
    lib = _LIB_OF.get(name)
    if lib is None:
        lib, _ = build_library(_PENDING.get(name, [name]))
    return lib


def _launcher(lib: ctypes.CDLL, symbol: str):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fm_error.argtypes = [ctypes.c_int]
        lib.fm_error.restype = ctypes.c_char_p
    return fn


_GEN: dict[tuple, dict] = {}

#: the variants of the sm90 mainloop and of the weight stream, as
#: ``kernel_guard().variants`` counts them: every operand by TMA (the
#: stream's weight by cp.async), or one or more register-staged (a
#: prologue, a layout or a base that TMA / cp.async refuse)
SM90_TMA, SM90_STAGED = "sm90 TMA", "sm90 register-staged"
STREAM_ASYNC, STREAM_STAGED = "stream cp.async", "stream register-staged"


def sm90_variant(gen: dict, operands: Sequence[torch.Tensor]
                 ) -> tuple[str, str]:
    """``(launcher suffix, variant)`` an sm90 or weight-stream segment
    launches on these operands: the TMA / cp.async launcher when every
    operand it loads that way has a 16-byte aligned base, else the one
    that stages every operand through registers."""
    fast, staged = (STREAM_ASYNC, STREAM_STAGED) \
        if gen.get("path") == "stream" else (SM90_TMA, SM90_STAGED)
    aligned = all(operands[i].data_ptr() % 16 == 0 for i in gen["tma_ops"])
    if gen["tma_ops"] and not aligned:
        return "_staged", staged
    return "", fast if all(gen["tma"]) else staged


def generate(pro, rhs_pro, epi, lhs_operands, lhs_specs, rhs_operands,
             rhs_specs, epi_operands, epi_specs, *, rows, k_dim, n_dim,
             acc_dtype, out_dtypes, rows_block, vmem_bytes, sms,
             form: str = "fwd", batch: int = 1) -> dict:
    """``segment_source`` for concrete operands (dtypes read off them),
    generated once per distinct segment."""
    key = (form, batch, pro and pro.key, rhs_pro and rhs_pro.key, epi.key,
           tuple(map(tuple, lhs_specs)), tuple(map(tuple, rhs_specs)),
           tuple(map(tuple, epi_specs)),
           tuple(v.dtype for v in (*lhs_operands, *rhs_operands,
                                   *epi_operands)),
           tuple(out_dtypes), rows, k_dim, n_dim, acc_dtype, rows_block,
           vmem_bytes, sms)
    gen = _GEN.get(key)
    if gen is None:
        gen = _GEN[key] = segment_source(
            pro, rhs_pro, epi, tuple(map(tuple, lhs_specs)),
            tuple(map(tuple, rhs_specs)), tuple(map(tuple, epi_specs)),
            lhs_dtypes=tuple(dtype_name(v.dtype) for v in lhs_operands),
            rhs_dtypes=tuple(dtype_name(v.dtype) for v in rhs_operands),
            epi_dtypes=tuple(dtype_name(v.dtype) for v in epi_operands),
            out_dtypes=tuple(dtype_name(d) for d in out_dtypes), rows=rows,
            k_dim=k_dim, n_dim=n_dim, acc_dtype=dtype_name(acc_dtype),
            rows_block=rows_block, vmem_bytes=vmem_bytes, sms=sms,
            form=form, batch=batch)
    return gen


def donation_refusal(gen: dict, epi: BlockProgram, *, n_dim: int,
                     out_cols: Sequence[int], operand: int,
                     output: int) -> str | None:
    """Why the anchored segment's kernels cannot write output ``output``
    into the buffer of epilogue operand ``operand``, or None.  Every
    epilogue (in the GEMM's tile, after a K split, the weight stream's
    split sum) reads an element of a bulk operand and writes the same
    element of an output of the product's width, so it may do so where
    the output has the product's width, no lane slice or concat reads
    other lanes, and no read of the operand follows the output's write
    in the generated source (``read_after_write``; an L2 prefetch is no
    read)."""
    if out_cols[output] != n_dim:
        return (f"the output is {out_cols[output]} lanes wide, not the "
                f"product's {n_dim}")
    if any(op.kind in ("slice", "cat") for op in epi.ops):
        return ("a lane slice or concat reads lanes that another thread "
                "writes")
    at = read_after_write(gen["source"],
                          [f"a.e{operand}[", f"a.e{operand} +"],
                          f"a.o{output}[", ignore=("fm_prefetch",))
    if at is not None:
        return (f"line {at} of the generated kernel reads the operand after "
                "the output's write")
    return None


def launch_segment(kernel: str, gen: dict, operands: Sequence[torch.Tensor],
                   *, rows: int, n_dim: int, out_cols: Sequence[int],
                   out_dtypes: Sequence[torch.dtype],
                   targets: Sequence | None = None) -> tuple:
    """Launch one generated anchored segment (any form) on CUDA tensors
    already in the layout its accessors read; one ``[rows, out_cols[j]]``
    tensor per output: ``targets[j]`` where given (a donated operand's
    buffer, ``donation_targets``), else a fresh one.  Counts one launch
    of ``kernel``.  Raises on a build or launch failure; nothing falls
    back."""
    if not all(v.is_cuda for v in operands):
        raise RuntimeError(
            f"{kernel} launches a CUDA kernel: every operand must be a "
            "CUDA tensor (CPU tensors take the plain version)")
    _SEGMENTS.setdefault(gen["name"], gen["source"])
    dev = operands[0].device
    targets = targets or [None] * len(out_cols)
    outs = [t if t is not None else torch.empty((rows, c), dtype=dt,
                                                device=dev)
            for t, c, dt in zip(targets, out_cols, out_dtypes)]
    bufs = [*operands, *outs]
    if gen["ks"]:
        bufs.append(torch.empty((gen["ks"] * rows * n_dim,),
                                dtype=torch.float32, device=dev))
    ptrs = (ctypes.c_void_p * len(bufs))(*[t.data_ptr() for t in bufs])
    suffix, variant = "", None
    if gen.get("path") in ("sm90", "stream"):
        suffix, variant = sm90_variant(gen, operands)
    lib = _symbol_lib(gen["name"])
    launch = _launcher(lib, f"{gen['name']}_launch{suffix}")
    with torch.cuda.device(dev):
        code = launch(ptrs, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        ops = ", ".join(f"{tuple(v.shape)} {v.dtype} stride {v.stride()} "
                        f"at {v.data_ptr():#x}" for v in operands)
        raise RuntimeError(
            f"{kernel} launch failed: {lib.fm_error(code).decode()} "
            f"(code {code}; segment {gen['name']}{suffix}, "
            f"{gen.get('path', 'fma')}; operands {ops})")
    kernel_guard().count_launch(kernel)
    if variant is not None:
        kernel_guard().count_variant(kernel, gen["name"], variant)
    return tuple(outs)


def launched_smem(gen: dict) -> int:
    """The dynamic shared memory the GEMM kernel of an sm90 or
    weight-stream segment (its TMA / cp.async variant) may take, read
    back from the loaded kernel (``cudaFuncGetAttributes``'
    ``maxDynamicSharedSizeBytes``): after its first launch, what the
    launcher set."""
    fn = getattr(_symbol_lib(gen["name"]), f"{gen['name']}_smem")
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def epilogue_views(epi_operands, epi_specs) -> list[torch.Tensor]:
    """The epilogue operands as the 2-D views the generated code reads."""
    return [torch.as_tensor(v).reshape(s[1], s[2]).contiguous()
            for v, s in zip(epi_operands, epi_specs)]


def fused_matmul_segment(pro, rhs_pro, epi, lhs_operands, lhs_specs,
                         rhs_operands, rhs_specs, epi_operands, epi_specs, *,
                         rows: int, k_dim: int, n_dim: int,
                         acc_dtype: torch.dtype, out_cols: Sequence[int],
                         out_dtypes: Sequence[torch.dtype], rows_block: int,
                         vmem_bytes: int, sms: int, batch: int = 1,
                         donate: Sequence[tuple[int, int]] = ()) -> tuple:
    """Launch the anchored segment's CUDA kernels (the GEMM, then the
    epilogue) on CUDA tensors; one ``[rows, out_cols[j]]`` tensor per
    output, written into epilogue operand ``bi``'s buffer for each
    ``donate`` pair ``(bi, j)``.  One call counts as one launch.  Raises
    on anything the kernel does not take; never falls back to the plain
    version."""
    gen = generate(pro, rhs_pro, epi, lhs_operands, lhs_specs, rhs_operands,
                   rhs_specs, epi_operands, epi_specs, rows=rows, k_dim=k_dim,
                   n_dim=n_dim, acc_dtype=acc_dtype, out_dtypes=out_dtypes,
                   rows_block=rows_block, vmem_bytes=vmem_bytes, sms=sms,
                   batch=batch)
    views = [v.reshape(s[1], s[2]).contiguous() if s[0] in (
        "param_k", "param_w") else v.contiguous()
        for v, s in zip([*lhs_operands, *rhs_operands],
                        [*lhs_specs, *rhs_specs])]
    targets = donation_targets(epi_operands, donate, rows=rows,
                               out_cols=out_cols, out_dtypes=out_dtypes)
    views += epilogue_views(epi_operands, epi_specs)
    return launch_segment(KERNEL, gen, views, rows=rows, n_dim=n_dim,
                          out_cols=out_cols, out_dtypes=out_dtypes,
                          targets=targets)
