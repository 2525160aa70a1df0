"""Fused elementwise segments: the Triton kernel, its wrapper and its
plain version (B2).

``fused_segment_grid`` replaces the TPU kernel of the same name in
``repro/kernels/fused_elementwise.py`` (``pl.pallas_call`` at :278, and
the legacy ``fused_elementwise`` / ``fused_segment`` at :77): one pass
over a segment's output rows that evaluates its block program —
elementwise ops, lane reductions, lane slices and concats — on every
operand's own 2-D view and writes each output once.  Each operand's row
is integer arithmetic on the output row ``grow`` (``role_rows``):
``bulk`` ``grow``, ``param`` row 0, ``rep`` ``grow // q``, ``tile``
``grow % p``, ``bcast`` the ``_bcast_row_index`` decomposition; no row
block of the TPU's ``BlockSpec`` enters the kernel, which masks its
ragged edge instead of padding.

On Hopper the pass is bound by bytes (a few operations per element
against 295 bf16 operations per byte of the card's balance), so the
design keeps many bytes in flight on all 132 SMs and reads each byte
once (``grid_geometry``):

* ``tile`` (no lane reduction): 2-D tiles of rows x lanes, 4 warps and
  4-16 elements a thread per value (fewer where a program loads many
  operands, as the offloaded AdamW update over several leaves does), so
  a training segment launches thousands of programs;
* ``row`` (lane reductions over at most 8,192 lanes): whole rows a
  program, held in registers, so each operand element is loaded once for
  the reductions and the outputs;
* ``wide`` (wider reduced rows, the vocabulary's): one row a program,
  each pass a loop over lane chunks, the first pass kept in L2
  (``evict_last``) for the next.

In the ``tile`` and ``row`` modes every value lives in one scope, so an
operand is loaded once however many outputs read it.  Streamed operands
load ``evict_first``; rows many programs read (``param``, ``rep``,
``tile``, ``bcast``) ``evict_last``.  Lanes are contiguous in a program
and their counts are literals of the generated source, so Triton moves
them as 16-byte vectors where the lane count allows.  A strided operand
(a head-major view of the attention's activations) is addressed in
place through its own strides (``operand_layout``), not copied.  Each
row's reduction runs in a fixed order, so relaunches are bit-equal; the
order of a lane sum follows the tile (a whole row reduced as a tree in
the ``row`` mode, chunk-wise partial sums in the ``wide`` mode), so it
may differ from the plain version's by rounding.  Each generated kernel
is written to ``build/triton_src/<name>.py`` and imported from there
(``@triton.jit`` reads real source); Triton's cache lives in
``build/triton_cache``.  ``triton`` is imported only when a kernel is
launched.

``fused_segment_grid_plain`` beside it walks the reference's row-block
grid (``segment_row_block``, padding included) over the same role views
and evaluates the same block program op by op in PyTorch.
"""
from __future__ import annotations

import hashlib
import importlib.util
import math
import os
from typing import Callable, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blockprog import (
    DTYPES,
    BlockProgram,
    Input,
    dtype_name,
    run_program,
)
from repro_torch.kernels.codegen import Emitter, bcast_row_of, ctype
from repro_torch.kernels.guard import kernel_guard

KERNEL = "fused_segment_grid"

_TL_DTYPE = {"float32": "tl.float32", "bfloat16": "tl.bfloat16",
             "float16": "tl.float16", "int32": "tl.int32",
             "int64": "tl.int64", "bool": "tl.int1"}


# ---------------------------------------------------------------------------
# Row-block geometry (the reference's helpers, shared with the planner)
# ---------------------------------------------------------------------------

def _largest_divisor_leq(n: int, limit: int) -> int:
    """Largest divisor of ``n`` that is <= ``limit`` (n >= 1)."""
    if n <= limit:
        return n
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= limit:
                best = max(best, d)
            if n // d <= limit:
                best = max(best, n // d)
        d += 1
    return best


def _bcast_row_index(op_lead: tuple, out_lead: tuple,
                     rb: int) -> tuple[int, Callable]:
    """Block extent and row-grid index map of an interior-broadcast
    ("bcast") operand, e.g. [B,1,S,1,D] read against [B,H,S,W,D] rows:
    the row-block index ``i`` decomposes over the output's leading dims
    and only the operand's non-broadcast dims contribute.  Returns
    ``(block_rows, fn)``; ``fn(i)`` is the operand's block index."""
    inner = out_lead[-1] // rb
    if op_lead[-1] == 1:
        def fn(i):
            j = i // inner
            idx = 0
            stride = 1
            for od, pd in zip(reversed(out_lead[:-1]),
                              reversed(op_lead[:-1])):
                d = j % od
                if pd != 1:
                    idx = idx + d * stride
                    stride *= pd
                j = j // od
            return idx
        return 1, fn

    def fn(i):
        j = i // inner
        idx = i % inner
        stride = inner
        for od, pd in zip(reversed(out_lead[:-1]), reversed(op_lead[:-1])):
            d = j % od
            if pd != 1:
                idx = idx + d * stride
                stride *= pd
            j = j // od
        return idx
    return rb, fn


def segment_row_block(rows: int, specs: Sequence[tuple],
                      rows_block: int = 512,
                      donate: bool = False) -> tuple[int, int, bool]:
    """Row-block selection: ``(rb, pad, donate_kept)`` — the block
    extent (the largest divisor of every rep repeat factor, tile period
    and bcast inner extent that fits ``rows_block``), the row padding,
    and whether donation survives the padding."""
    limit = max(min(rows_block, rows), 1)
    g = 0
    for spec in specs:
        role, op_rows = spec[0], spec[1]
        if role == "rep":
            g = math.gcd(g, rows // op_rows)
        elif role == "tile":
            g = math.gcd(g, op_rows)
        elif role == "bcast":
            g = math.gcd(g, spec[4][-1])
    rb = _largest_divisor_leq(g, limit) if g else limit
    pad = (-rows) % rb
    if pad and donate:
        alt = _largest_divisor_leq(rows, limit)
        if alt >= max(limit // 8, 16):
            rb, pad = alt, 0
    return rb, pad, donate and not pad


def role_block(spec: tuple, v: torch.Tensor, i: int, rb: int, rows: int
               ) -> torch.Tensor:
    """The block of one operand that row block ``i`` reads (its 2-D view
    ``v`` is ``[op_rows, cols]``; bulk views are padded to the grid)."""
    role, op_rows = spec[0], spec[1]
    if role in ("param", "param_k", "param_w"):
        return v
    if role in ("bulk", "acc", "bulk_k"):
        return v[i * rb:(i + 1) * rb]
    if role == "rep":
        q = (rows // op_rows) // rb
        return v[i // q:i // q + 1]
    if role == "tile":
        p = op_rows // rb
        return v[(i % p) * rb:(i % p + 1) * rb]
    if role == "bcast":
        brows, fn = _bcast_row_index(spec[3], spec[4], rb)
        j = fn(i)
        return v[j * brows:(j + 1) * brows]
    raise ValueError(f"unknown operand role {role!r}")


def _views(operands: Sequence[torch.Tensor], specs: Sequence[tuple],
           rows: int, pad: int) -> list[torch.Tensor]:
    out = []
    for spec, v in zip(specs, operands):
        role, op_rows, c = spec[0], spec[1], spec[2]
        v = torch.as_tensor(v).reshape(op_rows, c)
        if role in ("bulk", "acc", "bulk_k") and pad:
            v = torch.cat([v, v.new_zeros((pad, c))])
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def fused_segment_grid_plain(prog: BlockProgram,
                             operands: Sequence[torch.Tensor],
                             specs: Sequence[tuple], *, rows: int,
                             out_cols: Sequence[int],
                             out_dtypes: Sequence[torch.dtype],
                             rows_block: int = 512) -> tuple:
    """The kernel's plain version: the same row-block grid over the same
    role views, the same block program evaluated op by op in PyTorch."""
    rb, pad, _ = segment_row_block(rows, specs, rows_block)
    views = _views(operands, specs, rows, pad)
    dev = views[0].device if views else None
    outs = [torch.empty((rows + pad, c), dtype=dt, device=dev)
            for c, dt in zip(out_cols, out_dtypes)]
    for i in range((rows + pad) // rb):
        blocks = [role_block(s, v, i, rb, rows) for s, v in zip(specs, views)]
        for o, val in zip(outs, run_program(prog, blocks, block_rows=rb)):
            o[i * rb:(i + 1) * rb] = val
    return tuple(o[:rows] for o in outs)


# ---------------------------------------------------------------------------
# Triton code generation
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pow2_floor(n: int) -> int:
    return 1 << max(n, 1).bit_length() - 1


def role_rows(specs: Sequence[tuple], rows: int) -> list[str | None]:
    """Per operand, the source text of the row it reads for output row
    ``grow`` (None: a ``param``, row 0 of every program): ``bulk`` the
    row itself, ``rep`` ``grow // q``, ``tile`` ``grow % op_rows``,
    ``bcast`` ``_bcast_row_index``'s decomposition.  No row block enters,
    so a program's tile is free of the planner's ``segment_row_block``."""
    out: list[str | None] = []
    for spec in specs:
        role, op_rows = spec[0], spec[1]
        if role in ("bulk", "acc"):
            out.append("grow")
        elif role == "param":
            out.append(None)
        elif role == "rep":
            out.append(f"(grow // {rows // op_rows})")
        elif role == "tile":
            out.append(f"(grow % {op_rows})")
        elif role == "bcast":
            out.append(bcast_row_of(spec[3], spec[4], "grow"))
        else:
            raise ValueError(f"role {role!r} in a grid segment")
    return out


def operand_layout(v: torch.Tensor, op_rows: int, cols: int):
    """How the kernel addresses an operand's ``[op_rows, cols]`` view in
    place: None where it is contiguous, ``(dims, strides, lane_stride)``
    where its rows decompose over ``dims`` (the leading dims, merged
    where their strides allow) with those element strides, or False
    where it cannot (the wrapper then copies it)."""
    if v.is_contiguous():
        return None
    try:
        w = v.view(op_rows, cols)
        return (op_rows,), (w.stride(0),), w.stride(1)
    except RuntimeError:
        pass
    if v.dim() < 2 or v.shape[-1] != cols or \
            math.prod(v.shape[:-1]) != op_rows:
        return False
    dims: list[int] = []
    strides: list[int] = []
    for d, st in zip(v.shape[:-1], v.stride()[:-1]):
        if d == 1:
            continue
        if dims and strides[-1] == st * d:
            dims[-1] *= d
            strides[-1] = st
        else:
            dims.append(d)
            strides.append(st)
    return tuple(dims) or (1,), tuple(strides) or (0,), v.stride(-1)


def _row_offset(row: str, cols: int, layout) -> str:
    """Element offset of operand row ``row`` (an expression)."""
    if layout is None:
        return f"({row}) * {cols}"
    dims, strides, _ = layout
    terms, inner = [], 1
    for k in range(len(dims) - 1, -1, -1):
        idx = f"(({row}) // {inner})" if inner > 1 else f"({row})"
        if k:
            idx = f"({idx} % {dims[k]})"
        terms.append(f"{idx} * {strides[k]}")
        inner *= dims[k]
    return f"({' + '.join(terms)})"


class TritonEmitter(Emitter):
    """Block-program emission in Triton: a row value is ``[RS, 1]``, a
    lane value ``[RS, BC]`` or ``[1, BC]`` (a ``param`` operand).  In the
    ``tile`` and ``row`` modes every value lives in one scope over the
    program's lanes ``L``, so an operand element is loaded once however
    many reductions and outputs read it; in the ``wide`` mode each pass
    is a loop over lane chunks."""

    def __init__(self, prog, rows_of, roles, geo: dict, layouts,
                 out_layouts):
        super().__init__(prog, rows_of)
        self.roles = roles
        self.geo = geo
        self.layouts = layouts
        self.out_layouts = out_layouts
        self.first_pass = False

    def assign(self, name, expr, ct):
        self.line(f"{name} = {expr}")

    def float_lit(self, x):
        return repr(float(x))

    def bool_lit(self, x):
        return "1" if x else "0"

    def nan(self):
        return "float('nan')"

    def inf(self, pos):
        return "float('inf')" if pos else "float('-inf')"

    def round(self, expr, dtype):
        if dtype == "bfloat16":
            return f"({expr}).to(tl.bfloat16).to(tl.float32)"
        if dtype == "float16":
            return f"({expr}).to(tl.float16).to(tl.float32)"
        return expr

    def convert(self, expr, have, want):
        if want == "f":
            return f"({expr}).to(tl.float32)"
        if want == "b":
            return f"(({expr}) != 0)"
        return f"({expr}).to(tl.int64)"

    def select(self, c, a, b):
        return f"tl.where({c}, {a}, {b})"

    def logic(self, code, a, b):
        if code == "not":
            return f"(({a}) == 0)"
        return f"({a} {'&' if code == 'and' else '|'} {b})"

    def unary(self, code, x):
        table = {
            "neg": f"(-({x}))", "abs": f"tl.abs({x})", "exp": f"tl.exp({x})",
            "log": f"tl.log({x})", "log1p": f"libdevice.log1p({x})",
            "expm1": f"libdevice.expm1({x})",
            "tanh": f"libdevice.tanh({x})", "sqrt": f"libdevice.sqrt({x})",
            "rsqrt": f"libdevice.rsqrt({x})",
            "sigmoid": f"(1.0 / (1.0 + tl.exp(-({x}))))",
            "sin": f"libdevice.sin({x})", "cos": f"libdevice.cos({x})",
            "erf": f"libdevice.erf({x})", "floor": f"libdevice.floor({x})",
            "ceil": f"libdevice.ceil({x})", "recip": f"(1.0 / ({x}))",
        }
        return table[code]

    def binary(self, code, a, b):
        if code in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[code]
            return f"({a} {sym} {b})"
        if code == "max":
            return f"tl.maximum({a}, {b})"
        if code == "min":
            return f"tl.minimum({a}, {b})"
        if code == "pow":
            return f"libdevice.pow({a}, {b})"
        raise ValueError(code)

    def load(self, k, lane):
        inp: Input = self.prog.inputs[k]
        row, layout = self.rows_of[k], self.layouts[k]
        masks = ["rmask"] if row is not None else []
        off = _row_offset(row if row is not None else "0", inp.cols, layout)
        if lane is not None:
            ls = 1 if layout is None else layout[2]
            off = f"{off} + ({lane})" + (f" * {ls}" if ls != 1 else "")
            masks.append(f"(({lane}) < {inp.cols})")
            if lane != "L":
                masks.append(f"(({lane}) >= 0)")
        # a row read by one program only streams; a row many programs
        # read (param, rep, tile, bcast) and a first pass that a second
        # reads again stay in L2
        policy = "evict_first" if self.roles[k] in ("bulk", "acc") and \
            not self.first_pass else "evict_last"
        mask = f", mask={' & '.join(masks)}, other=0" if masks else ""
        load = f"tl.load(in{k} + {off}{mask}, eviction_policy='{policy}')"
        if ctype(inp.dtype) == "f":
            return f"{load}.to(tl.float32)"
        return load

    def lane_values(self, vid: int, lane: str) -> str:
        if self.geo["mode"] == "wide":
            return super().lane_values(vid, lane)
        return self.value(vid, lane)       # one scope: the memo is kept

    def reduction(self, r, op, src, cols_in):
        acc = self.fresh()
        fill = "0.0" if op.code == "sum" else "float('-inf')"
        fn = "tl.sum" if op.code == "sum" else "tl.max"
        if self.geo["mode"] == "row":
            x = self.lane_values(src, "L")
            self.line(f"{acc} = tl.where(rmask & (L < {cols_in}), {x}, "
                      f"{fill})")
        else:
            rs, bc = self.geo["rs"], self.geo["bc"]
            self.line(f"{acc} = tl.full([{rs}, {bc}], {fill}, "
                      "dtype=tl.float32)")
            self.line(f"for c0 in range(0, {cols_in}, {bc}):")
            self.indent += 1
            self.line(f"L = c0 + tl.arange(0, {bc})[None, :]")
            self.first_pass = True
            x = self.lane_values(src, "L")
            self.first_pass = False
            m = f"rmask & (L < {cols_in})"
            if op.code == "sum":
                self.line(f"{acc} = {acc} + tl.where({m}, {x}, 0.0)")
            else:
                self.line(f"{acc} = tl.maximum({acc}, tl.where({m}, {x}, "
                          "float('-inf')))")
            self.indent -= 1
        res = self.fresh()
        self.line(f"{res} = {self.round(f'{fn}({acc}, axis=1)[:, None]', op.dtype)}")
        self.row_memo[r] = res

    def body(self) -> None:
        """Reductions in order, then the row outputs, then every lane
        output in one pass over the lanes."""
        prog = self.prog
        self.lane_memo = {}
        for r in prog.reductions:
            op = prog.ops[r]
            src = op.args[0][1]
            self.ensure_row_deps(src)
            self.reduction(r, op, src, prog.ops[src].cols)
        lane_outs = []
        for j, vid in enumerate(prog.outputs):
            self.ensure_row_deps(vid)
            op = prog.ops[vid]
            if op.cols == 1 and not self.lanedep[vid]:
                # a row statistic: stored once a row (by lane tile 0)
                m = "rmask & (pc == 0)" if self.geo["mode"] == "tile" \
                    else "rmask"
                off = _row_offset("grow", 1, self.out_layouts[j])
                self.line(f"tl.store(out{j} + {off}, "
                          f"({self.row_memo[vid]}).to({_TL_DTYPE[op.dtype]}), "
                          f"mask={m})")
            else:
                lane_outs.append((j, vid, op))
        if not lane_outs:
            return
        if self.geo["mode"] == "wide":
            width = max(op.cols for _, _, op in lane_outs)
            self.line(f"for c0 in range(0, {width}, {self.geo['bc']}):")
            self.indent += 1
            self.line(f"L = c0 + tl.arange(0, {self.geo['bc']})[None, :]")
            self.lane_memo = {}
        for j, vid, op in lane_outs:
            x = self.value(vid, "L")
            layout = self.out_layouts[j]
            ls = 1 if layout is None else layout[2]
            off = _row_offset("grow", op.cols, layout) + " + L" + \
                (f" * {ls}" if ls != 1 else "")
            self.line(f"tl.store(out{j} + {off}, "
                      f"({x}).to({_TL_DTYPE[op.dtype]}), "
                      f"mask=rmask & (L < {op.cols}))")


#: warps of a ``tile`` program; elements a thread holds per loaded value
#: (fewer where a program loads many operands, so that its loads fit the
#: registers: about ``THREAD_VALUES`` a thread in all)
TILE_WARPS = 4
THREAD_ELEMS = (4, 16)
THREAD_VALUES = 256
#: lanes a ``row`` program holds in registers (a reduced row read once);
#: wider rows take the ``wide`` mode: passes over lane chunks
ROW_LANES = 8192
WIDE_LANES = 2048
#: SMs of the card the geometry fills (H100 SXM), the programs per SM a
#: training-size segment should reach, and the least elements a ``row``
#: program keeps while it splits for them (decode's few rows stay in a
#: few programs)
MIN_ROW_TILE = 2048
SMS = 132
PROGRAMS_PER_SM = 4


def grid_geometry(prog: BlockProgram, rows: int, specs: Sequence[tuple],
                  rows_block: int) -> dict:
    """Static launch geometry of the Triton kernel for ``prog``.

    ``rb`` / ``pad`` are the planner's row block (``segment_row_block``;
    the plain version walks it, the kernel does not).  ``mode``:
    ``tile`` (no lane reduction: 2-D tiles of ``rs`` rows x ``bc`` lanes,
    ``col_tiles`` lane tiles a row tile; fewer rows a tile where the grid
    is short of ``PROGRAMS_PER_SM`` programs an SM), ``row`` (lane reductions over at
    most ``ROW_LANES`` lanes: ``rs`` whole rows a program, each operand
    element read once), ``wide`` (wider reduced rows: one row a program,
    each pass a loop over ``bc``-lane chunks, the first pass kept in L2
    for the next).  ``elems``: elements a thread holds per value;
    ``vec``: lanes of one 16-byte vector of the narrowest lane operand (1
    where the lane counts do not keep vectors aligned); ``i64``: element
    offsets that overflow int32."""
    rb, pad, _ = segment_row_block(rows, specs, rows_block)
    outs = [prog.ops[o] for o in prog.outputs]
    widest = max([op.cols for op in prog.ops] + [1])
    out_w = max([op.cols for op in outs] + [1])
    lanes = [(i.cols, i.dtype) for i in prog.inputs if i.cols > 1] + \
        [(op.cols, op.dtype) for op in outs if op.cols > 1]
    vec = 16 // min([DTYPES[dt].itemsize for _, dt in lanes] + [4])
    if any(c % vec for c, _ in lanes):
        vec = 1
    n_in = max(sum(i.cols > 1 for i in prog.inputs), 1)
    elems = max(min(THREAD_ELEMS[1], _pow2_floor(THREAD_VALUES // n_in)),
                THREAD_ELEMS[0], vec)
    if not prog.reductions:
        mode, warps = "tile", TILE_WARPS
        tile = 32 * warps * elems
        bc = min(_pow2(out_w), tile)
        rs = max(1, min(tile // bc, _pow2(rows)))
        col_tiles = -(-out_w // bc)
        # a small segment (decode's) spreads over more programs, down to
        # one 16-byte vector a thread, where the grid is short of the card
        while rs > 1 and elems > vec and \
                -(-rows // rs) * col_tiles < SMS * PROGRAMS_PER_SM:
            rs, elems = rs // 2, elems // 2
    elif widest <= ROW_LANES:
        mode, bc, col_tiles = "row", _pow2(widest), 1
        rs = max(1, min(_pow2(rows), 32 * 8 * elems // bc))
        while rs > 1 and rs * bc > MIN_ROW_TILE and \
                -(-rows // rs) < SMS * PROGRAMS_PER_SM:
            rs //= 2
        warps = max(1, min(16, rs * bc // (32 * elems)))
    else:
        mode, bc, rs, col_tiles, warps = "wide", WIDE_LANES, 1, 1, 8
    programs = -(-rows // rs) * col_tiles
    return {"rb": rb, "pad": pad, "mode": mode, "rs": rs, "bc": bc,
            "col_tiles": col_tiles, "grid": programs, "num_warps": warps,
            "elems": elems, "vec": vec, "i64": rows * widest >= 2 ** 31}


def triton_source(prog: BlockProgram, *, rows: int, specs: Sequence[tuple],
                  rows_block: int, layouts: Sequence | None = None,
                  out_layouts: Sequence | None = None
                  ) -> tuple[str, str, dict]:
    """``(kernel name, module source, geometry)`` of the Triton kernel
    evaluating ``prog`` over ``rows`` output rows.  ``layouts`` (per
    operand) and ``out_layouts`` (per output), ``operand_layout``'s
    answers (None: all contiguous), address strided operands and outputs
    in place; their kernel's name carries a digest of them after the
    planner's symbol ``seg_<program>_<rows>_<rb>``."""
    geo = grid_geometry(prog, rows, specs, rows_block)
    layouts = tuple(layouts or (None,) * len(specs))
    out_layouts = tuple(out_layouts or (None,) * len(prog.outputs))
    cols = [spec[2] for spec in specs] + \
        [prog.ops[o].cols for o in prog.outputs]
    span = max([sum((d - 1) * st for d, st in zip(*lay[:2]))
                + (c - 1) * lay[2]
                for lay, c in zip(layouts + out_layouts, cols) if lay] + [0])
    geo["i64"] = geo["i64"] or span >= 2 ** 31
    em = TritonEmitter(prog, role_rows(specs, rows),
                       [spec[0] for spec in specs], geo, layouts,
                       out_layouts)
    em.indent = 1
    em.body()
    ins = [f"in{k}" for k in range(len(prog.inputs))]
    outs = [f"out{j}" for j in range(len(prog.outputs))]
    name = f"seg_{prog.key}_{rows}_{geo['rb']}"
    if any(layouts + out_layouts):
        name += "_s" + hashlib.sha1(
            repr((layouts, out_layouts)).encode()).hexdigest()[:8]
    rs, bc, ct = geo["rs"], geo["bc"], geo["col_tiles"]
    pid = "tl.program_id(0)" + (".to(tl.int64)" if geo["i64"] else "")
    head = [
        "import triton",
        "import triton.language as tl",
        "try:",
        "    from triton.language.extra import libdevice",
        "except ImportError:",
        "    from triton.language.extra.cuda import libdevice",
        "",
        "",
        "@triton.jit",
        f"def {name}({', '.join(ins + outs)}):",
        f"    pid = {pid}",
    ]
    if geo["mode"] == "tile":
        head += [f"    pr = pid // {ct}",
                 f"    pc = pid % {ct}",
                 f"    L = pc * {bc} + tl.arange(0, {bc})[None, :]"]
    else:
        head += ["    pr = pid"]
        if geo["mode"] == "row":
            head += [f"    L = tl.arange(0, {bc})[None, :]"]
    head += [f"    grow = pr * {rs} + tl.arange(0, {rs})[:, None]",
             f"    rmask = grow < {rows}"]
    return name, "\n".join(head + em.lines) + "\n", geo


_KERNELS: dict[str, Callable] = {}
#: (program key, rows, specs, rows_block, layouts, out_layouts) ->
#: (name, kernel, geometry)
_BY_KEY: dict[tuple, tuple] = {}
#: registers and spills per thread of each compiled kernel and its
#: global loads by vector width, by kernel name (the planner's symbol,
#: and a layout digest where operands are strided)
COMPILED: dict[str, tuple] = {}
#: operands copied to a contiguous block before a launch (those no
#: layout addresses in place), by the planner's symbol
COPIES: dict[str, int] = {}


def _triton_kernel(name: str, source: str) -> Callable:
    """Import the generated kernel from ``build/triton_src`` (written
    once, keyed by its name, which holds the program's hash)."""
    fn = _KERNELS.get(name)
    if fn is not None:
        return fn
    root = _build.build_dir()
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "triton_cache"))
    src_dir = root / "triton_src"
    src_dir.mkdir(parents=True, exist_ok=True)
    path = src_dir / f"{name}.py"
    if not path.exists() or path.read_text() != source:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn = _KERNELS[name] = getattr(module, name)
    return fn


def _load_widths(compiled) -> dict[str, int]:
    """Global loads of the compiled kernel by vector width (``v4``,
    ``v2``, ``scalar``), counted in its PTX."""
    ptx = getattr(compiled, "asm", {}).get("ptx", "")
    out: dict[str, int] = {}
    for ln in ptx.splitlines():
        if "ld.global" in ln:
            w = next((v for v in (".v8.", ".v4.", ".v2.") if v in ln),
                     "scalar")
            out[w.strip(".")] = out.get(w.strip("."), 0) + 1
    return out


def fused_segment_grid(prog: BlockProgram, operands: Sequence[torch.Tensor],
                       specs: Sequence[tuple], *, rows: int,
                       out_cols: Sequence[int],
                       out_dtypes: Sequence[torch.dtype],
                       rows_block: int = 512,
                       out_strides: Sequence | None = None) -> tuple:
    """Launch the Triton kernel of ``prog`` on CUDA tensors; one
    ``[rows, out_cols[j]]`` tensor per output, or, where ``out_strides[j]``
    is ``(shape, strides)``, a tensor of that shape and layout written in
    place.  Raises on anything the kernel does not take; never falls
    back to the plain version."""
    if not operands or not all(torch.as_tensor(v).is_cuda for v in operands):
        raise RuntimeError(
            "fused_segment_grid launches a Triton kernel: every operand "
            "must be a CUDA tensor (CPU tensors take the plain version)")
    if len(specs) != len(prog.inputs) or len(out_cols) != len(prog.outputs):
        raise ValueError("operands / outputs do not match the program")
    views, layouts, copied = [], [], 0
    for spec, inp, v in zip(specs, prog.inputs, operands):
        if dtype_name(v.dtype) != inp.dtype:
            raise TypeError(f"operand dtype {v.dtype} != program {inp.dtype}")
        layout = operand_layout(v, spec[1], spec[2])
        if layout is False:
            v, layout = v.reshape(spec[1], spec[2]).contiguous(), None
            copied += 1
        views.append(v)
        layouts.append(layout)
    dev = views[0].device
    outs, out_layouts = [], []
    for j, (c, dt) in enumerate(zip(out_cols, out_dtypes)):
        layout = None
        if out_strides and out_strides[j] is not None:
            o = torch.empty_strided(*out_strides[j], dtype=dt, device=dev)
            layout = operand_layout(o, rows, c) or None
        if layout is None:
            o = torch.empty((rows, c), dtype=dt, device=dev)
        outs.append(o)
        out_layouts.append(layout)
    key = (prog.key, rows, tuple(map(tuple, specs)), rows_block,
           tuple(layouts), tuple(out_layouts))
    hit = _BY_KEY.get(key)
    if hit is None:
        name, source, geo = triton_source(prog, rows=rows, specs=specs,
                                          rows_block=rows_block,
                                          layouts=layouts,
                                          out_layouts=out_layouts)
        hit = _BY_KEY[key] = (name, _triton_kernel(name, source), geo)
    name, kernel, geo = hit
    if copied:
        symbol = name.partition("_s")[0]
        COPIES[symbol] = COPIES.get(symbol, 0) + copied
    # no multiply-add contraction: eager PyTorch rounds every op's result,
    # and a bf16 `a * b + c` contracted into one fma skips a rounding
    with torch.cuda.device(dev):
        compiled = kernel[(geo["grid"],)](*views, *outs,
                                          num_warps=geo["num_warps"],
                                          enable_fp_fusion=False)
    if name not in COMPILED:
        COMPILED[name] = (getattr(compiled, "n_regs", None),
                            getattr(compiled, "n_spills", None),
                            _load_widths(compiled))
    kernel_guard().count_launch(KERNEL)
    return tuple(outs)
