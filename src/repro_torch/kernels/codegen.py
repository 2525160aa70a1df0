"""Emit a block program as kernel code: Triton (``fused_segment_grid``)
and CUDA C++ (the prologues and epilogue of ``fused_matmul_segment``).

Both emitters evaluate every value as an expression of a row index and
a lane index, so lane slices and concats are index arithmetic and no
intermediate is ever stored.  A lane reduction is a loop over the lanes
of its input (re-evaluating the input expression from the loads) that
leaves one value per row; values that do not vary along the lanes (row
statistics, ``[*, 1]`` operands) are computed once per row, before the
loops that read them; every output is a last loop over its lanes.

Floating values are held in f32; a value whose graph dtype is bf16 or
f16 is rounded to it after the op that makes it, as eager PyTorch
rounds each op's result.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.kernels.blockprog import BlockProgram, Op

_FLOAT = ("float32", "bfloat16", "float16")


def ctype(dtype: str) -> str:
    """Compute class of a dtype: ``f`` (held in f32), ``i`` or ``b``."""
    if dtype in _FLOAT:
        return "f"
    return "b" if dtype == "bool" else "i"


def bcast_row_expr(op_lead: tuple, out_lead: tuple, rb: int,
                   i: str) -> tuple[int, str]:
    """Source text of ``_bcast_row_index``: the block extent and the
    operand's block-row index as integer arithmetic on the row-block
    index ``i`` (an expression).  Unrolled over the static dims."""
    inner = out_lead[-1] // rb
    j = f"(({i}) // {inner})"
    terms: list[str] = []
    stride = 1 if op_lead[-1] == 1 else inner
    if op_lead[-1] != 1:
        terms.append(f"(({i}) % {inner})")
    for od, pd in zip(reversed(out_lead[:-1]), reversed(op_lead[:-1])):
        d = f"({j} % {od})"
        if pd != 1:
            terms.append(f"{d} * {stride}")
            stride *= pd
        j = f"({j} // {od})"
    expr = " + ".join(terms) if terms else "0"
    return (1 if op_lead[-1] == 1 else rb), f"({expr})"


def bcast_row_of(op_lead: tuple, out_lead: tuple, row: str) -> str:
    """Source text of an interior-broadcast ("bcast") operand's row read
    by output row ``row`` (an expression): the row decomposes over the
    output's leading dims and only the operand's non-broadcast dims
    contribute — ``_bcast_row_index``'s arithmetic, free of any row
    block.  Unrolled over the static dims."""
    inner = out_lead[-1]
    j = f"(({row}) // {inner})"
    terms: list[str] = []
    stride = 1
    if op_lead[-1] != 1:
        terms.append(f"(({row}) % {inner})")
        stride = inner
    for od, pd in zip(reversed(out_lead[:-1]), reversed(op_lead[:-1])):
        d = f"({j} % {od})"
        if pd != 1:
            terms.append(f"{d} * {stride}")
            stride *= pd
        j = f"({j} // {od})"
    return f"({' + '.join(terms) if terms else '0'})"


class Emitter:
    """Language-neutral emission; subclasses give the syntax."""

    def __init__(self, prog: BlockProgram, rows_of: Sequence[str | None]):
        self.prog = prog
        self.rows_of = rows_of          # per input: row index expr or None
        self.lanedep = prog.lane_dependent()
        self.lines: list[str] = []
        self.indent = 0
        self.row_memo: dict[int, str] = {}
        self.lane_memo: dict[tuple, str] | None = None
        self.n = 0

    # -- plumbing ------------------------------------------------------------
    def line(self, s: str) -> None:
        self.lines.append("    " * self.indent + s)

    def fresh(self) -> str:
        self.n += 1
        return f"v{self.n}"

    def ct(self, vid: int) -> str:
        return ctype(self.prog.ops[vid].dtype)

    def lit(self, x) -> str:
        if isinstance(x, bool):
            return self.bool_lit(x)
        if isinstance(x, float):
            if x != x:
                return self.nan()
            if x in (float("inf"), float("-inf")):
                return self.inf(x > 0)
            return self.float_lit(x)
        if isinstance(x, int):
            return str(x)
        raise ValueError(f"literal {x!r} cannot be emitted")

    # -- values --------------------------------------------------------------
    def value(self, vid: int, lane: str | None) -> str:
        if not self.lanedep[vid]:
            if vid not in self.row_memo:
                raise RuntimeError(f"row value {vid} used before emission")
            return self.row_memo[vid]
        key = (vid, lane)
        if key in self.lane_memo:
            return self.lane_memo[key]
        name = self._emit(vid, lane)
        self.lane_memo[key] = name
        return name

    def arg(self, a, lane: str | None, want: str | None = None) -> str:
        if a[0] == "c":
            x = a[1]
            if want == "f" and type(x) is int:
                x = float(x)
            return self.lit(x)
        expr = self.value(a[1], lane)
        have = self.ct(a[1])
        if want is not None and want != have:
            return self.convert(expr, have, want)
        return expr

    def _emit(self, vid: int, lane: str | None) -> str:
        op: Op = self.prog.ops[vid]
        if op.kind == "in":
            expr = self.load(op.arg, lane if op.cols > 1 else None)
        elif op.kind == "same":
            return self.value(op.args[0][1], lane)
        elif op.kind == "expand":
            src = op.args[0][1]
            return self.value(src, lane if self.prog.ops[src].cols > 1
                              else None)
        elif op.kind == "slice":
            start, _, step = op.params
            inner = f"({lane})" if step == 1 else f"({step} * ({lane}))"
            return self.value(op.args[0][1], f"({inner} + {start})"
                              if start else inner)
        elif op.kind == "cat":
            off, parts = 0, []
            for a in op.args:
                width = self.prog.ops[a[1]].cols
                sub = lane if off == 0 else f"(({lane}) - {off})"
                parts.append((off + width, self.arg(a, sub, ctype(op.dtype))))
                off += width
            expr = parts[-1][1]
            for end, e in reversed(parts[:-1]):
                expr = self.select(f"(({lane}) < {end})", e, expr)
        elif op.kind == "ew":
            expr = self.ew(op, lane)
        else:
            raise RuntimeError(f"{op.kind} is emitted by its own loop")
        expr = self.round(expr, op.dtype)
        name = self.fresh()
        self.assign(name, expr, ctype(op.dtype))
        return name

    def ew(self, op: Op, lane: str | None) -> str:
        code, res = op.code, ctype(op.dtype)
        args = op.args
        if code in ("eq", "ne", "lt", "le", "gt", "ge"):
            cts = [self.ct(a[1]) if a[0] == "v" else
                   ("f" if isinstance(a[1], float) else "i") for a in args]
            want = "f" if "f" in cts else "i"
            a, b = (self.arg(x, lane, want) for x in args)
            sym = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
                   "ge": ">="}[code]
            return f"({a} {sym} {b})"
        if code in ("and", "or"):
            a, b = (self.arg(x, lane, "b") for x in args)
            return self.logic(code, a, b)
        if code == "not":
            return self.logic("not", self.arg(args[0], lane, "b"), None)
        if code == "where":
            c = self.arg(args[0], lane, "b")
            a, b = (self.arg(x, lane, res) for x in args[1:])
            return self.select(c, a, b)
        if code == "cast":
            src = args[0]
            have = self.ct(src[1]) if src[0] == "v" else "f"
            return self.convert(self.arg(src, lane), have, res)
        if code == "copy":
            return self.arg(args[0], lane, res)
        if code == "clamp":
            x = self.arg(args[0], lane, res)
            lo = args[1][1] if len(args) > 1 else None
            hi = args[2][1] if len(args) > 2 else None
            if lo is not None:
                x = self.binary("max", x, self.arg(args[1], lane, res))
            if hi is not None:
                x = self.binary("min", x, self.arg(args[2], lane, res))
            return x
        if code == "pow" and args[1][0] == "c":
            p = args[1][1]
            x = self.arg(args[0], lane, "f")
            if p == 2:
                return f"({x} * {x})"
            if p == 3:
                return f"({x} * {x} * {x})"
            if p == 0.5:
                return self.unary("sqrt", x)
            if p == -1:
                return self.unary("recip", x)
            return self.binary("pow", x, self.lit(float(p)))
        if len(args) == 1:
            return self.unary(code, self.arg(args[0], lane, res))
        a, b = (self.arg(x, lane, res) for x in args)
        return self.binary(code, a, b)

    # -- per-row values and reductions ---------------------------------------
    def ensure_row(self, vid: int) -> None:
        """Emit the lane-independent value ``vid`` (and its lane-
        independent inputs) at row level."""
        if vid in self.row_memo:
            return
        op = self.prog.ops[vid]
        if op.kind == "reduce":
            raise RuntimeError(f"reduction {vid} used before its loop")
        for r in self.prog.refs(op):
            self.ensure_row(r)
        saved, self.lane_memo = self.lane_memo, {}
        self.lanedep[vid] = True        # emit through the lane path once
        name = self.value(vid, None)
        self.lanedep[vid] = False
        self.lane_memo = saved
        self.row_memo[vid] = name

    def ensure_row_deps(self, vid: int, seen: set | None = None) -> None:
        seen = set() if seen is None else seen
        if vid in seen:
            return
        seen.add(vid)
        if not self.lanedep[vid]:
            self.ensure_row(vid)
            return
        for r in self.prog.refs(self.prog.ops[vid]):
            self.ensure_row_deps(r, seen)

    def body(self) -> None:
        """Reductions in order, then every output."""
        prog = self.prog
        for r in prog.reductions:
            op = prog.ops[r]
            src = op.args[0][1]
            self.ensure_row_deps(src)
            self.reduction(r, op, src, prog.ops[src].cols)
        for j, vid in enumerate(prog.outputs):
            self.ensure_row_deps(vid)
            self.store(j, vid, prog.ops[vid])

    def lane_values(self, vid: int, lane: str) -> str:
        self.lane_memo = {}
        return self.value(vid, lane)
