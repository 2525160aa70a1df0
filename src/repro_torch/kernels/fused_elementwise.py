"""Fused elementwise segments: the Triton kernel, its wrapper and its
plain version (B2).

``fused_segment_grid`` replaces the TPU kernel of the same name in
``repro/kernels/fused_elementwise.py`` (``pl.pallas_call`` at :278, and
the legacy ``fused_elementwise`` / ``fused_segment`` at :77): one pass
over a row grid that evaluates a segment's block program — elementwise
ops, lane reductions, lane slices and concats — on every operand's own
2-D view and writes each output once.  Operand roles are integer
arithmetic on the program id: ``bulk`` row ``i``, ``param`` row 0,
``rep`` ``i // q``, ``tile`` ``i % p``, ``bcast`` the
``_bcast_row_index`` arithmetic, emitted as code.

On Hopper the pass is bound by bytes (a few operations per element
against 295 bf16 operations per byte of the card's balance).  The
kernel is generated per segment from its block program
(``codegen.py``): a program holds ``segment_row_block`` rows, walks them
in register-sized row chunks and each lane extent in power-of-two lane
chunks with masks (the decode step's lanes are 128, 2048 and 6144 wide);
a lane reduction is one loop over the row's lanes before the loop that
reads it, so nothing but the outputs is ever stored.  Each generated
kernel is written to ``build/triton_src/<hash>.py`` and imported from
there (``@triton.jit`` reads real source); Triton's cache lives in
``build/triton_cache``.  ``triton`` is imported only when a kernel is
launched.

``fused_segment_grid_plain`` beside it walks the same row-block grid
over the same role views and evaluates the same block program op by op
in PyTorch.
"""
from __future__ import annotations

import importlib.util
import math
import os
from typing import Callable, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blockprog import (
    BlockProgram,
    Input,
    dtype_name,
    run_program,
)
from repro_torch.kernels.codegen import Emitter, bcast_row_expr, ctype
from repro_torch.kernels.guard import kernel_guard

KERNEL = "fused_segment_grid"
#: elements of one row-chunk x lane-chunk tile a program holds per value
_TILE_ELEMS = 4096
_MAX_LANES = 1024
#: warps of one program (a 4096-element tile is 32 values a thread)
_NUM_WARPS = 4

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


class TritonEmitter(Emitter):
    """Block-program emission in Triton: a row value is ``[RS, 1]``, a
    lane value ``[RS, BC]`` or ``[1, BC]`` (row-independent roles)."""

    def __init__(self, prog, rows_of, rs: int, bc: int):
        super().__init__(prog, [r[0] for r in rows_of])
        self.varying = [r[1] for r in rows_of]
        self.rs, self.bc = rs, bc

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
        row, varying = self.rows_of[k], self.varying[k]
        masks = ["rmask"] if varying else []
        if lane is None:
            off = row if row is not None else "0"
            if inp.cols > 1:
                off = f"({off}) * {inp.cols}"
        else:
            off = f"({lane})" if row is None else \
                f"({row}) * {inp.cols} + ({lane})"
            masks += [f"(({lane}) >= 0)", f"(({lane}) < {inp.cols})"]
        mask = " & ".join(masks)
        load = (f"tl.load(in{k} + {off}, mask={mask}, other=0)" if mask
                else f"tl.load(in{k} + {off})")
        if ctype(inp.dtype) == "f":
            return f"{load}.to(tl.float32)"
        return load

    def reduction(self, r, op, src, cols_in):
        rs, bc = self.rs, self.bc
        acc = self.fresh()
        if op.code == "sum":
            self.line(f"{acc} = tl.zeros([{rs}, {bc}], dtype=tl.float32)")
        else:
            self.line(f"{acc} = tl.full([{rs}, {bc}], float('-inf'), "
                      "dtype=tl.float32)")
        self.line(f"for c0 in range(0, {cols_in}, {bc}):")
        self.indent += 1
        self.line(f"L = c0 + tl.arange(0, {bc})[None, :]")
        x = self.lane_values(src, "L")
        m = f"rmask & (L < {cols_in})"
        if op.code == "sum":
            self.line(f"{acc} = {acc} + tl.where({m}, {x}, 0.0)")
        else:
            self.line(f"{acc} = tl.maximum({acc}, tl.where({m}, {x}, "
                      "float('-inf')))")
        self.indent -= 1
        res = self.fresh()
        fn = "tl.sum" if op.code == "sum" else "tl.max"
        self.line(f"{res} = {self.round(f'{fn}({acc}, axis=1)[:, None]', op.dtype)}")
        self.row_memo[r] = res

    def store(self, j, vid, op):
        dt = _TL_DTYPE[op.dtype]
        zero = "0" if ctype(op.dtype) != "f" else "0.0"
        if op.cols == 1 and not self.lanedep[vid]:
            x = self.row_memo[vid]
            self.line(f"tl.store(out{j} + grow, tl.where(rmask, {x}, {zero})"
                      f".to({dt}), mask=rmask)")
            return
        bc = self.bc
        self.line(f"for c0 in range(0, {op.cols}, {bc}):")
        self.indent += 1
        self.line(f"L = c0 + tl.arange(0, {bc})[None, :]")
        x = self.lane_values(vid, "L")
        m = f"rmask & (L < {op.cols})"
        self.line(f"tl.store(out{j} + grow * {op.cols} + L, tl.where({m}, "
                  f"{x}, {zero}).to({dt}), mask={m})")
        self.indent -= 1


def grid_geometry(prog: BlockProgram, rows: int, specs: Sequence[tuple],
                  rows_block: int) -> dict:
    """Static launch geometry of the Triton kernel for ``prog``."""
    rb, pad, _ = segment_row_block(rows, specs, rows_block)
    widest = max([op.cols for op in prog.ops] + [1])
    bc = min(_pow2(widest), _MAX_LANES)
    rs = max(1, min(_pow2(rb), _TILE_ELEMS // bc))
    return {"rb": rb, "pad": pad, "grid": (rows + pad) // rb, "rs": rs,
            "bc": bc}


def triton_source(prog: BlockProgram, *, rows: int, specs: Sequence[tuple],
                  rows_block: int) -> tuple[str, str, dict]:
    """``(kernel name, module source, geometry)`` of the Triton kernel
    evaluating ``prog`` over a ``rows``-row grid."""
    geo = grid_geometry(prog, rows, specs, rows_block)
    rb = geo["rb"]
    rows_of = []
    for spec in specs:
        role, op_rows = spec[0], spec[1]
        if role in ("bulk", "acc"):
            rows_of.append(("grow", True))
        elif role == "param":
            rows_of.append((None, False))
        elif role == "rep":
            rows_of.append((f"(pid // {(rows // op_rows) // rb})", False))
        elif role == "tile":
            rows_of.append((f"((pid % {op_rows // rb}) * {rb} + lr)", True))
        elif role == "bcast":
            brows, e = bcast_row_expr(spec[3], spec[4], rb, "pid")
            rows_of.append((e, False) if brows == 1 else
                           (f"({e} * {rb} + lr)", True))
        else:
            raise ValueError(f"role {role!r} in a grid segment")
    em = TritonEmitter(prog, rows_of, geo["rs"], geo["bc"])
    em.indent = 2
    em.body()
    ins = [f"in{k}" for k in range(len(prog.inputs))]
    outs = [f"out{j}" for j in range(len(prog.outputs))]
    name = f"seg_{prog.key}_{rows}_{rb}"
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
        "    pid = tl.program_id(0)",
        f"    for r0 in range(0, {rb}, {geo['rs']}):",
        f"        lr = r0 + tl.arange(0, {geo['rs']})[:, None]",
        f"        grow = pid * {rb} + lr",
        f"        rmask = (lr < {rb}) & (grow < {rows})",
    ]
    return name, "\n".join(head + em.lines) + "\n", geo


_KERNELS: dict[str, Callable] = {}
#: (program key, rows, specs, rows_block) -> (name, kernel, geometry)
_BY_KEY: dict[tuple, tuple] = {}
#: registers and spills per thread of each compiled kernel, by name
COMPILED: dict[str, tuple[int | None, int | None]] = {}


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


def fused_segment_grid(prog: BlockProgram, operands: Sequence[torch.Tensor],
                       specs: Sequence[tuple], *, rows: int,
                       out_cols: Sequence[int],
                       out_dtypes: Sequence[torch.dtype],
                       rows_block: int = 512) -> tuple:
    """Launch the Triton kernel of ``prog`` on CUDA tensors; one
    ``[rows, out_cols[j]]`` tensor per output.  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    if not operands or not all(torch.as_tensor(v).is_cuda for v in operands):
        raise RuntimeError(
            "fused_segment_grid launches a Triton kernel: every operand "
            "must be a CUDA tensor (CPU tensors take the plain version)")
    if len(specs) != len(prog.inputs) or len(out_cols) != len(prog.outputs):
        raise ValueError("operands / outputs do not match the program")
    views = []
    for spec, inp, v in zip(specs, prog.inputs, operands):
        if dtype_name(v.dtype) != inp.dtype:
            raise TypeError(f"operand dtype {v.dtype} != program {inp.dtype}")
        views.append(v.reshape(spec[1], spec[2]).contiguous())
    key = (prog.key, rows, tuple(map(tuple, specs)), rows_block)
    hit = _BY_KEY.get(key)
    if hit is None:
        name, source, geo = triton_source(prog, rows=rows, specs=specs,
                                          rows_block=rows_block)
        hit = _BY_KEY[key] = (name, _triton_kernel(name, source), geo)
    name, kernel, geo = hit
    dev = views[0].device
    outs = [torch.empty((rows, c), dtype=dt, device=dev)
            for c, dt in zip(out_cols, out_dtypes)]
    # no multiply-add contraction: eager PyTorch rounds every op's result,
    # and a bf16 `a * b + c` contracted into one fma skips a rounding
    with torch.cuda.device(dev):
        compiled = kernel[(geo["grid"],)](*views, *outs, num_warps=_NUM_WARPS,
                                          enable_fp_fusion=False)
    if name not in COMPILED:
        COMPILED[name] = (getattr(compiled, "n_regs", None),
                          getattr(compiled, "n_spills", None))
    kernel_guard().count_launch(KERNEL)
    return tuple(outs)
