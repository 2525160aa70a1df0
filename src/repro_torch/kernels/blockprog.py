"""Block programs: the op-table IR of a fused segment.

The offload planner (``repro_torch.core.offload``) turns each segment it
fuses into up to three block programs — the elementwise / lane-reduce
body of a grid segment, or the lhs prologue, weight prologue and
epilogue of a matmul-anchored one.  A block program is a straight-line
list of ops over 2-D blocks of one row block:

* a row value is ``[rows, cols]`` (``cols == 1`` for a row statistic);
* a param value is ``[1, cols]``, the same for every row;
* inputs carry their role (``bulk``, ``param``, ``rep``, ``tile``,
  ``bcast``; ``acc`` for the accumulator of an epilogue; ``bulk_k`` /
  ``param_k`` / ``bulk_w`` / ``param_w`` for prologue operands).

The same program is read three ways: ``run_program`` evaluates it op by
op in PyTorch (the kernels' plain versions), ``triton_source`` in
``fused_elementwise`` and ``cuda_source`` in ``fused_matmul`` emit it as
kernel code.  ``ew_opcode`` is the op table: the elementwise aten ops a
program may hold, each with the opcode the code generators know.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Sequence

import torch

aten = torch.ops.aten

#: dtypes a block program may hold (names as in ``str(torch.float32)[6:]``)
DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool,
}

_UNARY = {
    "neg": "neg", "abs": "abs", "exp": "exp", "log": "log",
    "log1p": "log1p", "expm1": "expm1", "tanh": "tanh", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "sigmoid": "sigmoid", "sin": "sin", "cos": "cos",
    "erf": "erf", "floor": "floor", "ceil": "ceil",
    "reciprocal": "recip", "logical_not": "not",
}
_BINARY = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min", "eq": "eq", "ne": "ne", "lt": "lt",
    "le": "le", "gt": "gt", "ge": "ge", "logical_and": "and",
    "logical_or": "or", "pow": "pow",
}
_CAST_KWARGS_OK = {"dtype", "layout", "device", "pin_memory",
                   "memory_format", "non_blocking"}
#: cast kwargs that place the result, not compute it: a block program
#: leaves them out (its blocks are where its operands are)
PLACEMENT_KWARGS = ("device", "layout", "pin_memory")


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def ew_opcode(target: Any, args: Sequence, kwargs: dict) -> str | None:
    """The opcode of an elementwise aten call, or None when a block
    program cannot hold it (an ``alpha``, a rounding mode, a device
    move)."""
    if not isinstance(target, torch._ops.OpOverload):
        return None
    packet = target.name().partition("::")[2].split(".")[0]
    if packet in ("add", "sub"):
        if kwargs.get("alpha", 1) != 1 or len(args) > 2:
            return None
        return packet
    if packet == "div":
        if kwargs.get("rounding_mode") is not None:
            return None
        return "div"
    if packet in _BINARY and len(args) == 2 and not kwargs:
        return _BINARY[packet]
    if packet in _UNARY and len(args) == 1 and not kwargs:
        return _UNARY[packet]
    if packet == "where" and target._overloadname == "self":
        return "where"
    if packet == "clamp" and not kwargs:
        return "clamp"
    if packet == "clone":
        return "copy"
    if packet == "_to_copy":
        if set(kwargs) - _CAST_KWARGS_OK or kwargs.get("pin_memory"):
            return None
        if kwargs.get("device") is not None:
            # a cast that names its own device (autograd's cast of a
            # cotangent) is a cast; a move to another device is not
            src = args[0].meta.get("val") if args and hasattr(
                args[0], "meta") else None
            if not isinstance(src, torch.Tensor) or \
                    torch.device(kwargs["device"]) != src.device:
                return None
        return "cast"
    return None


def _lit(v: Any) -> Any:
    """A literal argument in a hashable, repr-stable form."""
    if isinstance(v, torch.dtype):
        return ("dtype", dtype_name(v))
    if isinstance(v, (list, tuple)):
        return tuple(_lit(x) for x in v)
    return v


def _unlit(v: Any) -> Any:
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "dtype":
        return DTYPES[v[1]]
    if isinstance(v, tuple):
        return [_unlit(x) for x in v]
    return v


@dataclass(frozen=True)
class Input:
    """One operand of a block program: its role and 2-D view."""

    role: str
    rows: int
    cols: int
    dtype: str
    lead: tuple = ()
    out_lead: tuple = ()


@dataclass(frozen=True)
class Op:
    """One op of a block program.

    ``kind``: ``in`` (``arg`` = input index), ``ew`` (``name`` = aten
    overload, ``code`` = opcode), ``reduce`` (``code`` = sum|max over the
    lanes), ``slice`` (``params`` = start, stop, step on the lanes),
    ``cat`` (lane concat), ``expand`` (broadcast to ``cols`` lanes and
    the block's rows), ``same`` (a view that keeps the 2-D view).
    ``args`` hold ``("v", i)`` value references and ``("c", x)``
    literals."""

    kind: str
    dtype: str
    cols: int
    param: bool = False
    code: str = ""
    name: str = ""
    args: tuple = ()
    kwargs: tuple = ()
    params: tuple = ()
    arg: int = -1


@dataclass(frozen=True)
class BlockProgram:
    inputs: tuple[Input, ...]
    ops: tuple[Op, ...]
    outputs: tuple[int, ...]

    @cached_property
    def key(self) -> str:
        """Content hash, computed once per program object."""
        return hashlib.sha1(repr(self).encode()).hexdigest()[:16]

    def refs(self, op: Op) -> list[int]:
        return [a[1] for a in op.args if a[0] == "v"]

    @property
    def reductions(self) -> list[int]:
        return [i for i, op in enumerate(self.ops) if op.kind == "reduce"]

    def lane_dependent(self) -> list[bool]:
        """Whether each value varies along the lanes (a row statistic,
        a reduction result, a ``[*, 1]`` operand and a literal do not)."""
        dep: list[bool] = []
        for op in self.ops:
            if op.kind == "in":
                dep.append(op.cols > 1)
            elif op.kind in ("slice", "cat"):
                dep.append(True)
            elif op.kind == "reduce":
                dep.append(False)
            else:
                dep.append(any(dep[r] for r in self.refs(op)))
        return dep


# ---------------------------------------------------------------------------
# The plain evaluator: the program op by op in PyTorch.
# ---------------------------------------------------------------------------

def run_program(prog: BlockProgram, blocks: Sequence[torch.Tensor], *,
                block_rows: int) -> list[torch.Tensor]:
    """Evaluate ``prog`` on one row block: ``blocks`` are the inputs'
    2-D blocks (``[block_rows | 1, cols]``).  Every elementwise op is
    the aten op the graph held, called on the blocks, so a value is
    bit-equal to what eager PyTorch computes for the same elements.
    Returns one ``[block_rows, cols]`` block per output."""
    vals: list[Any] = []

    def arg(a):
        return vals[a[1]] if a[0] == "v" else _unlit(a[1])

    for op in prog.ops:
        if op.kind == "in":
            v = blocks[op.arg]
        elif op.kind == "ew":
            target = _resolve(op.name)
            v = target(*[arg(a) for a in op.args],
                       **{k: _unlit(x) for k, x in op.kwargs})
        elif op.kind == "reduce":
            x = arg(op.args[0])
            kw = {k: _unlit(x_) for k, x_ in op.kwargs}
            v = (aten.sum.dim_IntList(x, [1], True, **kw) if op.code == "sum"
                 else aten.amax.default(x, [1], True))
        elif op.kind == "slice":
            start, stop, step = op.params
            v = arg(op.args[0])[:, start:stop:step]
        elif op.kind == "cat":
            parts = [arg(a) for a in op.args]
            r = max(p.shape[0] for p in parts)
            v = torch.cat([p.expand(r, p.shape[1]) for p in parts], 1)
        elif op.kind == "expand":
            v = arg(op.args[0]).expand(1 if op.param else block_rows,
                                       op.cols)
        else:                                   # "same"
            v = arg(op.args[0])
        vals.append(v)
    out = []
    for i in prog.outputs:
        v = vals[i]
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(v, dtype=DTYPES[prog.ops[i].dtype])
        out.append(v.expand(block_rows, prog.ops[i].cols))
    return out


@functools.lru_cache(maxsize=None)
def _resolve(name: str):
    packet, _, overload = name.partition(".")
    return getattr(getattr(aten, packet), overload or "default")
