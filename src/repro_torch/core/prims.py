"""The node-classification registry of the port's offload planner.

The counterpart of ``repro/core/prims.py``.  The JAX package classifies
jaxpr eqns by primitive name; the port classifies the call nodes of an
fx graph captured by ``make_fx`` by **aten overload-packet name**
(``aten.mul.Tensor`` -> ``"mul"``).  Every name here is a real
``torch.ops.aten`` packet (tests check it).

The graph is captured with one fixed decomposition table
(``DECOMPOSITIONS`` below), so that ``silu``, ``gelu``, ``softmax``,
``mean`` and ``split`` reach the planner as the primitive-level chains a
jaxpr would hold (``x * sigmoid(x)``, ``amax/sub/exp/sum/div``, ...),
and so do the derivatives autograd emits for them (``sigmoid_backward``,
``tanh_backward``, ``gelu_backward``, ``silu_backward``), which a
backward plan fuses as it fuses any elementwise chain.
The tables name exactly what that table and the model code emit.

Tier precedence in ``eqn_tier`` is anchor > reduce > near > layout > far.
"""
from __future__ import annotations

import math

import torch

aten = torch.ops.aten

# elementwise near-bank-capable ops (value-chain ALU/SFU ops).
# ``_to_copy`` is the dtype cast (jax's convert_element_type),
# ``clone`` is a copy, ``sigmoid`` is jax's logistic.
ELEMENTWISE_PRIMS = {
    "add", "sub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "exp", "log", "log1p", "expm1", "tanh", "sqrt", "rsqrt", "sigmoid",
    "sin", "cos", "erf", "pow", "floor", "ceil", "reciprocal", "where",
    "_to_copy", "clamp", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "clone",
}

# layout-only ops the segmenter may absorb when the 2-D block views of
# their operands line up (a reshape that keeps the [rows, lanes] view, a
# lane slice, a lane concat, a broadcast, a size-1 select)
LAYOUT_PRIMS = {
    "view", "_unsafe_view", "reshape", "squeeze", "unsqueeze", "expand",
    "slice", "cat", "select", "alias",
}

# the anchor tier: ``mm`` may OPEN a fused segment, in the forward form
# x[M, K] @ w[K, N], the dlhs form g @ w^T (the weight a transposed
# view) or the drhs form x^T @ g (the activation one).  ``bmm`` is an
# anchor candidate the planner always declines (batched anchors are not
# ported yet), as it declines an ``mm`` over any other strides,
# recording why.
ANCHOR_PRIMS = {"mm", "bmm"}

# lane-axis reductions admissible inside a segment: the row statistic
# completes inside one [rows, lanes] block
REDUCE_LANE_PRIMS = {"sum", "amax"}

# far-only ops: data movement, indexing, scatter, matrix products,
# control and everything the planner does not name.  Anything absent
# from every table is far as well (the far pipeline is the fallback).
FAR_PRIMS = {
    "mm", "bmm", "index", "index_put_", "index_select", "gather",
    "scatter", "embedding", "arange", "sort", "topk", "argmax",
    "amax", "max", "sum", "cumsum", "permute", "transpose", "t",
    "floor_divide", "remainder", "scalar_tensor", "lift_fresh_copy",
    "full", "zeros", "ones", "empty", "copy_",
}

# index-like operands (position -> always-F "address registers")
_INDEX_OPERANDS = {
    "index": (1,),
    "index_put_": (1,),
    "index_select": (2,),
    "gather": (2,),
    "scatter": (2,),
    "embedding": (1,),
}


def eqn_tier(name: str) -> str:
    """Segmentation tier of an aten packet name: ``near`` (elementwise),
    ``layout``, ``anchor``, ``reduce`` or ``far``."""
    if name in ANCHOR_PRIMS:
        return "anchor"
    if name in REDUCE_LANE_PRIMS:
        return "reduce"
    if name in ELEMENTWISE_PRIMS:
        return "near"
    if name in LAYOUT_PRIMS:
        return "layout"
    return "far"


def node_name(node) -> str | None:
    """The aten packet name of an fx call node (``None`` for anything
    that is not an aten op: placeholders, ``getitem``, custom ops)."""
    if node.op != "call_function" or not isinstance(
            node.target, torch._ops.OpOverload):
        return None
    ns, _, rest = node.target.name().partition("::")
    if ns != "aten":
        return None
    return rest.split(".")[0]


# ---------------------------------------------------------------------------
# The fixed decomposition table of the capture.
# ---------------------------------------------------------------------------

def _silu(x):
    return aten.mul.Tensor(x, aten.sigmoid.default(x))


def _gelu(x, approximate="none"):
    if approximate == "tanh":
        # jax.nn.gelu's default (tanh) form, term for term
        inner = aten.mul.Tensor(aten.add.Tensor(
            x, aten.mul.Tensor(aten.pow.Tensor_Scalar(x, 3), 0.044715)),
            math.sqrt(2.0 / math.pi))
        return aten.mul.Tensor(aten.mul.Tensor(x, 0.5), aten.add.Tensor(
            aten.tanh.default(inner), 1.0))
    return aten.mul.Tensor(aten.mul.Tensor(x, 0.5), aten.add.Tensor(
        aten.erf.default(aten.mul.Tensor(x, math.sqrt(0.5))), 1.0))


def _softmax(x, dim, half_to_float=False):
    if dim < 0:
        dim += x.dim()
    m = aten.amax.default(x, [dim], True)
    e = aten.exp.default(aten.sub.Tensor(x, m))
    return aten.div.Tensor(e, aten.sum.dim_IntList(e, [dim], True))


def _softmax_int(x, dim, dtype=None):
    if dtype is not None:
        x = aten._to_copy.default(x, dtype=dtype)
    return _softmax(x, dim)


def _mean(x, dim, keepdim=False, dtype=None):
    dims = [d % x.dim() for d in (dim if dim is not None
                                  else range(x.dim()))]
    n = 1
    for d in dims:
        n *= x.shape[d]
    return aten.div.Tensor(aten.sum.dim_IntList(x, dims, keepdim, dtype=dtype),
                           float(n))


def _split(x, split_size, dim=0):
    sizes = []
    total = x.shape[dim]
    while sum(sizes) < total:
        sizes.append(min(split_size, total - sum(sizes)))
    return _split_with_sizes(x, sizes, dim)


def _split_with_sizes(x, split_sizes, dim=0):
    out, start = [], 0
    for s in split_sizes:
        out.append(aten.slice.Tensor(x, dim, start, start + s))
        start += s
    return out


def _one_minus(x):
    # 1 - x, written as the ops the tables hold (exactly equal)
    return aten.add.Tensor(aten.neg.default(x), 1.0)


def _sigmoid_backward(g, y):
    return aten.mul.Tensor(g, aten.mul.Tensor(y, _one_minus(y)))


def _tanh_backward(g, y):
    return aten.mul.Tensor(g, _one_minus(aten.mul.Tensor(y, y)))


def _silu_backward(g, x):
    s = aten.sigmoid.default(x)
    return aten.mul.Tensor(g, aten.mul.Tensor(s, aten.add.Tensor(
        aten.mul.Tensor(x, _one_minus(s)), 1.0)))


def _gelu_backward(g, x, approximate="none"):
    if approximate == "tanh":
        beta = math.sqrt(2.0) * (2.0 / math.sqrt(math.pi)) * 0.5
        kappa = 0.044715
        x_sq = aten.mul.Tensor(x, x)
        inner = aten.mul.Tensor(aten.add.Tensor(
            x, aten.mul.Tensor(aten.mul.Tensor(x_sq, x), kappa)), beta)
        t = aten.tanh.default(inner)
        left = aten.mul.Tensor(x, 0.5)
        left_d = aten.mul.Tensor(aten.add.Tensor(t, 1.0), 0.5)
        right_d = aten.mul.Tensor(left, _one_minus(aten.mul.Tensor(t, t)))
        inner_d = aten.mul.Tensor(aten.add.Tensor(
            aten.mul.Tensor(x_sq, 3.0 * kappa), 1.0), beta)
        return aten.mul.Tensor(g, aten.add.Tensor(
            left_d, aten.mul.Tensor(right_d, inner_d)))
    cdf = aten.mul.Tensor(aten.add.Tensor(aten.erf.default(
        aten.mul.Tensor(x, math.sqrt(0.5))), 1.0), 0.5)
    pdf = aten.mul.Tensor(aten.exp.default(aten.mul.Tensor(
        aten.mul.Tensor(x, x), -0.5)), (2.0 / math.sqrt(math.pi))
        * math.sqrt(0.5) * 0.5)
    return aten.mul.Tensor(g, aten.add.Tensor(cdf, aten.mul.Tensor(x, pdf)))


def _addmm(bias, a, b, beta=1, alpha=1):
    if beta != 1 or alpha != 1:
        return NotImplemented
    return aten.add.Tensor(aten.mm.default(a, b), bias)


DECOMPOSITIONS = {
    aten.silu.default: _silu,
    aten.gelu.default: _gelu,
    aten._softmax.default: _softmax,
    aten.softmax.int: _softmax_int,
    aten.mean.dim: _mean,
    aten.split.Tensor: _split,
    aten.split_with_sizes.default: _split_with_sizes,
    aten.addmm.default: _addmm,
    aten.sigmoid_backward.default: _sigmoid_backward,
    aten.tanh_backward.default: _tanh_backward,
    aten.silu_backward.default: _silu_backward,
    aten.gelu_backward.default: _gelu_backward,
}
