"""Algorithm 1 over fx graphs — the MPU compiler's location annotation.

The counterpart of ``repro/core/locator.py``: the same lattice and the
same fixpoint, over the call nodes of a graph captured by ``make_fx``
instead of the eqns of a jaxpr.  Register <-> fx node, instruction <->
call node.  Seeds:

    ld.global value   floating placeholders of rank >= 1          -> N
    ld.global addr    index / gather / scatter index operands      -> F
    st.global value   floating graph outputs                       -> N
    integer values    every node of a non-floating dtype           -> F
    far opcode set    mm, index, scatter, reductions, ...          -> F

A known destination location flows to the sources; N/F conflict -> B.
An instruction's location follows its destination.  The in-place KV
page write (``index_put_``) returns the mutated pool, which the graph
returns, so the stored values are seeded N as a functional update is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.fx as fx

from repro_torch.core.isa import Loc
from repro_torch.core.prims import (
    ELEMENTWISE_PRIMS,
    FAR_PRIMS,
    _INDEX_OPERANDS,
    node_name,
)


@dataclass
class GraphAnnotation:
    var_loc: dict[Any, Loc]
    eqn_loc: dict[Any, Loc]
    graph: fx.Graph


def node_val(node) -> Any:
    """The fake tensor (or value) an fx node carries in its meta."""
    return node.meta.get("val") if isinstance(node, fx.Node) else None


def _is_value(node) -> bool:
    """A non-scalar floating tensor: a value register."""
    v = node_val(node)
    return (isinstance(v, torch.Tensor) and v.ndim >= 1
            and v.dtype.is_floating_point)


def _is_float(node) -> bool:
    v = node_val(node)
    return isinstance(v, torch.Tensor) and v.dtype.is_floating_point


def _flat_nodes(args) -> list:
    out: list = []
    for a in args:
        if isinstance(a, fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(_flat_nodes(a))
    return out


def annotate_graph(graph: fx.Graph) -> GraphAnnotation:
    var_loc: dict[Any, Loc] = {}
    calls = [n for n in graph.nodes if n.op == "call_function"]

    def get(v) -> Loc:
        return var_loc.get(v, Loc.U)

    def join(a: Loc, b: Loc) -> Loc:
        if a is Loc.U:
            return b
        if b is Loc.U or a is b:
            return a
        return Loc.B

    def seed(v, loc: Loc):
        if isinstance(v, fx.Node):
            var_loc[v] = join(var_loc.get(v, Loc.U), loc)

    # --- seeds ------------------------------------------------------------
    for n in graph.nodes:
        if n.op in ("placeholder", "get_attr"):
            seed(n, Loc.N if _is_value(n) else Loc.F)
        elif n.op == "output":
            # every floating output is stored, a scalar loss included
            # (the JAX package seeds rank >= 1 only; a loss program
            # would then annotate every op far and fuse no elementwise
            # chain of the training forward)
            for v in _flat_nodes(n.args):
                if _is_float(v):
                    seed(v, Loc.N)
    for n in calls:
        name = node_name(n)
        if name in _INDEX_OPERANDS:
            for i in _INDEX_OPERANDS[name]:
                if i < len(n.args):
                    for v in _flat_nodes([n.args[i]]):
                        seed(v, Loc.F)
        if not _is_float(n):
            seed(n, Loc.F)         # integer values are address registers

    # --- fixpoint: dst -> src propagation ----------------------------------
    changed, iters = True, 0
    while changed and iters < 100:
        changed = False
        iters += 1
        for n in calls:
            dloc = get(n)
            if dloc is Loc.U:
                continue
            for v in n.all_input_nodes:
                new = join(get(v), dloc)
                if new is not get(v):
                    var_loc[v] = new
                    changed = True

    # --- instruction locations ---------------------------------------------
    eqn_loc: dict[Any, Loc] = {}
    for n in calls:
        name = node_name(n)
        if name is None or name in FAR_PRIMS or name not in ELEMENTWISE_PRIMS:
            eqn_loc[n] = Loc.F
        else:
            eqn_loc[n] = {Loc.U: Loc.F}.get(get(n), get(n))
    return GraphAnnotation(var_loc, eqn_loc, graph)
