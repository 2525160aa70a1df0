"""B2 ``fused_segment_grid`` and B8 ``adamw_update`` as redesigned for
the H100's memory system, on the CPU.

B2: the generated kernel reads every operand's row from the output row
(``role_rows``), not from a program id and the planner's row block; the
emitted arithmetic, evaluated in Python over every row, is held to
``role_block`` (the reference's row-block walk, which the plain version
keeps) at qwen3-1.7b's full-width decode and training shapes and at tiny
ones whose rows no block divides.  ``grid_geometry`` is held to its
design at those shapes.  The generated source of every grid segment of a
tiny decode and training plan compiles as Python, and runs — through a
small PyTorch stand-in for ``triton.language`` that executes a program
id at a time — to the plain version's values, its operands at the
graph's own strides (strided ones addressed in place).  The plain
version itself is held against the JAX package in
``tests/test_torch_fused_kernels.py``.

B8: the launch-geometry helper (vector plan, grid), the wrapper's
refusals on the CPU, and the plain version against the Pallas kernel in
interpret mode for p in f32 / bf16 / f16 at a ragged size.

Tolerances: the stand-in against the plain version 2e-5 in f32 (lane
sums in another order), 2e-2 and one bf16 ulp of the value plus one of
the output's rms in bf16 (chip_smoke.py's rule for B2 on the card);
B8's plain version against Pallas interpret 2e-6 / 1e-7 in f32, 2e-2 in
bf16, 1e-3 in f16.
"""
import dataclasses
import importlib
import math
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import (
    GRID_ROWS_BLOCK,
    _dense,
    _segment_arg_vars,
    node_val,
    offload_report,
    segment_call,
)
from repro_torch.kernels import ops
from repro_torch.kernels.blockprog import BlockProgram, Input, Op

# the modules, not the entry points of the same names the package exports
fe = importlib.import_module("repro_torch.kernels.fused_elementwise")
adamw_mod = importlib.import_module("repro_torch.kernels.adamw_update")
jadamw = importlib.import_module("repro.kernels.adamw_update")

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# a PyTorch stand-in for the parts of Triton the generated kernels use
# ---------------------------------------------------------------------------

class _Ptr:
    """A pointer: a flat tensor and element offsets into it."""

    def __init__(self, base, off=0):
        self.base, self.off = base, off

    def __add__(self, off):
        return _Ptr(self.base, self.off + off)

    __radd__ = __add__


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(x)


def _load(ptr, mask=None, other=0, eviction_policy=""):
    off = _t(ptr.off).long()
    mask = torch.ones_like(off, dtype=torch.bool) if mask is None else mask
    off, mask = torch.broadcast_tensors(off, _t(mask))
    out = torch.full(off.shape, other, dtype=ptr.base.dtype)
    out[mask] = ptr.base[off[mask]]
    return out


def _store(ptr, val, mask=None):
    off = _t(ptr.off).long()
    mask = torch.ones_like(off, dtype=torch.bool) if mask is None else mask
    off, val, mask = torch.broadcast_tensors(off, _t(val), _t(mask))
    ptr.base[off[mask]] = val[mask].to(ptr.base.dtype)


def _triton_stand_in(pid_box):
    tl = types.SimpleNamespace(
        float32=torch.float32, bfloat16=torch.bfloat16, float16=torch.float16,
        int32=torch.int32, int64=torch.int64, int1=torch.bool,
        program_id=lambda axis: torch.tensor(pid_box[0], dtype=torch.int32),
        arange=lambda a, b: torch.arange(a, b, dtype=torch.int32),
        load=_load, store=_store,
        where=lambda c, a, b: torch.where(_t(c), _t(a), _t(b)),
        sum=lambda x, axis: x.sum(axis), max=lambda x, axis: x.amax(axis),
        full=lambda shape, v, dtype: torch.full(shape, v, dtype=dtype),
        maximum=lambda a, b: torch.maximum(_t(a), _t(b)),
        minimum=lambda a, b: torch.minimum(_t(a), _t(b)),
        exp=torch.exp, log=torch.log, abs=torch.abs)
    libdevice = types.SimpleNamespace(
        log1p=torch.log1p, expm1=torch.expm1, tanh=torch.tanh,
        sqrt=torch.sqrt, rsqrt=torch.rsqrt, sin=torch.sin, cos=torch.cos,
        erf=torch.erf, floor=torch.floor, ceil=torch.ceil,
        pow=lambda a, b: torch.pow(a, b))
    language = types.ModuleType("triton.language")
    language.__dict__.update(vars(tl))
    triton = types.ModuleType("triton")
    triton.jit = lambda fn: fn
    triton.language = language
    extra = types.ModuleType("triton.language.extra")
    extra.libdevice = libdevice
    return {"triton": triton, "triton.language": language,
            "triton.language.extra": extra}


def _flat(v: torch.Tensor) -> torch.Tensor:
    """The storage a (strided) view reaches, flat from its first element."""
    span = 1 + sum((n - 1) * s for n, s in zip(v.shape, v.stride()))
    return torch.as_strided(v, (span,), (1,))


def run_generated(prog, operands, specs, *, rows, out_cols, out_dtypes,
                  monkeypatch, out_strides=None):
    """``fused_segment_grid``'s launch, executed on the CPU: operands at
    their own strides (addressed in place where ``operand_layout`` can),
    outputs in the layouts ``out_strides`` asks for, the generated source
    run one program id at a time.  Returns the outputs as ``[rows,
    cols]``."""
    pid = [0]
    for name, mod in _triton_stand_in(pid).items():
        monkeypatch.setitem(sys.modules, name, mod)
    views, layouts = [], []
    for spec, v in zip(specs, operands):
        layout = fe.operand_layout(v, spec[1], spec[2])
        if layout is False:
            v, layout = v.reshape(spec[1], spec[2]).contiguous(), None
        views.append(v)
        layouts.append(layout)
    outs, out_layouts = [], []
    for j, (c, dt) in enumerate(zip(out_cols, out_dtypes)):
        layout = None
        if out_strides and out_strides[j] is not None:
            o = torch.zeros(out_strides[j][0], dtype=dt).as_strided(
                *out_strides[j])
            layout = fe.operand_layout(o, rows, c) or None
        if layout is None:
            o = torch.zeros((rows, c), dtype=dt)
        outs.append(o)
        out_layouts.append(layout)
    name, src, geo = fe.triton_source(prog, rows=rows, specs=specs,
                                      rows_block=GRID_ROWS_BLOCK,
                                      layouts=layouts,
                                      out_layouts=out_layouts)
    scope: dict = {}
    exec(compile(src, name, "exec"), scope)
    args = [_Ptr(_flat(v)) for v in views] + [_Ptr(_flat(o)) for o in outs]
    for p in range(geo["grid"]):
        pid[0] = p
        scope[name](*args)
    outs = [o.reshape(rows, c) for o, c in zip(outs, out_cols)]
    return outs, layouts + out_layouts, geo


# ---------------------------------------------------------------------------
# B2: role rows against role_block
# ---------------------------------------------------------------------------

def _role_cases():
    """(label, rows, specs): qwen3-1.7b's decode (8 slots: 8 token rows,
    128 q-head rows, 64 kv-head rows) and training (2 x 1,024 tokens:
    2,048 token rows, 32,768 q-head rows, 16,384 kv-head rows) shapes,
    and tiny ones whose rows no block divides."""
    yield "decode q heads", 128, [
        ("bulk", 128, 128), ("param", 1, 128), ("rep", 8, 128),
        ("tile", 16, 128),
        ("bcast", 16, 128, (1, 16, 1), (8, 16, 1)),
        ("bcast", 8, 128, (8, 1, 1), (8, 16, 1))]
    yield "decode kv heads", 64, [
        ("bulk", 64, 128), ("rep", 8, 128), ("tile", 8, 128)]
    yield "decode tokens", 8, [
        ("bulk", 8, 2048), ("param", 1, 2048), ("tile", 8, 2048)]
    yield "training q heads", 32768, [
        ("bulk", 32768, 128), ("rep", 2048, 128), ("tile", 2048, 128),
        ("bcast", 16384, 128, (2, 1, 1024, 8), (2, 2, 1024, 8)),
        ("bcast", 32, 128, (2, 16, 1, 1), (2, 16, 1024, 1))]
    yield "training kv heads", 16384, [
        ("bulk", 16384, 128), ("rep", 2048, 128), ("tile", 1024, 128),
        ("rep", 2, 128)]
    yield "training tokens", 2048, [
        ("bulk", 2048, 6144), ("param", 1, 6144), ("rep", 2, 6144),
        ("tile", 1024, 6144)]
    yield "tiny, 3 x 5 x 7 rows", 105, [
        ("bulk", 105, 4), ("rep", 35, 4), ("rep", 3, 4), ("tile", 7, 4),
        ("tile", 35, 4),
        ("bcast", 21, 4, (3, 1, 7), (3, 5, 7)),
        ("bcast", 15, 4, (3, 5, 1), (3, 5, 7)),
        ("bcast", 5, 4, (1, 5, 1), (3, 5, 7))]
    yield "tiny, 13 rows", 13, [
        ("bulk", 13, 3), ("param", 1, 3), ("rep", 1, 3), ("tile", 13, 3)]


@pytest.mark.parametrize("label,rows,specs",
                         list(_role_cases()), ids=lambda x: str(x)[:20])
def test_emitted_role_rows_match_role_block(label, rows, specs):
    """Every output row reads, per operand, the row ``role_block`` gives
    that row's block in the plain version's walk."""
    exprs = fe.role_rows(specs, rows)
    rb, pad, _ = fe.segment_row_block(rows, specs, GRID_ROWS_BLOCK)
    if label.startswith("tiny"):
        assert rows % 16 and rb < 16     # rows no GRID_ROWS_BLOCK divides
    grow = torch.arange(rows)
    for spec, expr in zip(specs, exprs):
        op_rows = spec[1]
        view = torch.arange(op_rows)[:, None]
        if spec[0] == "bulk" and pad:
            view = torch.cat([view, torch.full((pad, 1), -1)])
        want = torch.cat([
            fe.role_block(spec, view, i, rb, rows).expand(rb, 1)
            for i in range((rows + pad) // rb)])[:rows, 0]
        got = torch.zeros(rows, dtype=torch.long) if expr is None else \
            eval(expr, {"grow": grow})
        assert torch.equal(torch.as_tensor(got).expand(rows), want), \
            (label, spec[0], expr)


# ---------------------------------------------------------------------------
# B2: geometry
# ---------------------------------------------------------------------------

def _program(ins, out_cols, out_dtype, reduce=False) -> BlockProgram:
    """A block program of ``ins`` ((role, rows, cols, dtype)) whose
    outputs sum the lane inputs (after a lane sum of the first, with
    ``reduce``): what the geometry reads of a program."""
    inputs = tuple(Input(r, n, c, dt) for r, n, c, dt in ins)
    ops_ = [Op("in", dt, c, arg=k) for k, (_, _, c, dt) in enumerate(ins)]
    if reduce:
        ops_.append(Op("reduce", "float32", 1, code="sum",
                       args=(("v", 0),)))
    outs = []
    for c in out_cols:
        ops_.append(Op("ew", out_dtype, c, code="add",
                       args=(("v", 0), ("v", len(ops_) - 1))))
        outs.append(len(ops_) - 1)
    return BlockProgram(inputs, tuple(ops_), tuple(outs))


SMS_4 = 4 * fe.SMS


def _geo(prog, rows):
    specs = [(i.role, i.rows, i.cols) for i in prog.inputs]
    return fe.grid_geometry(prog, rows, specs, GRID_ROWS_BLOCK)


@pytest.mark.parametrize("case", [
    # (label, program, rows, mode, training size)
    ("rmsnorm [2048 x 2048] bf16", lambda: _program(
        [("bulk", 2048, 2048, "bfloat16"), ("param", 1, 2048, "float32")],
        [2048], "bfloat16", reduce=True), 2048, "row", True),
    ("swiglu [2048 x 6144] bf16", lambda: _program(
        [("bulk", 2048, 6144, "bfloat16"), ("bulk", 2048, 6144, "bfloat16")],
        [6144], "bfloat16"), 2048, "tile", True),
    ("lane reduce [2048 x 6144] bf16", lambda: _program(
        [("bulk", 2048, 6144, "bfloat16"), ("bulk", 2048, 6144, "bfloat16")],
        [6144], "bfloat16", reduce=True), 2048, "row", True),
    ("softmax-like [16384 x 512] bf16", lambda: _program(
        [("bulk", 16384, 512, "bfloat16"), ("bulk", 16384, 512, "bfloat16")],
        [512], "bfloat16", reduce=True), 16384, "row", True),
    ("update [152064 x 2048] f32", lambda: _program(
        [("bulk", 152064, 2048, "float32")] * 4 +
        [("param", 1, 1, "float32")] * 3,
        [2048] * 3, "float32"), 152064, "tile", True),
    ("8-leaf update [2048 x 6144] f32", lambda: _program(
        [("bulk", 2048, 6144, "float32")] * 32 +
        [("param", 1, 1, "float32")] * 3,
        [6144] * 24, "float32"), 2048, "tile", True),
    ("LM head rows [2048 x 151936] f32", lambda: _program(
        [("bulk", 2048, 151936, "float32")], [151936], "float32",
        reduce=True), 2048, "wide", True),
    ("decode q-norm [8 x 2048] bf16", lambda: _program(
        [("bulk", 8, 2048, "bfloat16"), ("param", 1, 2048, "float32")],
        [2048], "bfloat16", reduce=True), 8, "row", False),
    ("decode head norm [128 x 128] bf16", lambda: _program(
        [("bulk", 128, 128, "bfloat16"), ("param", 1, 128, "float32")],
        [128], "bfloat16", reduce=True), 128, "row", False),
    ("decode lane reduce [8 x 6144] bf16", lambda: _program(
        [("bulk", 8, 6144, "bfloat16"), ("param", 1, 6144, "float32")],
        [6144], "bfloat16", reduce=True), 8, "row", False),
    ("decode rope [128 x 128] bf16", lambda: _program(
        [("bulk", 128, 128, "bfloat16"), ("rep", 8, 128, "float32"),
         ("rep", 8, 128, "float32")], [128], "bfloat16"), 128, "tile",
     False),
], ids=lambda c: c[0])
def test_grid_geometry_fills_the_card(case):
    """Training-size segments launch at least 4 programs an SM; lanes
    move as 16-byte vectors (8 bf16, 4 f32) that every thread holds
    whole; a lane reduction over at most ``ROW_LANES`` lanes holds its
    rows in one read (``row``), wider ones pass over chunks; decode's
    segments keep a few programs, spread thin."""
    label, make, rows, mode, training = case
    prog = make()
    geo = _geo(prog, rows)
    assert geo["mode"] == mode, geo
    bf16 = "bf16" in label
    assert geo["vec"] == (8 if bf16 else 4), geo
    assert geo["elems"] % geo["vec"] == 0 and geo["elems"] <= 16
    if mode == "tile":
        assert geo["bc"] % geo["vec"] == 0
        assert geo["rs"] * geo["bc"] == 32 * geo["num_warps"] * geo["elems"]
    if mode == "row":
        widest = max(op.cols for op in prog.ops)
        assert geo["bc"] >= widest and geo["col_tiles"] == 1
    if training:
        assert geo["grid"] >= SMS_4, geo
    else:
        assert 1 <= geo["grid"] <= 16, geo
        if mode == "tile":
            # a decode tile spreads to one 16-byte vector a thread
            assert geo["elems"] == geo["vec"] or geo["rs"] == 1, geo
    assert geo["grid"] == -(-rows // geo["rs"]) * geo["col_tiles"]
    assert geo["i64"] == (rows * max(op.cols for op in prog.ops) >= 2 ** 31)


def test_many_operand_programs_hold_fewer_elements_a_thread():
    """A program that loads many operands (the offloaded update over
    several leaves) holds fewer elements a thread per value, never fewer
    than one 16-byte vector."""
    few = _geo(_program([("bulk", 2048, 6144, "float32")] * 2, [6144],
                        "float32"), 2048)
    many = _geo(_program([("bulk", 2048, 6144, "float32")] * 40, [6144],
                         "float32"), 2048)
    assert few["elems"] == 16 and many["elems"] == 4 == many["vec"]


# ---------------------------------------------------------------------------
# B2: the generated kernels of tiny plans, run on the CPU
# ---------------------------------------------------------------------------

def _tiny_training_plans():
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config, \
        reduced
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import device_batch

    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              num_layers=1)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0)
    step = make_train_step(model, TrainConfig(remat=False, offload=True))
    batch = device_batch(SyntheticLM(make_data_config(
        cfg, ShapeConfig("t", 16, 2))).batch(0), "cpu")
    return [step.loss_fn.warm(state.params, batch),
            *step.loss_fn.warm_backward(state.params, batch),
            step.update_fn.warm(state.params, state.params, state.opt)]


def _tiny_decode_plan(dtype):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), dtype=dtype,
                              num_layers=2)
    params = build_model(cfg, device="cpu").init(0)
    eng = Engine(cfg, params, device="cpu", slots=2, max_len=48,
                 page_size=8, offload_policy=OffloadPolicy(bulk_threshold=32))
    return eng.decode_plan()


@pytest.fixture(scope="module")
def tiny_plans():
    return {"training": _tiny_training_plans(),
            "decode float32": [_tiny_decode_plan("float32")],
            "decode bfloat16": [_tiny_decode_plan("bfloat16")]}


def _graph_operands(seg, seed: int) -> list:
    """Seeded operands of a planned segment at the graph's own shapes
    and strides (a transposed or broadcast view stays one)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for v in _segment_arg_vars(seg):
        val = node_val(v)
        span = 1 + sum((n - 1) * s for n, s in zip(val.shape, val.stride()))
        t = torch.randn(span, generator=gen)
        if not val.dtype.is_floating_point:
            t = t.abs().floor()
        out.append(t.to(val.dtype).as_strided(tuple(val.shape),
                                              tuple(val.stride())))
    return out


def _close(got, want, dtype):
    g, w = got.float(), want.float()
    fin = torch.isfinite(w)
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-2)
        rms = w.pow(2).mean().sqrt()
        assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs()
                     + 2.0 ** -7 * rms).all())


@pytest.mark.parametrize("which", ["training", "decode float32",
                                   "decode bfloat16"])
def test_generated_grid_kernels_compile_and_match_the_plain_version(
        which, tiny_plans, monkeypatch):
    """Every grid segment of the tiny plans: the generated source is
    valid Python, and run one program id at a time on its operands at
    the graph's strides it gives the plain version's outputs."""
    seen, modes, strided, strided_out = set(), set(), 0, 0
    for plan in tiny_plans[which]:
        for seg in plan.segments:
            if seg.matmul is not None:
                continue
            call = segment_call(plan.eqns, seg)
            sym = fe.triton_source(call["progs"].body, rows=call["rows"],
                                   specs=call["specs"],
                                   rows_block=GRID_ROWS_BLOCK)[0]
            if sym in seen:
                continue
            seen.add(sym)
            vals = _graph_operands(seg, len(seen))
            kw = dict(rows=call["rows"], out_cols=call["out_cols"],
                      out_dtypes=call["out_dtypes"])
            # the runner's layouts: a permuted dense output keeps its own
            outs = [node_val(v) for v in seg.outputs]
            out_strides = [(tuple(o.shape), o.stride())
                           if not o.is_contiguous() and _dense(o) else None
                           for o in outs]
            got, layouts, geo = run_generated(
                call["progs"].body, vals, call["specs"],
                monkeypatch=monkeypatch, out_strides=out_strides, **kw)
            strided_out += any(out_strides)
            want = ops.fused_segment_grid(
                call["progs"].body, vals, call["specs"],
                rows_block=GRID_ROWS_BLOCK, impl="ref", **kw)
            for g, w in zip(got, want, strict=True):
                _close(g, w, w.dtype if w.is_floating_point()
                       else torch.float32)
            modes.add(geo["mode"])
            strided += any(layouts)
    assert seen
    if which == "training":
        # elementwise tiles and single-read lane reductions; strided
        # operands and permuted outputs (the attention's head-major
        # views) addressed in place
        assert {"tile", "row"} <= modes and strided and strided_out


def _roles_chain(x, p, r, t):
    return (x * p + r) * t - 1.0


def _bcast_chain(x, o):
    return torch.tanh(x) * o + 0.5


def _wide_chain(x, y, p):
    h = torch.nn.functional.silu(x) * y
    return h * torch.rsqrt(torch.mean(h.float() * h.float(), -1,
                                      keepdim=True) + 1e-6).to(h.dtype) * p


def _padded_chain(x, p):
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
            * p).to(x.dtype), torch.softmax(xf, -1)


def _vocab_chain(x):
    xf = x.float()
    z = xf - torch.amax(xf, -1, keepdim=True)
    return z - torch.log(torch.sum(torch.exp(z), -1, keepdim=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generated_kernels_of_the_card_role_chains(dtype, monkeypatch):
    """The grid segments chip_smoke.py's phase 6 runs beside the decode
    plan (``tile`` and ``bcast`` roles, a padded row count, a 6,144-lane
    reduction, two outputs) and a reduction wider than ``ROW_LANES``
    (the ``wide`` mode), at those shapes: generated, run on the CPU and
    held to the plain version."""
    gen = torch.Generator().manual_seed(11)

    def t(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    cases = [(_roles_chain, (t(8, 25, 2048), t(2048), t(8, 1, 2048),
                             t(1, 25, 2048))),
             (_bcast_chain, (t(8, 4, 16, 2, 128), t(8, 1, 16, 1, 128))),
             (_wide_chain, (t(8, 1, 6144), t(8, 1, 6144), t(6144))),
             (_padded_chain, (t(8, 13, 2048), t(2048))),
             (_vocab_chain, (t(3, 9000),))]
    modes = set()
    for fn, args in cases:
        plan = offload_report(fn, *args,
                              policy=OffloadPolicy(bulk_threshold=1024))
        assert len(plan.segments) == 1 and plan.segments[0].matmul is None
        call = segment_call(plan.eqns, plan.segments[0])
        vals = _graph_operands(plan.segments[0], 5)
        kw = dict(rows=call["rows"], out_cols=call["out_cols"],
                  out_dtypes=call["out_dtypes"])
        got, _, geo = run_generated(call["progs"].body, vals, call["specs"],
                                    monkeypatch=monkeypatch, **kw)
        want = ops.fused_segment_grid(call["progs"].body, vals,
                                      call["specs"],
                                      rows_block=GRID_ROWS_BLOCK,
                                      impl="ref", **kw)
        for g, w in zip(got, want, strict=True):
            _close(g, w, w.dtype)
        modes.add(geo["mode"])
    assert modes == {"tile", "row", "wide"}


def test_operand_layout_addresses_strided_views_in_place():
    x = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    assert fe.operand_layout(x, 24, 5) is None
    t = x.permute(0, 2, 1, 3)                   # [2, 4, 3, 5], head-major
    dims, strides, ls = fe.operand_layout(t, 24, 5)
    assert (dims, strides, ls) == ((2, 4, 3), (60, 5, 20), 1)
    flat = _flat(t)
    for r in range(24):
        off = eval(fe._row_offset("r", 5, (dims, strides, ls)), {"r": r})
        assert torch.equal(flat[off:off + 5], t.reshape(24, 5)[r])
    s = x[..., :3]                               # a lane slice: a row stride
    assert fe.operand_layout(s, 24, 3) == ((24,), (5,), 1)
    e = torch.arange(5).expand(24, 5)            # broadcast rows
    assert fe.operand_layout(e, 24, 5) == ((24,), (0,), 1)
    assert fe.operand_layout(x.transpose(-1, -2), 24, 5) is False


# ---------------------------------------------------------------------------
# B8
# ---------------------------------------------------------------------------

def test_adamw_vector_plan_heads_and_tails():
    plan = adamw_mod.vector_plan
    f32, bf16 = 4, 2
    # aligned bases: packs of 8 and a ragged tail
    assert plan([0, 256, 512, 768], [f32] * 4, 3007) == (0, 375, 7)
    # every f32 base one element past 16 bytes: a head of 3 aligns all
    assert plan([4, 260, 516], [f32] * 3, 100) == (3, 12, 1)
    # bf16 p one element past alignment, f32 moments three past: h = 7
    assert plan([2, 4 + 16, 4 + 32], [bf16, f32, f32], 64) == (7, 7, 1)
    # bases that never share an alignment: every element scalar
    assert plan([0, 2], [f32, bf16], 50) == (50, 0, 0)
    # fewer elements than a pack
    assert plan([0, 0], [f32, f32], 5) == (0, 0, 5)
    assert plan([4, 4], [f32, f32], 2) == (2, 0, 0)


def test_adamw_launch_grid():
    """One pass over the leaf: a thread takes ``UNROLL`` packs, and one
    head and one tail element."""
    g = adamw_mod.launch_grid
    per_block = adamw_mod.THREADS * adamw_mod.UNROLL
    packs = 152064 * 2048 // 8
    assert g(0, packs, 0) == packs // per_block == 76032
    assert g(0, 10, 3) == 1
    assert g(3, 0, 0) == 1
    assert g(0, 4 * per_block + 1, 7) == 5


def test_adamw_wrapper_refuses_on_the_cpu():
    """``impl="cuda"`` on CPU tensors raises; the wrapper refuses a wrong
    dtype or shape before it looks for the device, and CPU tensors."""
    p = torch.zeros(10)
    m = torch.zeros(10)
    h = torch.zeros(7)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.adamw_update(p, p, m, m, h, impl="cuda")
    launch = adamw_mod.adamw_update
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        launch(p, p, m, m, h)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        launch(p.double(), p, m, m, h)
    with pytest.raises(TypeError, match="must be float32"):
        launch(p, p, m.half(), m, h)
    with pytest.raises(ValueError, match="one shape"):
        launch(p, torch.zeros(11), m, m, h)
    with pytest.raises(ValueError, match="one shape"):
        launch(p, p, m, m, torch.zeros(6))


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_adamw_plain_version_matches_jax_interpret_at_a_ragged_size(pdtype):
    rng = np.random.default_rng(20)
    hyper = np.array([1e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                      1 - 0.95 ** 3], np.float32)
    n = 3 * 1000 + 7
    p, g = (torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(pdtype) for _ in range(2))
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    v = torch.from_numpy(rng.random(n).astype(np.float32))
    got = ops.adamw_update(p, g, m, v, torch.from_numpy(hyper), impl="ref")
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}[pdtype]
    want = jadamw.adamw_update(
        jnp.asarray(p.float().numpy(), jd), jnp.asarray(g.float().numpy(), jd),
        jnp.asarray(m.numpy()), jnp.asarray(v.numpy()), jnp.asarray(hyper),
        interpret=True)
    for a, b in zip(got, want, strict=True):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == (
            pdtype if a is got[0] else torch.float32)
        tol = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
               torch.float16: dict(rtol=1e-3, atol=1e-3)}.get(
            a.dtype, dict(rtol=2e-6, atol=1e-7))
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)), **tol)
    assert math.isfinite(float(got[0].float().abs().max()))
