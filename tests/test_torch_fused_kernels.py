"""The plain versions of the port's fused kernels on the CPU, held
against the JAX package's Pallas kernels in interpret mode (as that
package's own tests run them): ``fused_segment_grid`` (B2) for every
operand role, padded rows, several outputs and a lane reduction, and
``fused_matmul_segment`` (B3) with an lhs prologue, a bf16 weight
prologue, a lane-split and a lane-reduce epilogue — in f32 and bf16.
The block programs come from the port's planner; the JAX side runs the
same program through a small jnp evaluator, so what is compared is the
grid walk, the role views, the padding and the contraction.  The row
block helpers are held equal to the reference's on sampled shapes.

Tolerances: f32 2e-5; bf16 2e-2 (compared in f32).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import (
    GRID_ROWS_BLOCK,
    MATMUL_ROWS_BLOCK,
    offload_report,
    segment_call,
)
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops
from repro_torch.kernels.codegen import bcast_row_expr
# the module, not the entry point of the same name the package exports
fe = importlib.import_module("repro_torch.kernels.fused_elementwise")

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:
    from _hyp import given, settings, st

torch.set_num_threads(1)

# the modules (``repro.kernels`` re-exports functions of the same names)
jfe = importlib.import_module("repro.kernels.fused_elementwise")
jfm = importlib.import_module("repro.kernels.fused_matmul")

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
_JD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int32: jnp.int32, torch.int64: jnp.int32, torch.bool: jnp.bool_}

_UN = {"neg": jnp.negative, "abs": jnp.abs, "exp": jnp.exp, "log": jnp.log,
       "log1p": jnp.log1p, "expm1": jnp.expm1, "tanh": jnp.tanh,
       "sqrt": jnp.sqrt, "rsqrt": jax.lax.rsqrt, "sigmoid": jax.nn.sigmoid,
       "sin": jnp.sin, "cos": jnp.cos, "erf": jax.scipy.special.erf,
       "floor": jnp.floor, "ceil": jnp.ceil, "recip": lambda x: 1.0 / x,
       "not": jnp.logical_not}
_BIN = {"add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply,
        "div": jnp.divide, "max": jnp.maximum, "min": jnp.minimum,
        "pow": jnp.power, "eq": jnp.equal, "ne": jnp.not_equal,
        "lt": jnp.less, "le": jnp.less_equal, "gt": jnp.greater,
        "ge": jnp.greater_equal, "and": jnp.logical_and,
        "or": jnp.logical_or}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "int32": jnp.int32, "int64": jnp.int32, "bool": jnp.bool_}


def jax_program(prog):
    """The same block program as a jnp function over Pallas blocks."""
    def fn(*blocks, block_rows):
        vals = []

        def arg(a):
            return vals[a[1]] if a[0] == "v" else a[1]
        for op in prog.ops:
            dt = _JDT[op.dtype]
            if op.kind == "in":
                v = blocks[op.arg]
            elif op.kind == "same":
                v = arg(op.args[0])
            elif op.kind == "reduce":
                x = arg(op.args[0]).astype(jnp.float32)
                v = (x.sum(-1, keepdims=True) if op.code == "sum"
                     else x.max(-1, keepdims=True)).astype(dt)
            elif op.kind == "slice":
                a, b, s = op.params
                v = arg(op.args[0])[:, a:b:s]
            elif op.kind == "cat":
                parts = [arg(x) for x in op.args]
                r = max(p.shape[0] for p in parts)
                v = jnp.concatenate([jnp.broadcast_to(p, (r, p.shape[1]))
                                     for p in parts], -1)
            elif op.kind == "expand":
                v = jnp.broadcast_to(arg(op.args[0]),
                                     (1 if op.param else block_rows, op.cols))
            elif op.code == "cast":
                v = arg(op.args[0])
            elif op.code == "copy":
                v = arg(op.args[0])
            elif op.code == "where":
                v = jnp.where(*[arg(a) for a in op.args])
            elif op.code in _UN:
                v = _UN[op.code](jnp.asarray(arg(op.args[0])).astype(
                    jnp.float32))
            else:
                a, b = (arg(x) for x in op.args)
                if isinstance(a, jax.Array) or isinstance(b, jax.Array):
                    a = jnp.asarray(a, jnp.float32) if not isinstance(
                        a, jax.Array) else a.astype(jnp.float32)
                    b = jnp.asarray(b, jnp.float32) if not isinstance(
                        b, jax.Array) else b.astype(jnp.float32)
                v = _BIN[op.code](a, b)
            vals.append(jnp.asarray(v).astype(dt))
        return tuple(vals[o] for o in prog.outputs)
    return fn


def _plan_calls(fn, args, threshold=16):
    plan = offload_report(fn, *args,
                          policy=OffloadPolicy(bulk_threshold=threshold))
    return [segment_call(plan.eqns, s) for s in plan.segments]


def _operands(call, seed, dtype):
    rng = np.random.default_rng(seed)
    out = []
    for spec, dt in zip(call["specs"], call["dtypes"]):
        a = rng.standard_normal((spec[1], spec[2])).astype(np.float32)
        if spec[0] == "bulk_w":
            a /= np.sqrt(spec[1])
        out.append(torch.from_numpy(a).to(dt))
    return out


def _jx(t):
    return jnp.asarray(t.float().numpy()).astype(_JD[t.dtype])


def _close(got, want, dtype):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   **TOL[dtype])


# ---------------------------------------------------------------- B2
def _roles_chain(x, p, r, t):
    return (x * p + r) * t - 1.0


def _bcast_chain(x, o):
    return torch.tanh(x) * o + 0.5


def _reduce_chain(x, p):
    h = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-5) * p
    return h, torch.softmax(x * 0.5, -1)


def _rope_chain(x, c, s):
    a, b = x[..., :8], x[..., 8:]
    return torch.cat([a * c - b * s, a * s + b * c], -1)


def _grid_cases(dtype):
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dtype)
    B, S, C = 2, 12, 32
    yield "bulk/param/rep/tile", _roles_chain, (
        t(B, S, C), t(C), t(B, 1, C), t(1, S, C))
    yield "bcast", _bcast_chain, (t(2, 3, 4, 2, 16), t(2, 1, 4, 1, 16))
    yield "padded rows, lane reduce, two outputs", _reduce_chain, (
        t(5, 8, 24), t(24))
    yield "lane slices + concat, rep", _rope_chain, (
        t(4, 1, 6, 16), t(4, 1, 1, 8), t(4, 1, 1, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_plain_matches_jax_interpret(dtype):
    roles = set()
    for label, fn, args in _grid_cases(dtype):
        calls = _plan_calls(fn, args)
        assert calls and all(c["kind"] == "grid" for c in calls), label
        for call in calls:
            roles |= {s[0] for s in call["specs"]}
            vals = _operands(call, 1, dtype)
            got = ops.fused_segment_grid(
                call["progs"].body, vals, call["specs"], rows=call["rows"],
                out_cols=call["out_cols"], out_dtypes=call["out_dtypes"],
                rows_block=GRID_ROWS_BLOCK, impl="ref")
            want = jfe.fused_segment_grid(
                jax_program(call["progs"].body), [_jx(v) for v in vals],
                call["specs"], rows=call["rows"], out_cols=call["out_cols"],
                out_dtypes=[_JD[d] for d in call["out_dtypes"]],
                rows_block=GRID_ROWS_BLOCK, interpret=True)
            _close(got, want, dtype)
            rb, pad, _ = fe.segment_row_block(call["rows"], call["specs"],
                                              GRID_ROWS_BLOCK)
            if label.startswith("padded"):
                assert pad > 0
    assert roles >= {"bulk", "param", "rep", "tile", "bcast"}


def test_legacy_fused_elementwise_entry_points():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 10, 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((6, 10, 32)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))
    got = ops.fused_elementwise(lambda a, b, c: a * c + torch.tanh(b),
                                [x, y], [s])
    want = jfe.fused_elementwise(lambda a, b, c: a * c + jnp.tanh(b),
                                 [jnp.asarray(x.numpy()),
                                  jnp.asarray(y.numpy())],
                                 [jnp.asarray(s.numpy())], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[
        torch.float32])
    outs = ops.fused_segment(lambda a, b: (a + b, a * b), [x, y],
                             out_dtypes=[torch.float32, torch.bfloat16])
    assert outs[1].dtype == torch.bfloat16 and outs[0].shape == x.shape
    torch.testing.assert_close(outs[0], x + y)


# ---------------------------------------------------------------- B3
def _mm_cases():
    rng = np.random.default_rng(5)

    def t(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dtype)
    R, K, N = 24, 48, 64
    yield ("lhs prologue + gelu", torch.float32,
           lambda x, s, w: F.gelu((x * s) @ w, approximate="tanh"),
           (t(R, K), t(K), t(K, N, scale=K ** -0.5)))
    yield ("bf16 weight prologue", torch.float32,
           lambda x, w: torch.tanh(x @ w.float()),
           (t(R, K), t(K, N, scale=K ** -0.5, dtype=torch.bfloat16)))
    yield ("lane split (swiglu)", torch.float32,
           lambda x, w: F.silu((x @ w)[:, :N // 2]) * (x @ w)[:, N // 2:]
           if False else (lambda h: F.silu(h[:, :N // 2]) * h[:, N // 2:])(
               x @ w), (t(R, K), t(K, N, scale=K ** -0.5)))
    for dtype in (torch.float32, torch.bfloat16):
        yield ("lane reduce (residual + rmsnorm)", dtype,
               lambda x, w, y, s: (lambda h: (h, h * torch.rsqrt(torch.mean(
                   h.float() * h.float(), -1, keepdim=True) + 1e-5).to(
                   h.dtype) * s))(x @ w + y),
               (t(R, K, dtype=dtype), t(K, N, scale=K ** -0.5, dtype=dtype),
                t(R, N, dtype=dtype), t(N, dtype=dtype)))


@pytest.mark.parametrize("case", range(5))
def test_matmul_plain_matches_jax_interpret(case):
    label, dtype, fn, args = list(_mm_cases())[case]
    calls = [c for c in _plan_calls(fn, args) if c["kind"] == "matmul"]
    assert len(calls) == 1, label
    call = calls[0]
    progs = call["progs"]
    if "lhs prologue" in label:
        assert progs.lhs is not None
    if "weight prologue" in label:
        assert progs.rhs is not None
    if "reduce" in label:
        assert progs.body.reductions
    if "split" in label:
        assert any(op.kind == "slice" for op in progs.body.ops)
    vals = _operands(call, 2, dtype)
    nl, nr, sp = call["n_lhs"], call["n_rhs"], call["specs"]
    kw = dict(rows=call["rows"], k_dim=call["k"], n_dim=call["n"],
              out_cols=call["out_cols"])
    got = ops.fused_matmul_segment(
        progs.lhs, progs.rhs, progs.body, vals[:nl], sp[:nl],
        vals[nl:nl + nr], sp[nl:nl + nr], vals[nl + nr:], sp[nl + nr:],
        acc_dtype=call["acc_dtype"], out_dtypes=call["out_dtypes"],
        rows_block=MATMUL_ROWS_BLOCK, vmem_bytes=call["vmem_bytes"],
        sms=call["sms"], impl="ref", **kw)

    def pro(*b, block_rows):
        return jax_program(progs.lhs)(*b, block_rows=block_rows)[0] \
            if progs.lhs else b[0]

    def rhs_pro(*b, block_rows):
        return jax_program(progs.rhs)(*b, block_rows=block_rows)[0] \
            if progs.rhs else b[0]
    jv = [_jx(v) for v in vals]
    want = jfm.fused_matmul_segment(
        pro, rhs_pro, jax_program(progs.body), jv[:nl], sp[:nl],
        jv[nl:nl + nr], sp[nl:nl + nr], jv[nl + nr:], sp[nl + nr:],
        acc_dtype=_JD[call["acc_dtype"]],
        out_dtypes=[_JD[d] for d in call["out_dtypes"]], interpret=True,
        **kw)
    _close(got, want, dtype)


# ----------------------------------------------------- geometry helpers
_ROLE = st.sampled_from(["bulk", "param", "rep", "tile"])


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 6), st.integers(1, 6), st.integers(1, 40),
       st.integers(1, 600), _ROLE)
def test_row_block_helpers_equal_the_reference(b, s, c, rows_block, role):
    rows = b * s * c
    op_rows = {"rep": b, "tile": s * c, "bulk": rows, "param": 1}[role]
    specs = [(role, op_rows, 8)]
    assert fe.segment_row_block(rows, specs, rows_block) == \
        jfe.segment_row_block(rows, specs, rows_block)
    for n in (1, 64, 2048, 152064):
        for budget in (4096, 232448, 4 * 1024 * 1024):
            assert fm._row_block(rows, specs, rows_block, n, budget) == \
                jfm._row_block(rows, specs, rows_block, n, budget)
            assert fm.matmul_row_blocks(rows, specs, n, rows_block,
                                        budget) == \
                jfm.matmul_row_blocks(rows, specs, n, rows_block, budget)
            assert fm._block_budget(rows_block, n, budget) == \
                jfm._block_budget(rows_block, n, budget)
    assert fe._largest_divisor_leq(rows, rows_block) == \
        jfe._largest_divisor_leq(rows, rows_block)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 4), min_size=2, max_size=4),
       st.lists(st.booleans(), min_size=4, max_size=4), st.integers(0, 3))
def test_bcast_row_index_and_its_emitted_arithmetic(dims, keep, rb_pick):
    out_lead = tuple(dims)
    op_lead = tuple(d if k else 1 for d, k in zip(out_lead, keep))
    divs = [d for d in range(1, out_lead[-1] + 1) if out_lead[-1] % d == 0]
    rb = divs[rb_pick % len(divs)]
    brows, fn = fe._bcast_row_index(op_lead, out_lead, rb)
    jbrows, jfn = jfe._bcast_row_index(op_lead, out_lead, rb)
    ebrows, expr = bcast_row_expr(op_lead, out_lead, rb, "i")
    assert brows == jbrows == ebrows
    n_blocks = int(np.prod(out_lead)) // rb
    for i in range(n_blocks):
        assert fn(i) == jfn(i) == eval(expr, {"i": i})


# ------------------------------------------------------------- B4, B6
jfmb = importlib.import_module("repro.kernels.fused_matmul_bwd")
jadamw = importlib.import_module("repro.kernels.adamw_update")


def _bwd_cases(dtype):
    rng = np.random.default_rng(7)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dtype)
    B, S, K, N = 2, 12, 40, 24
    yield ("dlhs", "param/rep/tile", 1,
           lambda g, w, p, r, q: (torch.tanh(g @ w.t()) * p + r) * q,
           (t(B, S, K), t(N, K, scale=K ** -0.5), t(N), t(B, 1, N),
            t(1, S, N)))
    yield ("dlhs", "bcast", 1, lambda g, w, o: torch.tanh(g @ w.t()) * o,
           (t(2, 3, 4, 2, K), t(N, K, scale=K ** -0.5), t(2, 1, 4, 1, N)))
    yield ("dlhs", "lhs prologue, lane reduce", 1,
           lambda g, s, w: (lambda h: h * torch.rsqrt(torch.mean(
               h * h, -1, keepdim=True) + 1e-5))((g * s) @ w.t()),
           (t(B * S, K), t(K), t(N, K, scale=K ** -0.5)))
    yield ("dlhs", "batch 2", 2, lambda g, w, y: torch.tanh(g @ w.t()) + y,
           (t(B * S, K), t(N, K, scale=K ** -0.5), t(B * S, N)))
    yield ("drhs", "bulk/column/param", 1,
           lambda x, g, w, c, b: ((x.t() @ g) * 0.5 + 0.01 * w + c) * b,
           (t(B * S, K), t(B * S, N), t(K, N), t(K, 1), t(N)))
    yield ("drhs", "batch 2", 2, lambda x, g, w: x.t() @ g + 0.01 * w,
           (t(B * S, K), t(B * S, N), t(K, N)))


def _bwd_call(fn, args, form):
    calls = [c for c in _plan_calls(fn, args, threshold=16)
             if c["kind"] == "matmul"]
    assert len(calls) == 1 and calls[0]["form"] == form
    return calls[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_contraction_plain_versions_match_jax_interpret(dtype):
    """B4 (dlhs) and B6 (drhs) plain versions against the Pallas kernels
    in interpret mode, for every epilogue role, an lhs prologue, a lane
    reduction and ``batch`` > 1 (each batch slice against its own slice
    of the weight, or of both operands)."""
    roles = {"dlhs": set(), "drhs": set()}
    rng = np.random.default_rng(8)
    for form, label, batch, fn, args in _bwd_cases(dtype):
        call = _bwd_call(fn, args, form)
        progs, sp = call["progs"], call["specs"]
        nl = call["n_lhs"]
        rows, k, n = call["rows"], call["k"], call["n"]
        vals = _operands(call, 9, dtype)
        epi_vals, epi_specs = vals[nl + 1:], sp[nl + 1:]
        roles[form] |= {s[0] for s in sp}
        jepi = jax_program(progs.body)
        common = dict(acc_dtype=call["acc_dtype"], out_cols=call["out_cols"],
                      out_dtypes=call["out_dtypes"], batch=batch)
        jcommon = dict(common, acc_dtype=_JD[call["acc_dtype"]],
                       out_dtypes=[_JD[d] for d in call["out_dtypes"]],
                       interpret=True)
        if form == "dlhs":
            # the forward weight: [n, k] rows, one slice per batch
            w = torch.from_numpy((rng.standard_normal((batch, n, k))
                                  / np.sqrt(k)).astype(np.float32)).to(dtype)
            w = w[0] if batch == 1 else w
            got = ops.fused_matmul_dlhs_segment(
                progs.lhs, progs.body, vals[:nl], sp[:nl], w, epi_vals,
                epi_specs, rows=rows, k_dim=k, n_dim=n,
                rows_block=MATMUL_ROWS_BLOCK, vmem_bytes=call["vmem_bytes"],
                sms=call["sms"], impl="ref", **common)

            def pro(*b, block_rows):
                return jax_program(progs.lhs)(*b, block_rows=block_rows)[0] \
                    if progs.lhs else b[0]
            jv = [_jx(v) for v in vals]
            want = jfmb.fused_matmul_dlhs_segment(
                pro, jepi, jv[:nl], sp[:nl], _jx(w), jv[nl + 1:], epi_specs,
                rows=rows, k_dim=k, n_dim=n, **jcommon)
        else:
            # x [m, rows] and g [m, n], per batch slice
            m = k // batch
            x = torch.from_numpy(rng.standard_normal(
                (batch * m, rows // batch)).astype(np.float32)).to(dtype)
            gg = torch.from_numpy(rng.standard_normal(
                (batch * m, n)).astype(np.float32)).to(dtype)
            got = ops.fused_matmul_drhs_segment(
                progs.body, x, gg, epi_vals, epi_specs, m_dim=m, rows=rows,
                n_dim=n, vmem_bytes=call["vmem_bytes"], impl="ref", **common)
            want = jfmb.fused_matmul_drhs_segment(
                jepi, _jx(x), _jx(gg), [_jx(v) for v in epi_vals],
                epi_specs, m_dim=m, rows=rows, n_dim=n, **jcommon)
        _close(got, want, dtype)
    assert roles["dlhs"] >= {"bulk_k", "param_k", "bulk_w", "bulk", "param",
                             "rep", "tile", "bcast"}
    assert roles["drhs"] >= {"bulk_m", "bulk_w", "bulk", "param"}


def test_drhs_geometry_helpers():
    """The drhs tile: 128 lanes, rows a divisor of the per-batch rows
    within one 32-row register tile and the accumulator budget."""
    from repro_torch.kernels import fused_matmul_bwd as fmb
    assert fmb.drhs_blocks(2048, 152064, vmem_bytes=232448) == (32, 128)
    assert fmb.drhs_blocks(96, 24, vmem_bytes=232448) == (32, 24)
    assert fmb.drhs_blocks(4096, 512, vmem_bytes=4096) == (8, 128)
    assert fmb.drhs_blocks(40, 64, vmem_bytes=232448, batch=2) == (20, 64)
    assert fmb.drhs_grid_blocks(2048, 6144, vmem_bytes=232448) == (64, 48)


# ------------------------------------------------------------------- B8
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_adamw_plain_version_matches_jax_interpret(pdtype):
    rng = np.random.default_rng(10)
    hyper = np.array([1e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                      1 - 0.95 ** 3], np.float32)
    for shape in ((5, 24), (40,), (3, 4, 16)):
        p, g = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(pdtype) for _ in range(2))
        m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.random(shape).astype(np.float32))
        got = ops.adamw_update(p, g, m, v, torch.from_numpy(hyper),
                               impl="ref")
        want = jadamw.adamw_update(_jx(p), _jx(g), _jx(m), _jx(v),
                                   jnp.asarray(hyper), interpret=True)
        for a, b in zip(got, want, strict=True):
            assert tuple(a.shape) == tuple(b.shape)
            tol = TOL[torch.bfloat16] if a.dtype == torch.bfloat16 else \
                dict(rtol=2e-6, atol=1e-7)
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)), **tol)
