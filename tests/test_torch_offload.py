"""The port's offload compiler on the CPU, held against the JAX
package's (``repro.core.offload``): the forward ``MUST_FUSE`` chains of
``benchmarks/offload_bench.py`` plan the committed segment count at or
above their traffic floors and compute what the JAX chains compute;
two decoder-block chains plan the same segments, forms and roles as the
JAX planner; out-of-slice contractions are declined with a reason; the
policy modes and the plan cache behave as the reference's.  The kernels
run as their plain versions here (CPU tensors); the code generators are
exercised on every planned segment.

Tolerance: f32 2e-5 (the fused programs evaluate the same ops in the
same order; only reductions may reassociate).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import OffloadPolicy as JPolicy
from repro.core import mpu_offload as jmpu_offload
from repro.core import offload_explain as joffload_explain
from repro_torch.core import OffloadPolicy, mpu_offload, offload_policy
from repro_torch.core import prims
from repro_torch.core.offload import (
    kernel_symbol,
    offload_report,
    segment_call,
)
from repro_torch.kernels import fused_elementwise as fe
from repro_torch.kernels import fused_matmul as fm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
ROWS = 512               # the bench's 4096 rows, reduced
BENCH_THRESHOLD = 4096   # the bench's bulk_threshold


def _bench():
    spec = importlib.util.spec_from_file_location(
        "offload_bench", ROOT / "benchmarks" / "offload_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BENCH = _bench()
MUST_FUSE = _BENCH.MUST_FUSE


# ------------------------------------------------------------------ tables
def test_prims_tables_name_real_aten_packets():
    """Every name the planner classifies by is a live aten overload
    packet (the counterpart of test_locator's registry check)."""
    for table in (prims.ELEMENTWISE_PRIMS, prims.LAYOUT_PRIMS,
                  prims.ANCHOR_PRIMS, prims.REDUCE_LANE_PRIMS,
                  prims.FAR_PRIMS, set(prims._INDEX_OPERANDS)):
        for name in table:
            packet = getattr(torch.ops.aten, name, None)
            assert isinstance(packet, torch._ops.OpOverloadPacket), name
    for op in prims.DECOMPOSITIONS:
        assert isinstance(op, torch._ops.OpOverload)
    assert prims.eqn_tier("mm") == "anchor"
    assert prims.eqn_tier("sum") == "reduce"
    assert prims.eqn_tier("mul") == "near"
    assert prims.eqn_tier("view") == "layout"
    assert prims.eqn_tier("index_put_") == "far"


# ----------------------------------------------------------- MUST_FUSE
def _chain_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, 256)).astype(np.float32)
    y = rng.standard_normal((ROWS, 256)).astype(np.float32)
    b = rng.standard_normal((256,)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal((256,))).astype(np.float32)
    w = (0.05 * rng.standard_normal((256, 256))).astype(np.float32)
    wgu = (0.05 * rng.standard_normal((256, 512))).astype(np.float32)
    return dict(x=x, y=y, b=b, s=s, w=w, wgu=wgu)


def _gelu(v):
    return F.gelu(v, approximate="tanh")


TORCH_CHAINS = {
    "AXPY": (lambda x, y: 2.5 * x + y, ("x", "y")),
    "BIAS_GELU_RES": (lambda x, y, b: _gelu(x + b) + y, ("x", "y", "b")),
    "SWIGLU_EPI": (lambda x, y: F.silu(x) * y, ("x", "y")),
    "RMS_SCALE_RES": (lambda x, y, s: torch.tanh(x) * s + y * 0.5,
                      ("x", "y", "s")),
    "ADAM_CHAIN": (lambda x, y: x - 1e-3 * (0.9 * x + 0.1 * y) / (
        torch.sqrt(0.95 * x + 0.05 * y * y) + 1e-8), ("x", "y")),
    "MLP_RESIDUAL": (lambda x, w, b, y: (lambda h: h * torch.sigmoid(h) + y)(
        _gelu(x @ w + b)), ("x", "w", "b", "y")),
    "GEMM_BIAS_GELU": (lambda x, w, b, y: _gelu(x @ w + b) + y,
                       ("x", "w", "b", "y")),
    "GEMM_SWIGLU": (lambda x, wgu: (lambda hw: F.silu(hw[:, :256])
                                    * hw[:, 256:])(x @ wgu), ("x", "wgu")),
    "RMSNORM_CHAIN": (lambda x, s: x * torch.rsqrt(
        torch.mean(x * x, dim=-1, keepdim=True) + 1e-5) * s, ("x", "s")),
    "SOFTMAX_CHAIN": (lambda x: torch.softmax(x * 0.125, dim=-1), ("x",)),
}

FORWARD_CHAINS = [name for name, (segs, _, bwd) in MUST_FUSE.items()
                  if bwd == 0 and name in TORCH_CHAINS]


def test_forward_must_fuse_chains_are_the_ten():
    assert sorted(FORWARD_CHAINS) == sorted(TORCH_CHAINS)


_JAX_FNS = {name: fn for name, fn, _, _ in _BENCH._cases()}


@pytest.mark.parametrize("name", sorted(TORCH_CHAINS))
def test_must_fuse_chain_plans_as_committed_and_matches_jax(name):
    segs, floor, _ = MUST_FUSE[name]
    fn, names = TORCH_CHAINS[name]
    data = _chain_inputs()
    targs = [torch.from_numpy(data[n]) for n in names]
    policy = OffloadPolicy(bulk_threshold=BENCH_THRESHOLD)
    plan = offload_report(fn, *targs, policy=policy)
    assert len(plan.segments) == segs, str(plan.report())
    assert plan.traffic_reduction >= floor, plan.traffic_reduction
    got = mpu_offload(fn, policy=policy)(*targs)
    want = jmpu_offload(_JAX_FNS[name], policy=JPolicy(
        bulk_threshold=BENCH_THRESHOLD))(*[jnp.asarray(data[n])
                                           for n in names])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               equal_nan=True, **TOL)
    # the unwrapped torch chain agrees too
    np.testing.assert_allclose(got.numpy(), fn(*targs).numpy(),
                               equal_nan=True, **TOL)


@pytest.mark.parametrize("name", sorted(TORCH_CHAINS))
def test_cost_mode_decision_bytes_never_exceed_greedy(name):
    fn, names = TORCH_CHAINS[name]
    data = _chain_inputs()
    targs = [torch.from_numpy(data[n]) for n in names]

    def fused_decision_bytes(mode):
        plan = offload_report(fn, *targs, policy=OffloadPolicy(
            mode=mode, bulk_threshold=BENCH_THRESHOLD))
        return sum(d.near_bytes if d.fused else d.far_bytes
                   for d in plan.decisions)

    assert fused_decision_bytes("cost") <= fused_decision_bytes("greedy")


# ------------------------------------------------- decoder-block chains
B, S, D, NQ, NK, H, FF = 2, 4, 64, 4, 2, 16, 128


def _block_data(seed=1):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    return dict(
        x=rng.standard_normal((B, S, D)).astype(np.float32),
        a=rng.standard_normal((B, S, NQ * H)).astype(np.float32),
        s=(1.0 + 0.1 * rng.standard_normal((D,))).astype(np.float32),
        qs=(1.0 + 0.1 * rng.standard_normal((H,))).astype(np.float32),
        ks=(1.0 + 0.1 * rng.standard_normal((H,))).astype(np.float32),
        wq=w(D, NQ * H), wk=w(D, NK * H), wv=w(D, NK * H), wo=w(NQ * H, D),
        wg=w(D, FF), wu=w(D, FF), wd=w(FF, D))


def _jrms(x, s):
    var = jnp.mean(x * x, axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + 1e-5) * s


def _trms(x, s):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-5) * s


def _jqkv(x, s, wq, wk, wv, qs, ks):
    h = _jrms(x, s)
    q = (h @ wq).reshape(B, S, NQ, H)
    k = (h @ wk).reshape(B, S, NK, H)
    return _jrms(q, qs), _jrms(k, ks), h @ wv


def _tqkv(x, s, wq, wk, wv, qs, ks):
    h = _trms(x, s)
    q = (h @ wq).reshape(B, S, NQ, H)
    k = (h @ wk).reshape(B, S, NK, H)
    return _trms(q, qs), _trms(k, ks), h @ wv


def _jmlp(a, x, wo, s, wg, wu, wd):
    x = x + a @ wo
    h = _jrms(x, s)
    u = h @ wu
    g = h @ wg
    return x + (g * jax.lax.logistic(g) * u) @ wd


def _tmlp(a, x, wo, s, wg, wu, wd):
    x = x + a @ wo
    h = _trms(x, s)
    u = h @ wu
    g = h @ wg
    return x + (F.silu(g) * u) @ wd


BLOCK_CHAINS = {
    "rmsnorm_qkv_qknorm": (_jqkv, _tqkv,
                           ("x", "s", "wq", "wk", "wv", "qs", "ks")),
    "oproj_rmsnorm_swiglu_down": (_jmlp, _tmlp,
                                  ("a", "x", "wo", "s", "wg", "wu", "wd")),
}


def _signature(report):
    return [(d.tier, d.form, d.fused, d.roles) for d in report.decisions]


@pytest.mark.parametrize("name", sorted(BLOCK_CHAINS))
def test_decoder_block_chain_plans_like_jax(name):
    jfn, tfn, names = BLOCK_CHAINS[name]
    data = _block_data()
    jargs = [jnp.asarray(data[n]) for n in names]
    targs = [torch.from_numpy(data[n]) for n in names]
    jrep = joffload_explain(jfn, *jargs, policy=JPolicy(bulk_threshold=64))
    trep = offload_report(tfn, *targs,
                          policy=OffloadPolicy(bulk_threshold=64)).report()
    assert trep.n_fused == jrep.n_fused > 0
    assert _signature(trep) == [(d.tier, d.form, d.fused, d.roles)
                                for d in jrep.decisions], \
        f"{trep}\n---\n{jrep}"
    got = mpu_offload(tfn, policy=OffloadPolicy(bulk_threshold=64))(*targs)
    want = jfn(*jargs)
    gots = list(got) if isinstance(got, (tuple, list)) else [got]
    for w, g in zip(jax.tree.leaves(want), gots, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ------------------------------------------------------ declines / modes
def test_transposed_weight_mm_and_bmm_are_declined_with_a_reason():
    """A transposed weight is the dlhs form and is planned; a batched
    contraction (``bmm``) with leading batch axes anchors the batched
    forward form; an ``mm`` over a strided operand (neither row-major nor
    a transposed row-major view) is declined with its reason and runs
    unfused."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    wide = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((4, 16, 32)).astype(
        np.float32))
    wb = torch.from_numpy(rng.standard_normal((4, 32, 24)).astype(
        np.float32))

    def dlhs(x, w):
        return torch.tanh(x @ w.t()) * 2.0 + 1.0

    def batched(xb, wb):
        return torch.tanh(torch.bmm(xb, wb)) * 2.0 + 1.0

    def strided(x, wide):
        return torch.tanh(x @ wide[:, ::2]) * 2.0 + 1.0

    policy = OffloadPolicy(bulk_threshold=64)
    plan = offload_report(dlhs, x, w, policy=policy)
    assert [s.matmul.form for s in plan.segments] == ["dlhs"]
    plan = offload_report(batched, xb, wb, policy=policy)
    assert [(s.matmul.form, s.matmul.batch, s.matmul.batch_shape)
            for s in plan.segments] == [("fwd", 4, (4,))]
    assert [(d.form, d.batch, d.fused) for d in plan.decisions] == \
        [("fwd", (4,), True)]
    plan = offload_report(strided, x, wide, policy=policy)
    assert all(s.matmul is None for s in plan.segments)
    declined = [d for d in plan.decisions if d.form == "strided"]
    assert len(declined) == 1 and not declined[0].fused
    assert "neither row-major nor" in declined[0].reason
    for fn, args in ((dlhs, (x, w)), (batched, (xb, wb)),
                     (strided, (x, wide))):
        torch.testing.assert_close(mpu_offload(fn, policy=policy)(*args),
                                   fn(*args), **TOL)


def test_lane_reduce_anchor_past_the_smem_budget_is_declined():
    """A lane-reduce epilogue holds its f32 row and a 128 B reduction
    scratch in one block's shared memory: over N = 1024 lanes that is
    4224 B, past a 4096 B budget, so the anchor stays far (with the
    reason in explain()) while the default budget fuses it."""
    rng = np.random.default_rng(3)
    n = 1024
    data = dict(x=rng.standard_normal((16, 64)).astype(np.float32),
                w=(rng.standard_normal((64, n)) / 8).astype(np.float32),
                s=(1.0 + 0.1 * rng.standard_normal((n,))).astype(np.float32))
    targs = [torch.from_numpy(data[k]) for k in ("x", "w", "s")]

    def tfn(x, w, s):
        return _trms(x @ w, s)

    def jfn(x, w, s):
        return _jrms(x @ w, s)

    assert fm.row_fits(992, 4096) and not fm.row_fits(993, 4096)
    fits = offload_report(tfn, *targs, policy=OffloadPolicy(bulk_threshold=64))
    assert [s.matmul is not None for s in fits.segments] == [True]
    policy = OffloadPolicy(bulk_threshold=64, smem_budget=4096)
    plan = offload_report(tfn, *targs, policy=policy)
    assert all(s.matmul is None for s in plan.segments)
    declined = [d for d in plan.decisions if d.tier == "anchor"]
    assert len(declined) == 1 and not declined[0].fused
    assert "4224 B" in declined[0].reason and \
        "4096 B shared-memory budget" in declined[0].reason
    wrapped = mpu_offload(tfn, policy=policy)
    assert declined[0].reason in str(wrapped.explain(*targs))
    want = jmpu_offload(jfn, policy=JPolicy(bulk_threshold=64))(
        *[jnp.asarray(data[k]) for k in ("x", "w", "s")])
    np.testing.assert_allclose(wrapped(*targs).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("name", ["GEMM_BIAS_GELU", "RMSNORM_CHAIN",
                                  "SOFTMAX_CHAIN"])
def test_all_far_plans_nothing_and_equals_the_unwrapped_function(name):
    fn, names = TORCH_CHAINS[name]
    data = _chain_inputs()
    targs = [torch.from_numpy(data[n]) for n in names]
    policy = OffloadPolicy(mode="all_far", bulk_threshold=BENCH_THRESHOLD)
    assert offload_report(fn, *targs, policy=policy).segments == []
    torch.testing.assert_close(mpu_offload(fn, policy=policy)(*targs),
                               fn(*targs), **TOL)


def test_plan_cache_hits_misses_and_evicts_lru():
    fn, _ = TORCH_CHAINS["AXPY"]
    wrapped = mpu_offload(fn, policy=OffloadPolicy(bulk_threshold=16,
                                                   max_plans=2))
    mk = [torch.ones((n, 8)) for n in (4, 8, 16)]
    wrapped(mk[0], mk[0])
    wrapped(mk[0], mk[0])
    assert (wrapped.stats.plan_misses, wrapped.stats.plan_hits) == (1, 1)
    wrapped(mk[1], mk[1])                          # new signature: miss
    assert wrapped.stats.plan_misses == 2 and wrapped.cache_size() == 2
    wrapped(mk[2], mk[2])                          # past max_plans
    assert wrapped.stats.evictions == 1 and wrapped.cache_size() == 2
    wrapped(mk[0], mk[0])                          # the evicted one
    assert wrapped.stats.plan_misses == 4
    wrapped.explain(mk[1], mk[1])                  # introspection: no count
    assert wrapped.stats.plan_misses == 4
    with offload_policy(OffloadPolicy(mode="all_far", bulk_threshold=16)):
        wrapped(mk[0], mk[0])                      # policy is in the key
    assert wrapped.stats.plan_misses == 5


# -------------------------------------------------------- code generators
def _plans():
    data = _chain_inputs()
    policy = OffloadPolicy(bulk_threshold=BENCH_THRESHOLD)
    for name, (fn, names) in sorted(TORCH_CHAINS.items()):
        yield name, offload_report(
            fn, *[torch.from_numpy(data[n]) for n in names], policy=policy)
    bdata = _block_data()
    for name, (_, tfn, names) in sorted(BLOCK_CHAINS.items()):
        yield name, offload_report(
            tfn, *[torch.from_numpy(bdata[n]) for n in names],
            policy=OffloadPolicy(bulk_threshold=64))
    # the engine's paged decode step (the plan of the offloaded engine
    # test), in f32 and bf16
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                                  dtype=dtype, num_layers=2)
        params = build_model(cfg, device="cpu").init(0)
        eng = Engine(cfg, params, device="cpu", slots=2, max_len=48,
                     page_size=8, offload_policy=OffloadPolicy(
                         bulk_threshold=32))
        yield f"decode step {dtype}", eng.decode_plan()


def test_code_generators_emit_every_planned_segment_deterministically():
    n_grid = n_mm = 0
    for name, plan in _plans():
        for seg in plan.segments:
            call = segment_call(plan.eqns, seg)
            if call["kind"] == "grid":
                kname, src, geo = fe.triton_source(
                    call["progs"].body, rows=call["rows"],
                    specs=call["specs"], rows_block=16)
                assert f"def {kname}(" in src and "tl.store" in src
                compile(src, kname, "exec")        # valid Python
                n_grid += 1
            else:
                sym = kernel_symbol(call)
                src = fm.translation_unit([sym]) if sym in fm._SEGMENTS \
                    else None
                gen = _gen(call)
                assert gen["name"] == sym
                assert f'extern "C" int {sym}_launch' in gen["source"]
                assert f"fm_gemm<{sym}_S>" in gen["source"]
                n_mm += 1
                del src
            assert kernel_symbol(call) == kernel_symbol(
                segment_call(plan.eqns, seg))       # same plan, same hash
    assert n_grid > 0 and n_mm > 0


def _gen(call):
    from repro_torch.core.offload import _matmul_gen
    return _matmul_gen(call)


def test_row_statistics_broadcast_only_in_their_keepdim_form():
    """A rank-reduced row statistic ([B, S] against [B, S, D]) broadcasts
    over torch's trailing dims, not over the lanes: it must not be fused
    as a lane broadcast.  The keepdim form is one segment."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 4, 4)).astype(np.float32))
    policy = OffloadPolicy(bulk_threshold=8, mode="all_near")

    def rank_reduced(x):
        return x * 2.0 - x.sum(-1) + 1.0

    def keepdim(x):
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) / 4 + 1e-5)

    assert len(offload_report(keepdim, x, policy=policy).segments) == 1
    for fn in (rank_reduced, keepdim):
        torch.testing.assert_close(mpu_offload(fn, policy=policy)(x), fn(x),
                                   **TOL)


def test_decode_plan_counts_stay_as_the_forward_slice_left_them():
    """Casting weights at use adds nothing to the served graph (the
    engine's copy is cast once): the paged decode step of the tiny
    2-layer engine plans exactly what it planned before the training
    slice — the same fused and declined counts over the same nodes."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine

    pinned = {"float32": (15, 9, 6, 265), "bfloat16": (16, 8, 7, 292)}
    for dtype, (fused, declined, anchored, nodes) in pinned.items():
        cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                                  dtype=dtype, num_layers=2)
        masters = build_model(cfg, device="cpu").init(0)
        assert all(t.dtype == torch.float32
                   for t in torch.utils._pytree.tree_leaves(masters))
        eng = Engine(cfg, masters, device="cpu", slots=2, max_len=48,
                     page_size=8, offload_policy=OffloadPolicy(
                         bulk_threshold=32))
        plan = eng.decode_plan()
        report = plan.report()
        assert (report.n_fused, report.n_declined) == (fused, declined)
        assert sum(s.matmul is not None for s in plan.segments) == anchored
        assert len(plan.eqns) == nodes
