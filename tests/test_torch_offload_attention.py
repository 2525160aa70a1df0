"""Batched anchors and the flash-shaped attention segment in the port's
offload compiler, held against the JAX package on the CPU — the cases of
``tests/test_offload_attention.py`` re-expressed in torch:

* the attention chain (QK^T -> scale -> row softmax -> PV) plans as ONE
  flash segment riding a batched ``dlhs`` anchor, with the batch axes
  ``(2, 4)`` recovered from the views around ``bmm``, as the JAX planner
  plans it; its [S, T] scores add zero bytes (>= 4x modeled traffic);
* forward and gradient parity with the JAX chains, f32 and bf16, on a
  GQA head-group shape;
* near misses (a mask, value lanes other than the head dim) stay
  ordinary segments and still compute the chain;
* the batched ``MUST_FUSE`` chains of ``benchmarks/offload_bench.py``
  (``ATTN_PREFILL``, ``BATCHED_GEMM_BWD``) plan their committed counts;
* the model attention's ``bmm`` (batch axes moved into place by a copy)
  stays declined with its reason.

The kernels run as their plain versions here (CPU tensors).
Tolerances: the reference test's — f32 forward 1e-5, bf16 2e-2, f32
gradients 1e-4, bf16 gradients 5e-2.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import offload_report as joffload_report
from repro_torch.core import OffloadPolicy, mpu_offload
from repro_torch.core.offload import bwd_plans, clear_bwd_plans, offload_report

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POLICY = OffloadPolicy(bulk_threshold=64)
_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _bench():
    spec = importlib.util.spec_from_file_location(
        "offload_bench", ROOT / "benchmarks" / "offload_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BENCH = _bench()


def _jattn(q, k, v):
    scale = jnp.sqrt(q.shape[-1]).astype(q.dtype)
    s = jnp.einsum("bhsd,bhtd->bhst", q, k) / scale
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhst,bhtd->bhsd", p, v)


def _tattn(q, k, v):
    scale = torch.tensor(math.sqrt(q.shape[-1])).to(q.dtype)
    s = torch.einsum("bhsd,bhtd->bhst", q, k) / scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v)


def _qkv(b=2, h=4, s=32, d=16, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s, dv or d)).astype(np.float32))


def _both(arrays, dtype="float32"):
    return ([torch.from_numpy(a).to(_TD[dtype]) for a in arrays],
            [jnp.asarray(a).astype(_JD[dtype]) for a in arrays])


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _flash(seg) -> bool:
    return seg.matmul is not None and seg.matmul.flash is not None


def test_attention_plans_as_single_flash_segment():
    (q, k, v), (jq, jk, jv) = _both(_qkv())
    plan = offload_report(_tattn, q, k, v, policy=POLICY)
    jplan = joffload_report(_jattn, jq, jk, jv, bulk_threshold=64)
    assert len(plan.segments) == len(jplan.segments) == 1
    mm, jmm = plan.segments[0].matmul, jplan.segments[0].matmul
    assert mm.flash is not None and jmm.flash is not None
    assert mm.form == jmm.form == "dlhs"
    assert mm.batch_shape == tuple(jmm.batch_shape) == (2, 4)
    assert mm.flash["scale"] == pytest.approx(jmm.flash["scale"])
    d = [d for d in plan.decisions if d.fused]
    assert d and d[0].form == "flash" and d[0].batch == (2, 4)


def test_attention_traffic_reduction_at_least_4x():
    """The [S, T] scores never reach device memory: >= 4x fewer modeled
    bytes than the unfused chain, and fewer than two round trips of the
    score matrix."""
    (q, k, v), _ = _both(_qkv(b=2, h=2, s=128, d=32))
    plan = offload_report(_tattn, q, k, v, policy=POLICY)
    assert len(plan.segments) == 1 and _flash(plan.segments[0])
    assert plan.traffic_reduction >= 4.0, plan.traffic_reduction
    score_bytes = 2 * 2 * 128 * 128 * 4
    assert plan.fused_hbm_bytes < 2 * score_bytes


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_forward_parity(dtype, tol):
    (q, k, v), (jq, jk, jv) = _both(_qkv(), dtype)
    got = mpu_offload(_tattn, policy=POLICY)(q, k, v)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(_jattn(jq, jk, jv)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(got), _np(_tattn(q, k, v)), rtol=tol,
                               atol=tol)


def test_attention_grad_parity_f32():
    """The flash segment differentiates through its planned backward:
    the cotangent program plans as batched dlhs / drhs / fwd segments."""
    arrays = _qkv(seed=1)
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    clear_bwd_plans()
    out = mpu_offload(_tattn, policy=POLICY)(*targs)
    got = torch.autograd.grad((out ** 2).sum(), targs)
    want = jax.grad(lambda *a: (_jattn(*a) ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name} mismatch")
    (plan,) = bwd_plans()
    anchors = {(d.form, d.batch) for d in plan.decisions
               if d.tier == "anchor"}
    assert {("dlhs", (2, 4)), ("drhs", (2, 4)), ("fwd", (2, 4))} <= anchors


def test_attention_grad_parity_bf16_gqa_shape():
    """bf16 gradients on a GQA head-group shape (query heads grouped over
    kv heads, kv repeated per group as qwen3-1.7b lowers it), scaled
    down."""
    b, nq, nkv, s, d = 2, 4, 2, 16, 16

    def tgqa(q, k, v):
        k = torch.repeat_interleave(k, nq // nkv, dim=1)
        v = torch.repeat_interleave(v, nq // nkv, dim=1)
        return _tattn(q, k, v)

    def jgqa(q, k, v):
        k = jnp.repeat(k, nq // nkv, axis=1)
        v = jnp.repeat(v, nq // nkv, axis=1)
        return _jattn(q, k, v)

    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((b, nq, s, d), (b, nkv, s, d), (b, nkv, s, d))]
    targs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
             for a in arrays]
    wrapped = mpu_offload(tgqa, policy=POLICY)
    plan = wrapped.plan_for(*targs)
    assert [s.matmul.batch_shape for s in plan.segments if _flash(s)] == \
        [(b, nq)]
    got = torch.autograd.grad((wrapped(*targs).float() ** 2).sum(), targs)
    want = jax.grad(lambda *a: (jgqa(*a).astype(jnp.float32) ** 2).sum(),
                    argnums=(0, 1, 2))(*[jnp.asarray(a, jnp.bfloat16)
                                         for a in arrays])
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=5e-2, atol=5e-2,
                                   err_msg=f"d{name} mismatch")


def test_masked_attention_does_not_flash_but_matches():
    """An additive mask between scale and softmax is not a plain softmax
    of scaled scores: no flash segment, and the result still equals the
    JAX chain."""
    def tmasked(q, k, v, m):
        s = torch.einsum("bhsd,bhtd->bhst", q, k) * 0.25 + m
        return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), v)

    def jmasked(q, k, v, m):
        s = jnp.einsum("bhsd,bhtd->bhst", q, k) * 0.25 + m
        return jnp.einsum("bhst,bhtd->bhsd", jax.nn.softmax(s, axis=-1), v)

    rng = np.random.default_rng(3)
    m = (rng.standard_normal((2, 4, 32, 32)) > 0).astype(np.float32) * -1e9
    (q, k, v, tm), (jq, jk, jv, jm) = _both([*_qkv(), m])
    plan = offload_report(tmasked, q, k, v, tm, policy=POLICY)
    jplan = joffload_report(jmasked, jq, jk, jv, jm, bulk_threshold=64)
    assert not any(_flash(s) for s in plan.segments)
    assert not any(_flash(s) for s in jplan.segments)
    got = mpu_offload(tmasked, policy=POLICY)(q, k, v, tm)
    np.testing.assert_allclose(_np(got), _np(jmasked(jq, jk, jv, jm)),
                               rtol=1e-5, atol=1e-5)


def test_mismatched_value_lanes_do_not_flash_but_match():
    """B5's PV tile takes value lanes equal to the head dim; other widths
    stay two ordinary anchored segments."""
    def tfn(q, k, v):
        s = torch.einsum("bhsd,bhtd->bhst", q, k) * 0.25
        return torch.einsum("bhst,bhte->bhse", torch.softmax(s, dim=-1), v)

    def jfn(q, k, v):
        s = jnp.einsum("bhsd,bhtd->bhst", q, k) * 0.25
        return jnp.einsum("bhst,bhte->bhse", jax.nn.softmax(s, axis=-1), v)

    (q, k, v), (jq, jk, jv) = _both(_qkv(dv=8))
    plan = offload_report(tfn, q, k, v, policy=POLICY)
    jplan = joffload_report(jfn, jq, jk, jv, bulk_threshold=64)
    assert not any(_flash(s) for s in plan.segments)
    assert not any(_flash(s) for s in jplan.segments)
    assert any(s.matmul is not None and s.matmul.batch_shape == (2, 4)
               for s in plan.segments)
    got = mpu_offload(tfn, policy=POLICY)(q, k, v)
    np.testing.assert_allclose(_np(got), _np(jfn(jq, jk, jv)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d,dtype,admitted", [
    (24, torch.float32, False), (96, torch.float32, False),
    (256, torch.float32, False), (32, torch.float16, False),
    (64, torch.bfloat16, True), (128, torch.bfloat16, True)])
def test_flash_pair_only_where_b5_takes_the_operands(d, dtype, admitted):
    """The planner admits the flash pair only where B5 takes what the
    flash segment would pass it (``flash_attention.refusal``: head dims
    16 / 32 / 64 / 128, f32 or bf16).  Otherwise it declines the pair
    with B5's reason in ``explain()`` and the chain runs as ordinary
    segments, matching the unwrapped chain (f32 1e-5; f16 2e-3, two ulps
    of an O(1) value; bf16 2e-2).  The JAX planner admits every f32 one:
    its Pallas kernel takes any head dim — a plan difference by design."""
    arrays = _qkv(d=d)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    plan = offload_report(_tattn, q, k, v, policy=POLICY)
    flash = [s for s in plan.segments if _flash(s)]
    declined = [x.reason for x in plan.decisions
                if x.form == "flash" and not x.fused]
    report = str(mpu_offload(_tattn, policy=POLICY).explain(q, k, v))
    if admitted:
        assert len(flash) == 1 and not declined
    else:
        assert not flash and len(declined) == 1
        assert "flash pair declined" in declined[0]
        assert ("head_dim" if dtype != torch.float16 else "float16") in \
            declined[0]
        assert declined[0] in report
    if dtype == torch.float32:
        jplan = joffload_report(_jattn, *map(jnp.asarray, arrays),
                                bulk_threshold=64)
        assert sum(_flash(s) for s in jplan.segments) == 1
    tol = {torch.float32: 1e-5, torch.float16: 2e-3,
           torch.bfloat16: 2e-2}[dtype]
    got = mpu_offload(_tattn, policy=POLICY)(q, k, v)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(_tattn(q, k, v)), rtol=tol,
                               atol=tol)


def test_a_copy_decides_by_where_it_moves_the_batch_axes():
    """A ``bmm`` operand that is a copy still anchors when the copy keeps
    the batch axes leading (a transposed matrix made contiguous); one
    whose copy moved non-leading axes to the front, as ``torch.einsum``
    does for ``bqkgh,bckh->bqkgc``, is declined with that reason."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 32, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 32, 24)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, 2, 2, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(
        np.float32))

    def kept(x, w):
        return torch.tanh(torch.bmm(x.transpose(1, 2).contiguous(), w))

    def moved(q, k):
        return torch.tanh(torch.einsum("bqkgh,bckh->bqkgc", q, k))

    plan = offload_report(kept, x, w, policy=POLICY)
    assert [(s.matmul.form, s.matmul.batch) for s in plan.segments] == \
        [("fwd", 4)]
    plan = offload_report(moved, q, k, policy=POLICY)
    assert all(s.matmul is None for s in plan.segments)
    (d,) = [d for d in plan.decisions if d.form == "bmm"]
    assert not d.fused and "batch axes not leading" in d.reason
    for fn, args in ((kept, (x, w)), (moved, (q, k))):
        torch.testing.assert_close(mpu_offload(fn, policy=POLICY)(*args),
                                   fn(*args), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ batched MUST_FUSE chains
def _attn_prefill(q, kk, vv):
    scale = torch.tensor(math.sqrt(q.shape[-1])).to(q.dtype)
    s = torch.einsum("bhsd,bhtd->bhst", q, kk) / scale
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), vv)


def _batched_gemm_bwd(g, x, w):
    dx = torch.tanh(g @ w.transpose(1, 2)) * 0.5 + x * 0.1
    dw = x.transpose(1, 2) @ g + 0.01 * w
    return dx, dw


# the bench's shapes (its inputs are jax.random; these are numpy)
BATCHED_CHAINS = {
    "ATTN_PREFILL": (_attn_prefill, [((4, 8, 256, 64), 1.0)] * 3),
    "BATCHED_GEMM_BWD": (_batched_gemm_bwd, [
        ((8, 256, 64), 1.0), ((8, 256, 128), 1.0), ((8, 128, 64), 0.1)]),
}


@pytest.mark.parametrize("name", sorted(BATCHED_CHAINS))
def test_batched_must_fuse_chain_plans_as_committed_and_matches_jax(name):
    segs, floor, bwd_floor = _BENCH.MUST_FUSE[name]
    fn, shapes = BATCHED_CHAINS[name]
    rng = np.random.default_rng(7)
    arrays = [(scale * rng.standard_normal(shape)).astype(np.float32)
              for shape, scale in shapes]
    targs = [torch.from_numpy(a) for a in arrays]
    policy = OffloadPolicy(bulk_threshold=4096)
    plan = offload_report(fn, *targs, policy=policy)
    n_bwd = sum(s.matmul is not None and s.matmul.form in ("dlhs", "drhs")
                and s.matmul.flash is None for s in plan.segments)
    assert len(plan.segments) == segs, str(plan.report())
    assert n_bwd >= bwd_floor, str(plan.report())
    assert plan.traffic_reduction >= floor, plan.traffic_reduction
    assert all(s.matmul is not None and s.matmul.batch > 1
               for s in plan.segments)
    got = mpu_offload(fn, policy=policy)(*targs)
    jfn = {n: f for n, f, _, _ in _BENCH._cases()}[name]
    want = jfn(*[jnp.asarray(a) for a in arrays])
    gots = got if isinstance(got, tuple) else (got,)
    for g, w in zip(gots, jax.tree.leaves(want), strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
