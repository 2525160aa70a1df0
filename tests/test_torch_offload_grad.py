"""Gradients through the port's offload compiler on the CPU, held against
the JAX package (the cases of ``tests/test_offload_grad.py``):

* differentiating ``mpu_offload(f)`` equals ``jax.grad`` of the JAX
  function and ``torch.autograd`` of the unwrapped one — each fused
  segment's backward re-plans its cotangent program through the same
  planner;
* backward plans live in per-segment "bwd"-tagged caches, apart from
  the forward plan cache; a second backward hits them;
* the recomputed forward of a backward plan anchors again, and its
  cotangent contractions anchor the dlhs and drhs forms;
* the backward ``MUST_FUSE`` chains of ``benchmarks/offload_bench.py``
  (GEMM_BWD, MLP_GRAD, TRAIN_STEP) plan their committed segment counts,
  anchored-backward floors and traffic floors, and compute what the JAX
  chains compute.

The kernels run as their plain versions here (CPU tensors).
Tolerances: as the reference's — f32 1e-4, bf16 5e-2 relative / 2e-1
absolute (gradients of O(10) round to 0.1 steps in bf16).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import OffloadPolicy, mpu_offload
from repro_torch.core.offload import (
    bwd_plan_stats,
    bwd_plans,
    clear_bwd_plans,
    offload_report,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POLICY = OffloadPolicy(bulk_threshold=64)
_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return dict(rtol=5e-2, atol=2e-1) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _data(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for shape, scale in shapes]


def _check_grads(tfn, jfn, arrays, dtype):
    """d/d(every input) of sum(fn): the offloaded port, the unwrapped
    port and the JAX function agree."""
    targs = [torch.from_numpy(a).to(_TD[dtype]).requires_grad_()
             for a in arrays]
    got = torch.autograd.grad(mpu_offload(tfn, policy=POLICY)(*targs), targs)
    eager = torch.autograd.grad(tfn(*targs), targs)
    jargs = [jnp.asarray(a).astype(_JD[dtype]) for a in arrays]
    want = jax.grad(jfn, argnums=tuple(range(len(arrays))))(*jargs)
    for g, e, w in zip(got, eager, want, strict=True):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **_tol(dtype))
        np.testing.assert_allclose(g.float().numpy(), e.float().numpy(),
                                   **_tol(dtype))


def _gelu(v):
    return F.gelu(v, approximate="tanh")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_through_offload_gemm_gelu(dtype):
    def tfn(x, w, b, y):
        return torch.sum(_gelu(x @ w + b) + y)

    def jfn(x, w, b, y):
        return jnp.sum(jax.nn.gelu(x @ w + b) + y)

    arrays = _data([((128, 64), 1.0), ((64, 48), 0.1), ((48,), 1.0),
                    ((128, 48), 1.0)])
    _check_grads(tfn, jfn, arrays, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_through_offload_swiglu(dtype):
    def tfn(x, wgu):
        hw = x @ wgu
        return torch.sum(F.silu(hw[:, :48]) * hw[:, 48:])

    def jfn(x, wgu):
        hw = x @ wgu
        return jnp.sum(jax.nn.silu(hw[:, :48]) * hw[:, 48:])

    arrays = _data([((256, 32), 1.0), ((32, 96), 0.1)], seed=1)
    _check_grads(tfn, jfn, arrays, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_through_offload_rmsnorm(dtype):
    def tfn(x, s):
        xf = x.float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        return torch.sum(xf * torch.rsqrt(ms + 1e-5) * s)

    def jfn(x, s):
        xf = x.astype(jnp.float32)
        ms = jnp.mean(xf * xf, axis=-1, keepdims=True)
        return jnp.sum(xf * jax.lax.rsqrt(ms + 1e-5) * s)

    x, = _data([((8, 32, 64), 1.0)], seed=2)
    s = np.full((64,), 1.1, np.float32)
    targs = [torch.from_numpy(x).to(_TD[dtype]).requires_grad_(),
             torch.from_numpy(s).requires_grad_()]
    got = torch.autograd.grad(mpu_offload(tfn, policy=POLICY)(*targs), targs)
    want = jax.grad(jfn, argnums=(0, 1))(
        jnp.asarray(x).astype(_JD[dtype]), jnp.asarray(s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **_tol(dtype))


def test_value_and_grad_has_aux_over_a_pytree():
    """The train-step shape: loss and aux over a parameter dict, through
    the offloaded (un-differentiated) loss."""
    def tloss(params, batch):
        h = _gelu(batch @ params["w1"] + params["b1"])
        o = h @ params["w2"]
        loss = torch.mean(o * o)
        return loss, {"loss": loss}

    def jloss(params, batch):
        h = jax.nn.gelu(batch @ params["w1"] + params["b1"])
        o = h @ params["w2"]
        loss = jnp.mean(o * o)
        return loss, {"loss": loss}

    w1, b1, w2, batch = _data([((64, 48), 0.1), ((48,), 1.0),
                               ((48, 32), 0.1), ((128, 64), 1.0)], seed=3)
    np_params = {"w1": w1, "b1": b1, "w2": w2}
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in np_params.items()}
    (loss, aux) = mpu_offload(tloss, policy=POLICY)(params,
                                                    torch.from_numpy(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    (lw, _), want = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(batch))
    np.testing.assert_allclose(float(loss.detach()), float(lw), rtol=1e-5,
                               atol=1e-5)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)
    assert np.isfinite(float(aux["loss"].detach()))


def test_fwd_and_bwd_plan_caches_do_not_collide():
    """A backward hits the forward plan of its call (same signature),
    plans its segments' backwards separately, and leaves the forward
    cache as it was; a second backward hits the backward caches."""
    def fn(x, w, b):
        return torch.sum(_gelu(x @ w + b))

    x, w, b = (torch.from_numpy(a) for a in _data(
        [((128, 64), 1.0), ((64, 48), 0.1), ((48,), 1.0)], seed=4))
    clear_bwd_plans()
    wrapped = mpu_offload(fn, policy=POLICY)
    primal = wrapped(x, w, b)
    assert wrapped.cache_size() == 1 and wrapped.stats.plan_misses == 1
    assert bwd_plan_stats().plan_misses == 0

    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.autograd.grad(wrapped(xg, wg, b), (xg, wg))
    assert wrapped.cache_size() == 1 and wrapped.stats.plan_misses == 1
    assert wrapped.stats.plan_hits >= 1
    misses = bwd_plan_stats().plan_misses
    assert misses >= 1

    hits = bwd_plan_stats().plan_hits
    torch.autograd.grad(wrapped(xg, wg, b), (xg, wg))
    assert bwd_plan_stats().plan_misses == misses
    assert bwd_plan_stats().plan_hits > hits
    torch.testing.assert_close(wrapped(x, w, b), primal, rtol=1e-6,
                               atol=1e-6)


def test_bwd_plans_are_replanned_through_the_planner():
    """The cotangent program is planned: its recomputed forward anchors
    as the forward did, and both gradient contractions are dlhs / drhs
    candidates (bf16, where each rounds its f32 product, they fuse)."""
    def fn(x, w, b):
        return torch.sum(_gelu(x @ w + b))

    for dtype, fused_bwd in ((torch.float32, set()),
                             (torch.bfloat16, {"dlhs", "drhs"})):
        x, w, b = (torch.from_numpy(a).to(dtype).requires_grad_()
                   for a in _data([((128, 64), 1.0), ((64, 48), 0.1),
                                   ((48,), 1.0)], seed=5))
        clear_bwd_plans()
        torch.autograd.grad(mpu_offload(fn, policy=POLICY)(x, w, b), (x, w))
        plans = bwd_plans()
        assert len(plans) == 1
        forms = {d.form: d.fused for d in plans[0].decisions
                 if d.tier == "anchor"}
        assert forms.get("fwd") is True
        assert {"dlhs", "drhs"} <= set(forms)
        assert {f for f, fused in forms.items()
                if fused and f != "fwd"} == fused_bwd


# ------------------------------------------------ backward MUST_FUSE chains
def _bench():
    spec = importlib.util.spec_from_file_location(
        "offload_bench", ROOT / "benchmarks" / "offload_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BENCH = _bench()
BENCH_POLICY = OffloadPolicy(bulk_threshold=4096)


def _gemm_bwd(g, x, w):
    dx = torch.tanh(g @ w.t()) * 0.5 + x * 0.1
    dw = x.t() @ g + 0.01 * w
    return dx, dw


def _mlp_grad(x, w1, b1, w2, y):
    def loss(w1, b1, w2, x):
        o = _gelu(x @ w1 + b1) @ w2 + y
        return torch.sum(o * o)
    return torch.func.grad(loss, argnums=(0, 1, 2))(w1, b1, w2, x)


def _train_step(x, w1, b1, w2, m1, m2):
    def loss(w1, b1, w2):
        return torch.sum((_gelu(x @ w1 + b1) @ w2) ** 2)
    g1, gb, g2 = torch.func.grad(loss, argnums=(0, 1, 2))(w1, b1, w2)
    m1n = 0.9 * m1 + g1
    w1n = w1 - 1e-3 * m1n - 1e-4 * w1
    m2n = 0.9 * m2 + g2
    w2n = w2 - 1e-3 * m2n - 1e-4 * w2
    b1n = b1 - 1e-3 * gb
    return w1n, w2n, b1n, m1n, m2n


# the bench's shapes (its inputs are jax.random; these are numpy)
BWD_CHAINS = {
    "GEMM_BWD": (_gemm_bwd, [((4096, 256), 1.0), ((4096, 256), 1.0),
                             ((256, 256), 0.05)]),
    "MLP_GRAD": (_mlp_grad, [((2048, 256), 1.0), ((256, 512), 0.05),
                             ((512,), 1.0), ((512, 256), 0.05),
                             ((2048, 256), 1.0)]),
    "TRAIN_STEP": (_train_step, [((2048, 256), 1.0), ((256, 512), 0.05),
                                 ((512,), 1.0), ((512, 256), 0.05),
                                 ((256, 512), 0.0), ((512, 256), 0.0)]),
}


def test_backward_chains_are_the_three_with_a_backward_floor():
    assert sorted(n for n, (_, _, bwd) in _BENCH.MUST_FUSE.items()
                  if bwd and not n.startswith("BATCHED")) == \
        sorted(BWD_CHAINS)


@pytest.mark.parametrize("name", sorted(BWD_CHAINS))
def test_backward_must_fuse_chain_plans_as_committed_and_matches_jax(name):
    segs, floor, bwd_floor = _BENCH.MUST_FUSE[name]
    fn, shapes = BWD_CHAINS[name]
    arrays = _data(shapes, seed=6)
    targs = [torch.from_numpy(a) for a in arrays]
    plan = offload_report(fn, *targs, policy=BENCH_POLICY)
    n_bwd = sum(s.matmul is not None and s.matmul.form in ("dlhs", "drhs")
                for s in plan.segments)
    assert len(plan.segments) == segs, str(plan.report())
    assert n_bwd >= bwd_floor, str(plan.report())
    assert plan.traffic_reduction >= floor, plan.traffic_reduction
    got = mpu_offload(fn, policy=BENCH_POLICY)(*targs)
    jfn = {n: f for n, f, _, _ in _BENCH._cases()}[name]
    want = jfn(*[jnp.asarray(a) for a in arrays])
    for g, w, e in zip(got, jax.tree.leaves(want), fn(*targs), strict=True):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale)
