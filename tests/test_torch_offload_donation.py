"""Segment-boundary donation in the port's offload compiler, on the CPU,
held against the JAX package's (``repro.core.offload``).

* the reference's four donation tests, ported: a two-segment chain whose
  far ``sort`` output dies at the second segment is donated (the plan's
  ``donated_hbm_bytes`` > 0, ``effective_hbm_bytes`` below the fused
  bytes); ``mpu_offload(adam_like, donate_argnums=(0,))`` on two calls
  with fresh buffers, the donated tensor's storage holding the result;
  an anchored segment's epilogue operand donated; the rhs never donated;
* a donated input pairs with the output returned in its place (the one
  pair that differs from the JAX plan's first match, named there);
* the port's own hazards: an intermediate whose storage a view reads
  later is not donated, a permuted output is aliased only to an operand
  in its layout, an input the caller keeps is never aliased, a call
  autograd records keeps no alias (its gradients those of the undonated
  plan and of ``jax.grad``), plans with and without donation never share
  a store entry, a kernel that would read an operand after writing its
  output (B3's FMA epilogue) is given another pair;
* the plain versions write a donated output into its operand's buffer,
  and refuse a donation the kernel could not honour;
* the verifier: every plan of tiny qwen3 / zamba2 / rwkv6 (the decode
  step, the loss forward and its backward plans, the donating update)
  has no error; a hand-made live-view donation, a layout mismatch and a
  read after the write are each caught;
* the decoder-block chains ``tests/test_torch_offload.py`` holds against
  the JAX planner donate the JAX plan's pairs.

Tolerance: f32 1e-5 (the reference tests'), gradients 1e-4.  Small
sizes, float32; the kernels run as their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_offload import BLOCK_CHAINS, _block_data

from repro.core import OffloadPolicy as JPolicy
from repro.core import mpu_offload as jmpu_offload
from repro.core import offload_report as joffload_report
from repro.core.offload import rewrite_offload as jrewrite_offload
from repro_torch.analysis import has_errors, verify_plan
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import (
    donation_refusal,
    graph_outputs,
    mpu_offload,
    node_val,
    offload_report,
    out_layout,
    storage_roots,
)
from repro_torch.data import SyntheticLM, make_data_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.transformer import Ties
from repro_torch.serve import Engine
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.step import (
    UPDATE_DONATE,
    _unique_opt,
    device_batch,
    update_program,
)

torch.set_num_threads(1)

POLICY = OffloadPolicy(bulk_threshold=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pairs(plan):
    return [pair for seg in plan.segments for pair in seg.donations]


# ---------------------------------------------- the reference's tests
def _two_seg(x, y):
    h = torch.tanh(x) * 2.0 + y
    h2 = torch.sort(h, dim=1).values       # far: a hard segment boundary
    return F.silu(h2) * 0.5 + 1.0


def _jtwo_seg(x, y):
    h = jnp.tanh(x) * 2.0 + y
    h2 = jax.lax.sort(h, dimension=1)
    return jax.nn.silu(h2) * 0.5 + 1.0


def test_two_segment_chain_donates_the_dying_boundary():
    """The sort's output feeds the second segment and dies there: it is
    donated, as in the JAX plan; the plan counts the bytes, and the
    donating run computes what the JAX chain computes."""
    x, y = _rand((64, 32)), _rand((64, 32), 1)
    plan = offload_report(_two_seg, _t(x), _t(y), policy=POLICY)
    _, jplan = jrewrite_offload(jax.make_jaxpr(_jtwo_seg)(x, y),
                                bulk_threshold=64, impl="interpret")
    assert len(plan.segments) == 2
    assert [s.donations for s in plan.segments] == \
        [list(s.donations) for s in jplan.segments] == [[], [(0, 0)]]
    assert plan.donated_hbm_bytes == jplan.donated_hbm_bytes > 0
    assert plan.effective_hbm_bytes < plan.fused_hbm_bytes
    got = mpu_offload(_two_seg, policy=POLICY)(_t(x), _t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jtwo_seg(x, y)),
                               **TOL)
    assert not has_errors(plan.verify())


def _adam_like(p, g):
    m = 0.9 * p + 0.1 * g
    v = 0.95 * p + 0.05 * g * g
    return p - 1e-3 * m / (torch.sqrt(v) + 1e-8)


def _jadam_like(p, g):
    m = 0.9 * p + 0.1 * g
    v = 0.95 * p + 0.05 * g * g
    return p - 1e-3 * m / (jnp.sqrt(v) + 1e-8)


def _positive(shape, seed):
    return np.abs(_rand(shape, seed)) + 0.5


def test_donated_input_not_read_after_write():
    """``donate_argnums=(0,)`` puts the result in the donated buffer; two
    calls with fresh buffers each compute what the JAX function computes
    on the values the buffers held before."""
    fn = mpu_offload(_adam_like, policy=POLICY, donate_argnums=(0,))
    jfn = jmpu_offload(_jadam_like, policy=JPolicy(bulk_threshold=64,
                                                   impl="interpret"),
                       donate_argnums=(0,))
    p, g = _positive((64, 32), 0), _rand((64, 32), 1)
    plan = fn.plan_for(_t(p), _t(g))
    assert plan.donated_hbm_bytes == jfn.plan_for(
        jnp.asarray(p), jnp.asarray(g)).donated_hbm_bytes > 0
    assert plan.donated_inputs == (0,)
    for seed in (0, 3):
        p = _positive((64, 32), seed)
        want = np.asarray(_jadam_like(p, g))
        tp = _t(p)
        got = fn(tp, _t(g))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        assert got.data_ptr() == tp.data_ptr()
        np.testing.assert_array_equal(tp.numpy(), got.numpy())


def test_anchored_segment_epilogue_donation():
    """A residual that the caller donates dies at the anchored segment:
    its buffer takes the epilogue's output, call over call."""
    def fn(x, w, y):
        return F.gelu(x @ w, approximate="tanh") + y

    def jfn(x, w, y):
        return jax.nn.gelu(x @ w) + y

    x, w = _rand((128, 64)), _rand((64, 64), 1) * 0.1
    wrapped = mpu_offload(fn, policy=POLICY, donate_argnums=(2,))
    plan = wrapped.plan_for(_t(x), _t(w), _t(_rand((128, 64), 2)))
    _, jplan = jrewrite_offload(jax.make_jaxpr(jfn)(x, w, _rand((128, 64))),
                                bulk_threshold=64, impl="interpret",
                                donate_argnums=(2,))
    assert len(plan.segments) == 1 and plan.segments[0].matmul is not None
    assert _pairs(plan) == [tuple(d) for d in _pairs(jplan)] == [(0, 0)]
    assert plan.donated_hbm_bytes > 0
    for seed in (2, 5):
        y = _rand((128, 64), seed)
        ty = _t(y)
        got = wrapped(_t(x), _t(w), ty)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(x, w, y)),
                                   **TOL)
        assert got.data_ptr() == ty.data_ptr()


def test_rhs_buffer_never_donated():
    """The anchored rhs read again by the epilogue is never donated."""
    def fn(x, w):
        wq = torch.sort(w, dim=1).values
        return F.gelu(x @ wq, approximate="tanh") + wq

    def jfn(x, w):
        wq = jax.lax.sort(w, dimension=1)
        return jax.nn.gelu(x @ wq) + wq

    x, w = _rand((64, 64)), _rand((64, 64), 1) * 0.1
    plan = offload_report(fn, _t(x), _t(w), policy=POLICY)
    seg = next(s for s in plan.segments if s.matmul is not None)
    donated = {seg.operand_specs[bi].var for bi, _ in seg.donations}
    assert seg.matmul.rhs not in donated
    assert any(sp.var is seg.matmul.rhs for sp in seg.operand_specs)
    got = mpu_offload(fn, policy=POLICY)(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(x, w)), **TOL)


def _swap(p, m, g):
    a = p * 0.5                     # p is read first
    m2 = 0.9 * m + 0.1 * g
    return a - m2, m2               # p's new value, then m's


def _jswap(p, m, g):
    a = p * 0.5
    m2 = 0.9 * m + 0.1 * g
    return a - m2, m2


def test_a_donated_input_pairs_with_the_output_returned_in_its_place():
    """The one pair that differs from the JAX plan's, and why: the JAX
    planner pairs each donated operand with the first output of its
    width (``p`` with ``m2``, made first), where the port pairs a donated
    input with the output the program returns in its place (``p`` with
    ``p``'s new value, ``m`` with ``m2``), so that an optimizer update's
    new values land in their own buffers and no slot holds another's."""
    p, m, g = (_rand((64, 32), k) for k in range(3))
    plan = offload_report(_swap, _t(p), _t(m), _t(g), policy=POLICY,
                          donate_argnums=(0, 1))
    jplan = joffload_report(_jswap, p, m, g, bulk_threshold=64,
                            donate_argnums=(0, 1))
    assert [list(s.donations) for s in jplan.segments] == [[(0, 0), (1, 1)]]
    assert [s.donations for s in plan.segments] == [[(0, 1), (1, 0)]]
    tp, tm = _t(p), _t(m)
    got = mpu_offload(_swap, policy=POLICY, donate_argnums=(0, 1))(
        tp, tm, _t(g))
    assert got[0].data_ptr() == tp.data_ptr()
    assert got[1].data_ptr() == tm.data_ptr()
    for a, w in zip(got, _jswap(p, m, g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


# ------------------------------------------------------ the port's hazards
def _late_view(x, y):
    h = torch.sort(x, dim=1).values
    hv = h.view(-1)                       # a view of h, read after
    out = torch.tanh(h) * 2.0 + y
    return out, torch.cumsum(hv, 0)


def _jlate_view(x, y):
    h = jax.lax.sort(x, dimension=1)
    return jnp.tanh(h) * 2.0 + y, jnp.cumsum(h.reshape(-1))


def _live_view_plan():
    x, y = _rand((64, 32)), _rand((64, 32), 1)
    return x, y, offload_report(_late_view, _t(x), _t(y), policy=POLICY)


def test_a_dying_intermediate_read_later_through_a_view_is_not_donated():
    """``h`` has no reader after the segment, but its view does: by node
    liveness (the reference's rule) it would be donated, by storage it
    is not."""
    x, y, plan = _live_view_plan()
    seg = next(s for s in plan.segments if s.matmul is None)
    roots = storage_roots(plan.annotation.graph)
    h = next(sp.var for sp in seg.operand_specs
             if roots[sp.var].name.startswith("getitem"))
    late = [u for u in h.users if plan.eqns.index(u) > seg.span_end]
    assert not late                        # the reference's rule: dead
    assert seg.donations == []
    got = mpu_offload(_late_view, policy=POLICY)(_t(x), _t(y))
    for g, w in zip(got, _jlate_view(x, y)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


B, S, H, D = 2, 8, 4, 16


def _permuted(x, c):
    a = torch.sort(x, dim=-1).values.permute(0, 2, 1, 3)
    cc = torch.sort(c, dim=-1).values          # row-major, dies here
    return torch.tanh(a) * 2.0 + cc, a


def _jpermuted(x, c):
    a = jnp.transpose(jnp.sort(x, axis=-1), (0, 2, 1, 3))
    return jnp.tanh(a) * 2.0 + jnp.sort(c, axis=-1), a


def _permuted_own(x):
    a = torch.sort(x, dim=-1).values.permute(0, 2, 1, 3)
    return torch.tanh(a) * 2.0 + 1.0


def test_a_permuted_output_is_aliased_only_in_its_layout():
    """The elementwise output follows its permuted operand's layout: a
    row-major operand that dies there cannot hold it (dropped, with the
    reason), a permuted one in the same layout can; both compute what
    JAX computes."""
    x, c = _rand((B, S, H, D)), _rand((B, H, S, D), 1)
    plan = offload_report(_permuted, _t(x), _t(c), policy=POLICY)
    seg = plan.segments[0]
    assert out_layout(node_val(seg.outputs[0])) is not None
    assert seg.donations == []
    assert [why for _, _, why in seg.dropped] == \
        ["the operand is not in the output's permuted layout"]
    got = mpu_offload(_permuted, policy=POLICY)(_t(x), _t(c))
    for g, w in zip(got, _jpermuted(x, c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    own = offload_report(_permuted_own, _t(x), policy=POLICY)
    assert _pairs(own) == [(0, 0)]
    out = mpu_offload(_permuted_own, policy=POLICY)(_t(x))
    assert out.stride() == (512, 16, 64, 1)
    np.testing.assert_allclose(
        out.numpy(), np.tanh(np.transpose(np.sort(x, -1), (0, 2, 1, 3)))
        * 2.0 + 1.0, **TOL)


def test_an_undonated_input_is_never_aliased():
    """Without ``donate_argnums`` the inputs keep their values; a
    hand-made donation of one is an ``alias-live`` error."""
    p, g = _positive((64, 32), 0), _rand((64, 32), 1)
    plan = offload_report(_adam_like, _t(p), _t(g), policy=POLICY)
    assert plan.donated_inputs == () and _pairs(plan) == []
    tp = _t(p)
    mpu_offload(_adam_like, policy=POLICY)(tp, _t(g))
    np.testing.assert_array_equal(tp.numpy(), p)
    plan.segments[0].donations = [(0, 0)]
    rules = {f.rule for f in verify_plan(plan) if f.severity == "error"}
    assert "alias-live" in rules


def _grad_chain(p, g):
    h = torch.sort(p * g, dim=1).values
    return (torch.tanh(h) * 2.0 + p).sum()


def _jgrad_chain(p, g):
    h = jnp.sort(p * g, axis=1)
    return (jnp.tanh(h) * 2.0 + p).sum()


def test_a_recorded_call_keeps_no_alias(monkeypatch):
    """Under autograd no segment donates (its far ops save their inputs
    for the backward); the gradients are those of the undonated plan and
    of ``jax.grad``.  Under ``no_grad`` the same wrapper donates."""
    seen = []
    real = ops.fused_segment_grid

    def spy(*a, donate=(), **kw):
        seen.append(tuple(donate))
        return real(*a, donate=donate, **kw)

    monkeypatch.setattr(ops, "fused_segment_grid", spy)
    p, g = _rand((64, 32)), _rand((64, 32), 1)
    grads = []
    for donate in ((0,), ()):
        fn = mpu_offload(_grad_chain, policy=POLICY, donate_argnums=donate)
        tp = _t(p).requires_grad_()
        tg = _t(g).requires_grad_()
        seen.clear()
        out = fn(tp, tg)
        assert seen and all(d == () for d in seen)
        # the backward plans' own runners donate their intermediates
        grads.append(torch.autograd.grad(out, (tp, tg)))
    want = jax.grad(_jgrad_chain, argnums=(0, 1))(p, g)
    for got in grads:
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    seen.clear()
    with torch.no_grad():
        mpu_offload(_grad_chain, policy=POLICY, donate_argnums=(0,))(
            _t(p), _t(g))
    assert any(seen)


def test_plans_with_and_without_donation_never_share_a_store_entry(tmp_path):
    p, g = _t(_positive((64, 32), 0)), _t(_rand((64, 32), 1))
    plain = mpu_offload(_adam_like, policy=POLICY, persist_dir=tmp_path)
    plain.warm(p, g)
    donating = mpu_offload(_adam_like, policy=POLICY, persist_dir=tmp_path,
                           donate_argnums=(0,))
    donating.warm(p, g)
    assert donating.stats.disk_hits == 0
    assert donating.stats.disk_misses == donating.stats.plan_misses == 1
    assert len(list(tmp_path.glob("*.ok"))) == 2
    for donate, pairs in (((), []), ((0,), [(0, 0)])):
        fresh = mpu_offload(_adam_like, policy=POLICY, persist_dir=tmp_path,
                            donate_argnums=donate)
        plan = fresh.warm(p, g)
        assert fresh.stats.disk_hits == 1 and fresh.stats.plan_misses == 0
        assert _pairs(plan) == pairs


def _two_outputs(x, w, y):
    r = torch.sort(y, dim=1).values
    h = x @ w
    return torch.tanh(h) + r, h * r


def test_a_read_after_the_write_is_given_another_pair():
    """B3's FMA epilogue writes its first output, then reads the operand
    again for the second: the reference's first match (operand to output
    0) is refused with the reason, and the operand takes output 1, whose
    write follows every read; both compute what eager PyTorch does."""
    x, w, y = (_t(_rand(s, k)) for k, s in enumerate(
        ((128, 64), (64, 64), (128, 64))))
    plan = offload_report(_two_outputs, x, w, y, policy=POLICY)
    seg = next(s for s in plan.segments if s.matmul is not None)
    bi = next(i for i, sp in enumerate(seg.operand_specs)
              if sp.role == "bulk")
    assert "reads the operand after" in donation_refusal(plan.eqns, seg,
                                                         bi, 0)
    assert seg.donations == [(bi, 1)]
    got = mpu_offload(_two_outputs, policy=POLICY)(x, w, y)
    for g, want in zip(got, _two_outputs(x, w, y)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), **TOL)


# ------------------------------------------------------ the plain versions
def test_plain_versions_write_donated_outputs_in_place():
    """``ops.fused_segment_grid`` and ``fused_matmul_segment`` on CPU
    tensors: a donated output comes back in its operand's buffer, equal to
    the fresh output; an operand that cannot hold it raises first."""
    x, y = _rand((64, 32)), _rand((64, 32), 1)
    plan = offload_report(_two_seg, _t(x), _t(y), policy=POLICY)
    eqns = plan.eqns
    from repro_torch.core.offload import segment_call

    call = segment_call(eqns, plan.segments[1])
    h = _t(np.sort(x, axis=1))
    kw = dict(rows=call["rows"], out_cols=call["out_cols"],
              out_dtypes=call["out_dtypes"])
    fresh = ops.fused_segment_grid(call["progs"].body, [h.clone()],
                                   call["specs"], **kw)
    got = ops.fused_segment_grid(call["progs"].body, [h], call["specs"],
                                 donate=((0, 0),), **kw)
    assert got[0].data_ptr() == h.data_ptr()
    np.testing.assert_array_equal(got[0].numpy(), fresh[0].numpy())
    with pytest.raises(ValueError, match="layout"):
        ops.fused_segment_grid(call["progs"].body, [h.t().contiguous().t()],
                               call["specs"], donate=((0, 0),), **kw)

    def fn(x, w, y):
        return F.gelu(x @ w, approximate="tanh") + y

    args = [_t(_rand((128, 64))), _t(_rand((64, 64), 1)),
            _t(_rand((128, 64), 2))]
    mplan = offload_report(fn, *args, policy=POLICY, donate_argnums=(2,))
    mc = segment_call(mplan.eqns, mplan.segments[0])
    nl, nr = mc["n_lhs"], mc["n_rhs"]
    vals = [args[0], args[1], args[2]]
    sp = mc["specs"]
    mkw = dict(rows=mc["rows"], k_dim=mc["k"], n_dim=mc["n"],
               acc_dtype=mc["acc_dtype"], out_cols=mc["out_cols"],
               out_dtypes=mc["out_dtypes"], vmem_bytes=mc["vmem_bytes"],
               sms=mc["sms"])
    progs = mc["progs"]
    fresh = ops.fused_matmul_segment(
        progs.lhs, progs.rhs, progs.body, vals[:nl], sp[:nl],
        vals[nl:nl + nr], sp[nl:nl + nr], [vals[2].clone()], sp[nl + nr:],
        **mkw)
    got = ops.fused_matmul_segment(
        progs.lhs, progs.rhs, progs.body, vals[:nl], sp[:nl],
        vals[nl:nl + nr], sp[nl:nl + nr], [vals[2]], sp[nl + nr:],
        donate=((0, 0),), **mkw)
    assert got[0].data_ptr() == vals[2].data_ptr()
    np.testing.assert_array_equal(got[0].numpy(), fresh[0].numpy())


# ----------------------------------------------------------- the verifier
def test_hand_made_live_view_and_layout_donations_are_caught():
    """The port-only extensions of the reference's alias rules:
    ``alias-live`` follows a donated operand to its storage (a view read
    after the segment), ``alias-shape`` compares layouts."""
    _, _, plan = _live_view_plan()
    seg = next(s for s in plan.segments if s.matmul is None)
    roots = storage_roots(plan.annotation.graph)
    bi = next(i for i, sp in enumerate(seg.operand_specs)
              if roots[sp.var].name.startswith("getitem"))
    seg.donations = [(bi, 0)]
    assert "alias-live" in {f.rule for f in verify_plan(plan)
                            if f.severity == "error"}

    x, c = _rand((B, S, H, D)), _rand((B, H, S, D), 1)
    plan = offload_report(_permuted, _t(x), _t(c), policy=POLICY)
    seg = plan.segments[0]
    seg.donations = [tuple(seg.dropped[0][:2])]
    errors = [f for f in verify_plan(plan) if f.severity == "error"]
    assert [f.rule for f in errors] == ["alias-shape"]
    assert "permuted layout" in errors[0].detail


def test_hand_made_read_after_write_donation_is_caught():
    x, w, y = (_t(_rand(s, k)) for k, s in enumerate(
        ((128, 64), (64, 64), (128, 64))))
    plan = offload_report(_two_outputs, x, w, y, policy=POLICY)
    seg = next(s for s in plan.segments if s.matmul is not None)
    seg.donations = [(seg.donations[0][0], 0)]
    assert {f.rule for f in verify_plan(plan)
            if f.severity == "error"} == {"alias-order"}


ZOO = {"qwen3": ("qwen3-1.7b", 2), "zamba2": ("zamba2-1.2b", 12),
       "rwkv6": ("rwkv6-1.6b", 2)}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_every_tiny_plan_verifies(name):
    """The decode step's plan, the loss forward's, every backward plan of
    its segments and the update with the parameters and moments donated:
    no verifier error; the update donates every leaf its segments
    update."""
    arch, layers = ZOO[name]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              num_layers=layers)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0)
    eng = Engine(cfg, state.params, device="cpu", slots=2, max_len=32,
                 page_size=8, offload_policy=OffloadPolicy(bulk_threshold=32))
    plans = [eng.decode_plan()]
    tcfg = TrainConfig(offload=True)
    step = make_train_step(model, tcfg)
    batch = device_batch(SyntheticLM(make_data_config(cfg, ShapeConfig(
        "s", 16, 2, "train"))).batch(0), "cpu")
    plans.append(step.loss_fn.warm(state.params, batch))
    plans += step.loss_fn.warm_backward(state.params, batch)
    ties = Ties(state.params)
    unique = ties.unique(state.params)
    update = mpu_offload(update_program(tcfg),
                         policy=tcfg.resolved_offload_policy(),
                         donate_argnums=UPDATE_DONATE)
    uplan = update.warm(unique, unique, _unique_opt(ties, state.opt))
    plans.append(uplan)
    for plan in plans:
        assert not has_errors(verify_plan(plan)), name
    donated, made = _state_outputs(uplan, len(unique))
    assert donated == made and made


def _state_outputs(plan, n_params: int) -> tuple[set, set]:
    """The positions of the update's outputs that take the state's place
    (the parameters, the step, the moments: every output before the grad
    norm and the learning rate) whose value a donating segment writes in
    its input's buffer, and those any segment makes."""
    graph = plan.annotation.graph
    outs = graph_outputs(graph)[:-2]
    roots = storage_roots(graph)
    phs = [n for n in graph.nodes if n.op == "placeholder"]
    # the update's inputs: parameters, gradients, step, moments
    slot_in = phs[:n_params] + phs[2 * n_params:]
    donated, made = set(), set()
    for seg in plan.segments:
        for oi, v in enumerate(seg.outputs):
            for j, o in enumerate(outs):
                if roots[o] is v:
                    made.add(j)
                    if any(oi == o2 and roots[seg.operand_specs[bi].var]
                           is slot_in[j] for bi, o2 in seg.donations):
                        donated.add(j)
    return donated, made


# ------------------------------------------- the decoder-block chains
@pytest.mark.parametrize("name", sorted(BLOCK_CHAINS))
def test_decoder_block_donations_match_jax(name):
    """The chains of ``tests/test_torch_offload.py``: each segment donates
    the JAX plan's pairs (the same operand and output roles and widths);
    no pair differs."""
    jfn, tfn, names = BLOCK_CHAINS[name]
    data = _block_data()
    jplan = joffload_report(jfn, *[jnp.asarray(data[n]) for n in names],
                            bulk_threshold=64)
    tplan = offload_report(tfn, *[torch.from_numpy(data[n]) for n in names],
                           policy=POLICY)

    def described(plan):
        return [[(s.operand_specs[bi].role, s.operand_specs[bi].cols,
                  s.out_cols[oi]) for bi, oi in s.donations]
                for s in plan.segments]
    assert described(tplan) == described(jplan)
    assert [list(s.donations) for s in tplan.segments] == \
        [[tuple(d) for d in s.donations] for s in jplan.segments]
    assert any(s.donations for s in tplan.segments)
