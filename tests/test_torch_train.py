"""The port's training slice on the CPU, held against the JAX package:
the data pipeline, the schedule and AdamW, the loss and its gradients,
remat, gradient accumulation, the offloaded train step, ``train()`` and
the training launcher.  Same inputs (numpy, from a seed) and the same
weights (converted) go through both sides; ``tiny`` configs, f32.

Tolerances: loss and gradients 1e-4 (the reference's bound for a
2-layer model in f32: sums reassociate); one optimizer step 2e-3 on the
parameters (the reference's offloaded-step bound); the optimizer alone
1e-5 relative (the same f32 ops, ``pow`` of the bias correction may
differ in the last bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from conftest import tiny

from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_data_config as jmake_data_config
from repro.models import build_model as jbuild_model
from repro.optim import apply_updates as japply_updates
from repro.optim import clip_by_global_norm as jclip
from repro.optim import init_state as jinit_state
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import bwd_plans, capture, clear_bwd_plans
from repro_torch.data import SyntheticLM, make_data_config
from repro_torch.models import build_model
from repro_torch.optim import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    init_state,
    warmup_cosine,
)
from repro_torch.train import (
    init_train_state,
    make_eval_step,
    make_train_step,
    train,
)
from repro_torch.train.step import device_batch

torch.set_num_threads(2)

SHAPE = (32, 4)        # seq_len, global batch: tests/test_offload_grad.py's


def _tcfg(**over):
    return dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               dtype="float32", num_layers=2, **over)


@pytest.fixture(scope="module")
def pair():
    """The same 2-layer f32 model on both sides, one batch, one step of
    the JAX plain train step."""
    jcfg = tiny("qwen3-1.7b", num_layers=2)
    jmodel = jbuild_model(jcfg)
    jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0))
    batch = JSyntheticLM(jmake_data_config(
        jcfg, JShapeConfig("s", *SHAPE, "train"))).batch(0)
    jstep = jmake_train_step(jmodel, JTrainConfig(microbatches=1,
                                                  remat=False), offload=False)
    jnext, jmetrics = jstep(jstate, batch)
    tcfg = _tcfg()
    tmodel = build_model(tcfg, device="cpu")
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), tcfg,
                                 device="cpu")
    return dict(jmodel=jmodel, jstate=jstate, batch=batch, jnext=jnext,
                jmetrics=jmetrics, tcfg=tcfg, tmodel=tmodel, state=state)


def _leaves_close(got, want, **tol):
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), **tol)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seq,batch,seed,step", [(32, 4, 0, 0),
                                                 (64, 8, 3, 5)])
def test_synthetic_lm_batches_are_byte_equal_to_the_jax_pipeline(
        seq, batch, seed, step):
    jcfg = tiny("qwen3-1.7b")
    tcfg = reduced(get_config("qwen3-1.7b"))
    want = JSyntheticLM(jmake_data_config(
        jcfg, JShapeConfig("s", seq, batch), seed)).batch(step, host_id=1,
                                                          num_hosts=2)
    got = SyntheticLM(make_data_config(
        tcfg, ShapeConfig("s", seq, batch), seed)).batch(step, host_id=1,
                                                         num_hosts=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k


# ------------------------------------------------------------ optimizer
def test_warmup_cosine_matches_jax():
    for over in ({}, dict(warmup_steps=3, total_steps=20)):
        tc, jc = TrainConfig(**over), JTrainConfig(**over)
        for step in (0, 1, 2, 50, 100, 101, 550, 999, 1000, 5000):
            got = warmup_cosine(tc, torch.tensor(step, dtype=torch.int32))
            want = jwarmup_cosine(jc, jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_updates_and_clipping_match_jax(use_kernel):
    rng = np.random.default_rng(1)
    shapes = {"w": (24, 40), "s": (40,), "e": (3, 5, 8)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (10 * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: rng.random(s).astype(np.float32) for k, s in shapes.items()}
    cfg = TrainConfig(grad_clip=1.0)
    jcfg = JTrainConfig(grad_clip=1.0)
    tt = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}  # noqa
    jj = lambda d: {k: jnp.asarray(x) for k, x in d.items()}      # noqa

    def close(got, want, **tol):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.array(want[k], np.float32), **tol)

    tg, tnorm = clip_by_global_norm(tt(g), cfg.grad_clip)
    jg, jnorm = jclip(jj(g), jcfg.grad_clip)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    close(tg, jg, rtol=1e-6, atol=1e-7)

    tstate = AdamWState(torch.tensor(4, dtype=torch.int32), tt(m), tt(v))
    jstate = jinit_state(jj(p))._replace(step=jnp.asarray(4, jnp.int32),
                                         m=jj(m), v=jj(v))
    lr = 3e-4
    tp, ts = apply_updates(tt(p), tg, tstate, cfg, torch.tensor(lr),
                           use_kernel=use_kernel)
    jp, js = japply_updates(jj(p), jg, jstate, jcfg, jnp.float32(lr),
                            use_kernel=use_kernel)
    assert int(ts.step) == int(js.step) == 5
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        close(got, want, rtol=1e-5, atol=1e-7)
    fresh = init_state(tt(p))
    assert int(fresh.step) == 0 and all(
        float(t.abs().max()) == 0 for t in pytree.tree_leaves(fresh.m))


# ------------------------------------------------------- loss and grads
def test_loss_and_gradients_match_jax(pair):
    jparams = pair["jstate"].params
    batch = pair["batch"]
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: pair["jmodel"].loss_fn(p, batch, remat=False),
        has_aux=True)(jparams)
    params = pair["state"].params
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss, metrics = pair["tmodel"].loss_fn(
        pytree.tree_unflatten(leaves, spec), device_batch(batch, "cpu"),
        remat=False)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    assert float(metrics["tokens"]) == batch["tokens"].size
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), pair["tcfg"],
                           device="cpu", dtype=torch.float32)
    _leaves_close(list(grads), pytree.tree_leaves(want), rtol=1e-4,
                  atol=1e-4)


def test_remat_equals_no_remat_and_keeps_each_block_one_far_node(pair):
    tmodel, params = pair["tmodel"], pair["state"].params
    batch = device_batch(pair["batch"], "cpu")

    def loss_and_grads(remat):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, _ = tmodel.loss_fn(pytree.tree_unflatten(leaves, spec), batch,
                                 remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    l0, g0 = loss_and_grads(False)
    l1, g1 = loss_and_grads(True)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    gm, _, _ = capture(lambda p, b: tmodel.loss_fn(p, b, remat=True),
                       (params, batch))
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    blocks = [n for n in calls if "remat_block" in str(n.target)]
    assert len(blocks) == pair["tcfg"].num_layers
    # only the LM head's product is left outside the blocks
    assert sum("aten.mm" in str(n.target) for n in calls) == 1
    wrapped = make_train_step(tmodel, TrainConfig(remat=True),
                              offload=True).loss_fn
    plan = wrapped.plan_for(params, batch)
    inside = {i for i, n in enumerate(plan.eqns)
              if "remat_block" in str(n.target)}
    assert len(inside) == pair["tcfg"].num_layers
    assert not any(inside & set(s.all_eqn_idx) for s in plan.segments)


def test_microbatches_equal_the_full_batch(pair):
    tmodel, state = pair["tmodel"], pair["state"]
    full = make_train_step(tmodel, TrainConfig(microbatches=1, remat=False))
    micro = make_train_step(tmodel, TrainConfig(microbatches=2, remat=False))
    s1, m1 = full(state, pair["batch"])
    s2, m2 = micro(state, pair["batch"])
    _leaves_close(s2.params, s1.params, rtol=5e-3, atol=5e-5)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-4)


# ------------------------------------------------------- the train step
def test_plain_train_step_matches_the_jax_step(pair):
    state, m = make_train_step(pair["tmodel"], TrainConfig(
        microbatches=1, remat=False))(pair["state"], pair["batch"])
    want = from_jax_train_state(jax.tree.map(np.asarray, pair["jnext"]),
                                pair["tcfg"], device="cpu")
    np.testing.assert_allclose(float(m["loss"]),
                               float(pair["jmetrics"]["loss"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(pair["jmetrics"]["grad_norm"]),
                               rtol=1e-4)
    _leaves_close(state.params, want.params, rtol=2e-3, atol=2e-3)
    _leaves_close(state.opt.m, want.opt.m, rtol=1e-3, atol=1e-5)
    assert int(state.opt.step) == 1


def test_offloaded_train_step_matches_the_jax_plain_step(pair):
    """As tests/test_offload_grad.py:212 holds the JAX package's
    offloaded step to its plain one; the backward plans hold both
    gradient contraction forms."""
    clear_bwd_plans()
    step = make_train_step(pair["tmodel"], TrainConfig(microbatches=1,
                                                       remat=False),
                           offload=True)
    state, m = step(pair["state"], pair["batch"])
    want = from_jax_train_state(jax.tree.map(np.asarray, pair["jnext"]),
                                pair["tcfg"], device="cpu")
    np.testing.assert_allclose(float(m["loss"]),
                               float(pair["jmetrics"]["loss"]), rtol=1e-4,
                               atol=1e-4)
    _leaves_close(state.params, want.params, rtol=2e-3, atol=2e-3)
    forms = {d.form for p in bwd_plans() for d in p.decisions}
    assert {"fwd", "dlhs", "drhs"} <= forms
    assert step.stats.plan_misses == 1 and step.update_stats.plan_misses == 1
    assert step.explain_loss(pair["state"].params, device_batch(
        pair["batch"], "cpu")).n_fused > 0
    assert step.explain_update(pair["state"].params, pair["state"].params,
                               pair["state"].opt).n_fused > 0
    # the input state is left as it was (the step is functional)
    torch.testing.assert_close(pair["state"].params["layers"][0]["ffn"]["up"],
                               torch.from_numpy(np.array(
                                   pair["jstate"].params["decoder"]["stack"]
                                   ["0"]["ffn"]["up"][0])))


def test_model_attention_bmm_stays_declined_and_the_plan_is_unchanged(pair):
    """The model attention's einsums reach ``bmm`` through a permute and a
    copy (their batch axes are not leading, as in the reference's
    jaxpr): with batched anchors planned, the 2-layer loss still declines
    its 4 attention ``bmm`` with that reason, and every other count of
    the plan is as before (18 grid + 7 fwd fused; 12 grid + 8 fwd
    declined)."""
    step = make_train_step(pair["tmodel"], TrainConfig(remat=False),
                           offload=True)
    plan = step.loss_fn.plan_for(pair["state"].params,
                                 device_batch(pair["batch"], "cpu"))
    counts = {}
    for d in plan.decisions:
        key = (d.fused, d.form or "grid")
        counts[key] = counts.get(key, 0) + 1
    assert counts == {(True, "grid"): 18, (True, "fwd"): 7,
                      (False, "grid"): 12, (False, "fwd"): 8,
                      (False, "bmm"): 4}, counts
    bmm = [d for d in plan.decisions if d.form == "bmm"]
    assert all("batch axes not leading" in d.reason for d in bmm)
    assert all(s.matmul is None or s.matmul.batch == 1
               for s in plan.segments)


def test_bf16_offloaded_step_fuses_both_gradient_forms():
    """With f32 masters and bf16 compute the backward plans anchor every
    gradient contraction — dlhs and drhs round their f32 products to
    bf16, and the weight cotangents carry the f32 cast of the cast
    weight — and the step agrees with the port's plain bf16 step."""
    cfg = dataclasses.replace(_tcfg(), dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0)
    batch = SyntheticLM(make_data_config(cfg, ShapeConfig(
        "s", *SHAPE))).batch(0)
    clear_bwd_plans()
    _, m_off = make_train_step(model, TrainConfig(remat=False),
                               offload=True)(state, batch)
    _, m_plain = make_train_step(model, TrainConfig(remat=False))(state,
                                                                  batch)
    fused = {d.form for p in bwd_plans() for d in p.decisions if d.fused}
    assert {"fwd", "dlhs", "drhs"} <= fused
    np.testing.assert_allclose(float(m_off["loss"]), float(m_plain["loss"]),
                               atol=2e-2)
    np.testing.assert_allclose(float(m_off["grad_norm"]),
                               float(m_plain["grad_norm"]), rtol=5e-2)


def test_eval_step_matches_the_loss(pair):
    batch = pair["batch"]
    for off in (False, True):
        metrics = make_eval_step(pair["tmodel"], TrainConfig(),
                                 offload=off)(pair["state"].params, batch)
        jl, _ = pair["jmodel"].loss_fn(pair["jstate"].params, batch,
                                       remat=False)
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ loop and launcher
def test_train_three_steps_finite_and_decreasing():
    cfg = _tcfg()
    state, hist = train(cfg, ShapeConfig("s", *SHAPE),
                        TrainConfig(total_steps=3, warmup_steps=1,
                                    learning_rate=3e-2, remat=False),
                        device="cpu", log_every=0)
    losses = [h["loss"] for h in hist]
    assert len(hist) == 3 and int(state.opt.step) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert losses[-1] < losses[0], losses


def test_train_refuses_checkpointing_until_it_is_ported():
    with pytest.raises(NotImplementedError, match="item 5"):
        train(_tcfg(), ShapeConfig("s", *SHAPE),
              TrainConfig(checkpoint_every=100), device="cpu")
    assert TrainConfig().checkpoint_every == 0


def test_converter_refuses_an_unused_leaf(pair):
    jstate = jax.tree.map(np.asarray, pair["jstate"])
    m = dict(jstate.opt.m)
    m["surprise"] = np.zeros(3, np.float32)
    bad = jstate._replace(opt=jstate.opt._replace(m=m))
    with pytest.raises(ValueError, match="surprise"):
        from_jax_train_state(bad, pair["tcfg"], device="cpu")


def test_launcher_trains_offloaded_on_the_cpu(capsys):
    from repro_torch.launch import train as launch
    launch.main(["--local", "--device", "cpu", "--steps", "2",
                 "--offload-mode", "greedy"])
    out = capsys.readouterr().out
    assert "trained 2 steps" in out and "backward plans" in out


def test_entry_points_default_to_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(_tcfg(), ShapeConfig("s", *SHAPE),
              TrainConfig())
    assert OffloadPolicy().impl == "auto"
