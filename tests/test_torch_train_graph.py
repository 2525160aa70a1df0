"""The port's compiled training step on the CPU, held against the JAX
package's jitted, donated one.

On a card ``compile_train_step`` runs its static step once eagerly a
batch signature, then captures it as one CUDA graph and replays it every
step (``StepGraph``).  Here a stand-in takes the graph's place, with the
graph's semantics (as in ``tests/test_torch_serve_graph.py``): its
"capture" runs the step with every fixed buffer put back afterwards and
the kernel launches recorded (``kernel_guard().recording()``), and a
replay runs the step without counting its wrappers' calls, then adds the
capture's record.

* 3 steps against ``jax.jit(make_train_step(...), donate_argnums=(0,))``
  on converted weights — plain, ``remat`` on, offloaded, 2 microbatches:
  loss and grad norm every step (1e-4), the parameters (2e-3) and
  moments after step 3, ``train_traces`` beside the jitted function's
  cache size, the offloaded counters beside the JAX step's;
* bit-equal to the port's eager ``make_train_step`` on the same inputs;
* the donated state: every leaf keeps its storage, the returned state is
  the one given, another state raises;
* ``train_traces`` counts batch signatures (1, then 2 after a new batch
  shape, beside the jitted function's cache size);
* offloaded: ``plan_misses == traces == 1`` and ``plan_hits == 0`` for
  the loss and the update; ``bwd_plan_stats()`` frozen after the warm
  step, as the JAX step's after its one trace;
* a kernel-guard epoch bump builds the step once more, numbers unchanged;
* offloaded, the update bound with the parameters and moments donated:
  every leaf its fused segments update is written in its own storage,
  and the write-back copies exactly the slots the update plan leaves far
  (and the step counter); a value in another slot's storage raises;
* launches of a replay equal to an eager step's (a counting wrapper);
* ``train()``'s history against the JAX ``train()``.

Tolerances: tests/test_torch_train.py's (loss and grad norm 1e-4, the
parameters 2e-3, the first moment 1e-3 / 1e-5).  Small size: 2 layers,
d_model 64, vocab 256, 4 x 32 tokens, float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from conftest import tiny
from test_torch_offload_donation import _state_outputs

from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.offload import bwd_plan_stats as jbwd_plan_stats
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_data_config as jmake_data_config
from repro.models import build_model as jbuild_model
from repro.train import train as jtrain
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.convert import from_jax_train_state
from repro_torch.core.offload import bwd_plan_stats
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import fused_matmul_bwd as fmb
from repro_torch.kernels import ops
from repro_torch.kernels.guard import kernel_guard
from repro_torch.models import build_model
from repro_torch.train import (
    compile_train_step,
    init_train_state,
    make_train_step,
    train,
)
from repro_torch.train import loop as loop_mod
from repro_torch.train import step as step_mod
from repro_torch.train.step import write_back

torch.set_num_threads(2)

SHAPE = (32, 4)        # seq_len, global batch
STEPS = 3
#: the schedule of the comparisons: the learning rate reaches 1e-3 at
#: step 1, so that three steps move the parameters by ~1e-3
HYPER = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
CASES = {"plain": dict(remat=False),
         "remat": dict(remat=True),
         "offload": dict(remat=False, offload=True),
         "microbatches": dict(remat=False, microbatches=2)}
#: the plain versions the counting wrappers stand in for: (module, name,
#: the kernel's launch counter)
PLAIN = [(ops, "fused_segment_grid_plain", "fused_segment_grid"),
         (fm, "fused_matmul_segment_plain", "fused_matmul_segment"),
         (fmb, "fused_matmul_dlhs_segment_plain",
          "fused_matmul_dlhs_segment"),
         (fmb, "fused_matmul_drhs_segment_plain",
          "fused_matmul_drhs_segment")]
KERNELS = [k for _, _, k in PLAIN]


class StandInGraph:
    """``StepGraph`` on the CPU: a warm call that stands, a capture that
    leaves no trace in the fixed buffers, replays counted from the
    record.  ``fn`` is a compiled step's static step for one batch
    signature."""

    def __init__(self, fn, device, pool=None):
        step = fn.func.__self__
        warm = fn()                              # the warm call
        saved = [t.clone() for t in step._fixed_buffers()]
        with kernel_guard().recording() as self.launches:
            self.out = fn()                      # the capture
        for t, s in zip(step._fixed_buffers(), saved):
            t.copy_(s)
        if self.out is not warm:
            self.out.copy_(warm)
        self.fn = fn
        self.memory = {"max_allocated": (0, 0), "reserved": (0, 0)}
        self.seconds = self.warm_seconds = 0.0

    def replay(self):
        with kernel_guard().recording():         # no wrapper runs
            self.out.copy_(self.fn())
        self.launches.replay()


@pytest.fixture(autouse=True)
def stand_in_graph(monkeypatch):
    monkeypatch.setattr(step_mod, "StepGraph", StandInGraph)


def _tcfg():
    return dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               dtype="float32", num_layers=2)


@pytest.fixture(scope="module")
def setup():
    """The same 2-layer f32 model on both sides, the JAX initial state
    and the first batches (byte-equal on both sides)."""
    jcfg = tiny("qwen3-1.7b", num_layers=2)
    jmodel = jbuild_model(jcfg)
    jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0))
    data = JSyntheticLM(jmake_data_config(jcfg, JShapeConfig(
        "s", *SHAPE, "train")))
    tcfg = _tcfg()
    return dict(jcfg=jcfg, jmodel=jmodel,
                jstate=jax.tree.map(np.asarray, jstate),
                batches=[data.batch(i) for i in range(STEPS + 1)],
                tcfg=tcfg, tmodel=build_model(tcfg, device="cpu"))


def _state(setup):
    """A fresh port state on the JAX initial weights."""
    return from_jax_train_state(setup["jstate"], setup["tcfg"], device="cpu")


def _compiled(setup, **over):
    step = compile_train_step(setup["tmodel"], TrainConfig(**HYPER, **over))
    step._capture = True           # what a CUDA device sets
    return step


_JAX_RUNS: dict = {}


def _jax_run(setup, case):
    """3 steps of the jitted, donated JAX step: metrics a step, the
    final state, the jitted function's cache size and (offloaded) its
    counters."""
    if case not in _JAX_RUNS:
        over = CASES[case]
        jstep = jmake_train_step(setup["jmodel"],
                                 JTrainConfig(**HYPER, **over))
        jitted = jax.jit(jstep, donate_argnums=(0,))
        state = jax.tree.map(jnp.array, setup["jstate"])
        metrics, bwd = [], []
        for i in range(STEPS):
            state, m = jitted(state, setup["batches"][i])
            metrics.append({k: float(v) for k, v in m.items()})
            bwd.append(jbwd_plan_stats().as_dict()["traces"])
        stats = None
        if over.get("offload"):
            stats = (jstep.stats.as_dict(), jstep.update_stats.as_dict(),
                     bwd)
        _JAX_RUNS[case] = dict(metrics=metrics,
                               state=jax.tree.map(np.asarray, state),
                               cache_size=jitted._cache_size(), stats=stats)
    return _JAX_RUNS[case]


def _run(step, state, batches):
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _close(got, want, **tol):
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_step_matches_the_jitted_donated_jax_step(setup, case):
    want = _jax_run(setup, case)
    step = _compiled(setup, **CASES[case])
    state, got = _run(step, _state(setup), setup["batches"][:1])
    warm = bwd_plan_stats().as_dict()
    state, more = _run(step, state, setup["batches"][1:STEPS])
    got += more
    for g, w in zip(got, want["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert sorted(g) == sorted(w)
    jnext = from_jax_train_state(want["state"], setup["tcfg"], device="cpu")
    _close(state.params, jnext.params, rtol=2e-3, atol=2e-3)
    _close(state.opt.m, jnext.opt.m, rtol=1e-3, atol=1e-5)
    assert int(state.opt.step) == STEPS
    assert isinstance(step.graph, StandInGraph)
    assert step.counters["train_traces"] == want["cache_size"] == 1
    if want["stats"] is not None:
        jloss, jupdate, jbwd = want["stats"]
        # the backward plans: counted by the warm step only (capture and
        # replays add nothing), as the jitted step's by its one trace
        now = bwd_plan_stats().as_dict()
        assert warm["plan_misses"] > 0
        for k in ("plan_misses", "traces", "plan_hits"):
            assert now[k] == warm[k], k
        assert jbwd[0] == jbwd[-1]
        for got_stats, want_stats in ((step.stats, jloss),
                                      (step.update_stats, jupdate)):
            got_stats = got_stats.as_dict()
            for k in ("plan_misses", "traces", "plan_hits"):
                assert got_stats[k] == want_stats[k], (k, got_stats)
            assert got_stats["plan_misses"] == got_stats["traces"] == 1
            assert got_stats["plan_hits"] == 0


@pytest.mark.parametrize("case", ["plain", "offload", "microbatches"])
def test_compiled_step_is_bit_equal_to_the_eager_step(setup, case):
    """The same kernels in the same order as the port's functional
    ``make_train_step``: every metric and every leaf equal."""
    tcfg = TrainConfig(**HYPER, **CASES[case])
    eager = make_train_step(setup["tmodel"], tcfg)
    want_state, want = _run(eager, _state(setup), setup["batches"][:STEPS])
    state, got = _run(_compiled(setup, **CASES[case]), _state(setup),
                      setup["batches"][:STEPS])
    assert got == want
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want_state)):
        assert torch.equal(a.detach(), b), a.shape


def test_the_donated_state_keeps_its_storage(setup):
    state = _state(setup)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(state)]
    step = _compiled(setup, **CASES["plain"])
    for i in range(STEPS):
        out, _ = step(state, setup["batches"][i])
        assert out is state
        assert [t.data_ptr() for t in pytree.tree_leaves(out)] == ptrs
    assert all(p.requires_grad for p in pytree.tree_leaves(state.params))
    assert int(state.opt.step) == STEPS
    # the same leaves in a new tuple are the donated state; others are not
    step(type(state)(state.params, state.opt), setup["batches"][0])
    with pytest.raises(ValueError, match="donated"):
        step(_state(setup), setup["batches"][0])


def test_train_traces_count_batch_signatures(setup):
    """One build a batch signature, beside the jitted function's cache:
    a half-size batch adds one, the first shape again adds none."""
    b0, b1 = setup["batches"][:2]
    half = {k: v[:2] for k, v in b1.items()}
    order = [b0, b1, half, b0]
    jitted = jax.jit(jmake_train_step(setup["jmodel"],
                                      JTrainConfig(**HYPER, remat=False)),
                     donate_argnums=(0,))
    jstate = jax.tree.map(jnp.array, setup["jstate"])
    step = _compiled(setup, remat=False)
    state = _state(setup)
    for b in order:
        jstate, jm = jitted(jstate, b)
        state, m = step(state, b)
        assert step.counters["train_traces"] == jitted._cache_size()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-4)
    assert step.counters["train_traces"] == 2
    assert len(step._builds) == 2


def test_guard_epoch_change_builds_the_step_once_more(setup):
    want_state, want = _run(_compiled(setup, **CASES["offload"]),
                            _state(setup), setup["batches"][:STEPS])
    step = _compiled(setup, **CASES["offload"])
    guard = kernel_guard()
    epoch = guard.epoch
    try:
        state, got = _run(step, _state(setup), setup["batches"][:1])
        guard.epoch += 1
        state, more = _run(step, state, setup["batches"][1:STEPS])
    finally:
        guard.epoch = epoch
    assert step.counters["train_traces"] == 2
    assert step.counters["kernel_replans"] == 1
    assert got + more == want
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want_state)):
        assert torch.equal(a.detach(), b.detach())
    # the plans were looked up again: the cache's hits, no new miss
    assert step.stats.plan_misses == 1 and step.stats.plan_hits == 1


def test_launches_of_a_replay_equal_an_eager_steps(setup, monkeypatch):
    """A counting wrapper stands in for each fused kernel: an eager
    step's launches equal one replay's (counted from the record)."""
    for mod, name, kernel in PLAIN:
        plain = getattr(mod, name)

        def counted(*a, _plain=plain, _kernel=kernel, **kw):
            out = _plain(*a, **kw)
            kernel_guard().count_launch(_kernel)
            return out
        monkeypatch.setattr(mod, name, counted)

    def per_step(step, state):
        out = []
        for b in setup["batches"][:STEPS]:
            before = ops.launch_counts()
            state, _ = step(state, b)
            after = ops.launch_counts()
            out.append({k: after[k] - before[k] for k in KERNELS})
        return out

    # bf16 compute (f32 masters): the backward plans fuse both gradient
    # forms, which f32 declines
    model = build_model(dataclasses.replace(_tcfg(), dtype="bfloat16"),
                        device="cpu")
    tcfg = TrainConfig(**HYPER, **CASES["offload"])
    eager = per_step(compile_train_step(model, tcfg, capture=False),
                     init_train_state(model, 0))
    step = compile_train_step(model, tcfg)
    step._capture = True
    compiled = per_step(step, init_train_state(model, 0))
    assert all(eager[0][k] > 0 for k in KERNELS), eager[0]
    assert eager[0] == eager[1] == eager[2]
    assert compiled == eager


def test_train_history_matches_the_jax_train(setup, monkeypatch, tmp_path):
    """``train()`` (the compiled step) against the JAX ``train()`` (the
    jitted, donated step) for 3 steps, both from the JAX initial state."""
    shape = ShapeConfig("s", *SHAPE)
    jhist = jtrain(setup["jcfg"], JShapeConfig("s", *SHAPE, "train"),
                   JTrainConfig(**HYPER, remat=False, checkpoint_every=0,
                                checkpoint_dir=str(tmp_path)),
                   steps=STEPS, log_every=0)[1]
    monkeypatch.setattr(loop_mod, "init_train_state",
                        lambda model, seed: _state(setup))
    held = []

    def on_step(step):
        step._capture = True       # what a CUDA device sets
        held.append(step)
    state, hist = train(setup["tcfg"], shape, TrainConfig(**HYPER,
                                                          remat=False),
                        steps=STEPS, device="cpu", log_every=0,
                        on_step=on_step)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for g, w in zip(hist, jhist):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4)
    assert held[0].counters["train_traces"] == 1
    assert isinstance(held[0].graph, StandInGraph)
    assert int(state.opt.step) == STEPS



def test_the_bound_plans_hold_no_inputs(setup):
    """The compiled step looks its loss and update plans up once and binds
    them without holding the tensors of that lookup (the first step's
    gradients would otherwise live as long as the step): a bound run
    keeps no tensor and must be given its inputs."""
    step = _compiled(setup, **CASES["offload"])
    _run(step, _state(setup), setup["batches"][:2])
    b = next(iter(step._builds.values()))
    for run in (b.loss_run, b.update_run):
        with pytest.raises(ValueError, match="its own signature"):
            run()
        held = [c.cell_contents for c in run.__closure__]
        assert not any(isinstance(x, torch.Tensor) for x in
                       pytree.tree_leaves(held))
    loss, _ = b.loss_run(step._state.params, b.batch)
    assert torch.isfinite(loss)


def test_the_donating_update_writes_each_offloaded_leaf_in_place(
        setup, monkeypatch):
    """The compiled step's update donates the parameters and moments:
    each value a fused segment makes for a state slot is that slot's own
    tensor when the write-back sees it, and the write-back copies the
    rest — the slots whose value the update plan leaves far, and the step
    counter — in the warm call, the capture and every replay."""
    same: list = []
    real = step_mod.write_back

    def spy(slots, values):
        same.append([a.data_ptr() == b.data_ptr() and a.shape == b.shape
                     for a, b in zip(slots, values)])
        return real(slots, values)
    monkeypatch.setattr(step_mod, "write_back", spy)
    step = _compiled(setup, **CASES["offload"])
    state, _ = _run(step, _state(setup), setup["batches"][:STEPS])
    n_params = len(step._ties.unique(state.params))
    plan = step._last.update_run.plan
    donated, made = _state_outputs(plan, n_params)
    slots = len(step._unique_state(state))
    assert made and donated == made
    assert len(same) == STEPS + 1        # warm call, capture, 2 replays
    for row in same:
        assert {i for i, s in enumerate(row) if s} == donated
    assert step.last_copied == sorted(set(range(slots)) - donated)
    assert n_params in step.last_copied     # the step counter


def test_a_value_in_another_slots_storage_raises():
    """``write_back``: a value that is its slot stays, a fresh one is
    copied, one in another slot's storage raises before anything is
    copied from it."""
    slots = [torch.zeros(4), torch.zeros(4), torch.zeros(2, 2)]
    assert write_back(slots, [slots[0], torch.ones(4),
                              torch.full((2, 2), 2.0)]) == [1, 2]
    assert slots[1].tolist() == [1.0] * 4
    with pytest.raises(RuntimeError, match="storage of leaf 0"):
        write_back(slots, [torch.ones(4), slots[0], slots[2]])
    with pytest.raises(RuntimeError, match="storage of leaf 2"):
        write_back(slots, [slots[0], slots[2].view(4), slots[2]])
