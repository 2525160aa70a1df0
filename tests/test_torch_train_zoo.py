"""Training zamba2 and rwkv6 in the port, on the CPU, held against the JAX
package's jitted, donated step.

Tiny zamba2 (12 layers: two periods of five mamba2 blocks and one tied
shared-attention block, so two ``shared_attention`` positions) and tiny
rwkv6 (2 layers), d_model 64, f32, [4 x 32] tokens, the same numpy
batches on both sides, the port's state converted from the JAX initial
state (``from_jax_train_state``).

* 3 steps against ``jax.jit(make_train_step(...), donate_argnums=(0,))``
  — plain, ``remat`` on, offloaded, 2 microbatches — of the port's eager
  ``make_train_step`` and of ``compile_train_step`` under
  ``tests/test_torch_train_graph.py``'s stand-in graph: loss and grad
  norm every step (1e-4), the parameters (2e-3) and first moments (1e-3 /
  1e-5) after step 3 — ``tests/test_torch_train.py``'s tolerances; the
  compiled step bit-equal to the eager one, every donated leaf keeping
  its ``data_ptr``, ``train_traces`` beside the jitted function's cache
  size; offloaded, the loss's and update's ``plan_misses == traces == 1``
  and ``plan_hits == 0`` beside the JAX step's, ``bwd_plan_stats()``
  frozen after the warm step.  The backward plan counts are not the
  JAX step's: the port captures the models' chunked scans with their
  chunk loop unrolled (one set of cotangent segments a chunk), where
  the reference plans one ``lax.scan`` body, so the port plans more
  backward segments (87 against 49 for zamba2, 29 against 17 for rwkv6
  at these sizes);
* the tied block as one parameter set: one tensor at every
  ``shared_attention`` position in the parameters and both moments after
  the steps, the unique parameters' sizes summing to the JAX tree's, the
  global norm counting the block once, and the block's gradient equal to
  the sum of each position's gradient when the positions are untied;
* ``train()`` with a checkpoint directory resumes a zamba2 run bit-equal
  to the uninterrupted run, the tied block written once (under
  ``shared_attn``) and restored tied; each package's ``verify_step``
  verifies the other's zamba2 checkpoint.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from conftest import tiny
from test_torch_train_graph import StandInGraph

from repro.ckpt import restore as jrestore
from repro.ckpt import save as jsave
from repro.ckpt import verify_step as jverify_step
from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.offload import bwd_plan_stats as jbwd_plan_stats
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_data_config as jmake_data_config
from repro.models import build_model as jbuild_model
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.ckpt import all_steps, restore, save, verify_step
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.convert import from_jax_train_state
from repro_torch.core.offload import bwd_plan_stats
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models import build_model
from repro_torch.models.rwkv import wkv6_chunked
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import Ties, layer_kinds
from repro_torch.optim import global_norm
from repro_torch.train import compile_train_step, make_train_step, train
from repro_torch.train import loop as loop_mod
from repro_torch.train import step as step_mod

torch.set_num_threads(2)

ARCHS = {"zamba2": ("zamba2-1.2b", 12), "rwkv6": ("rwkv6-1.6b", 2)}
SHAPE = (32, 4)        # seq_len, global batch
STEPS = 3
HYPER = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
CASES = {"plain": dict(remat=False),
         "remat": dict(remat=True),
         "offload": dict(remat=False, offload=True),
         "microbatches": dict(remat=False, microbatches=2)}


@pytest.fixture(autouse=True)
def stand_in_graph(monkeypatch):
    monkeypatch.setattr(step_mod, "StepGraph", StandInGraph)


_SETUPS: dict = {}


def _setup(name: str) -> dict:
    """The same tiny model on both sides, the JAX initial state and the
    first batches (byte-equal on both sides); made once a module."""
    if name not in _SETUPS:
        arch, layers = ARCHS[name]
        jcfg = tiny(arch, num_layers=layers)
        jmodel = jbuild_model(jcfg)
        jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0))
        data = JSyntheticLM(jmake_data_config(jcfg, JShapeConfig(
            "s", *SHAPE, "train")))
        tcfg = dataclasses.replace(reduced(get_config(arch)),
                                   dtype="float32", num_layers=layers)
        _SETUPS[name] = dict(
            name=name, jcfg=jcfg, jmodel=jmodel,
            jstate=jax.tree.map(np.asarray, jstate),
            batches=[data.batch(i) for i in range(STEPS + 1)],
            tcfg=tcfg, tmodel=build_model(tcfg, device="cpu"))
    return _SETUPS[name]


@pytest.fixture(scope="module", params=list(ARCHS))
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def zamba():
    return _setup("zamba2")


def _state(setup):
    return from_jax_train_state(setup["jstate"], setup["tcfg"], device="cpu")


def _jax_run(setup, over):
    jstep = jmake_train_step(setup["jmodel"], JTrainConfig(**HYPER, **over))
    jitted = jax.jit(jstep, donate_argnums=(0,))
    state = jax.tree.map(jnp.array, setup["jstate"])
    metrics = []
    for b in setup["batches"][:STEPS]:
        state, m = jitted(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    stats = ((jstep.stats.as_dict(), jstep.update_stats.as_dict(),
              jbwd_plan_stats().as_dict()) if over.get("offload") else None)
    return dict(metrics=metrics, state=jax.tree.map(np.asarray, state),
                cache_size=jitted._cache_size(), stats=stats)


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
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **tol)


def _shared(cfg) -> list[int]:
    return [i for i, k in enumerate(layer_kinds(cfg))
            if k == "shared_attention"]


def _assert_tied(state, cfg):
    """Every shared_attention position holds the same tensors in the
    parameters and in both moments."""
    pos = _shared(cfg)
    for tree in (state.params, state.opt.m, state.opt.v):
        first = pytree.tree_leaves(tree["layers"][pos[0]])
        for i in pos[1:]:
            assert all(a is b for a, b in zip(
                first, pytree.tree_leaves(tree["layers"][i]))), i


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_the_jitted_donated_jax_step(setup, case):
    over = CASES[case]
    want = _jax_run(setup, over)
    tcfg = TrainConfig(**HYPER, **over)
    eager_state, eager = _run(make_train_step(setup["tmodel"], tcfg),
                              _state(setup), setup["batches"][:STEPS])
    for g, w in zip(eager, want["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert sorted(g) == sorted(w)
    jnext = from_jax_train_state(want["state"], setup["tcfg"], device="cpu")
    _close(eager_state.params, jnext.params, rtol=2e-3, atol=2e-3)
    _close(eager_state.opt.m, jnext.opt.m, rtol=1e-3, atol=1e-5)

    step = compile_train_step(setup["tmodel"], tcfg)
    step._capture = True                  # what a CUDA device sets
    state = _state(setup)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(state)]
    state, got = _run(step, state, setup["batches"][:1])
    warm = bwd_plan_stats().as_dict()
    state, more = _run(step, state, setup["batches"][1:STEPS])
    assert got + more == eager
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(eager_state)):
        assert torch.equal(a.detach(), b.detach()), a.shape
    assert [t.data_ptr() for t in pytree.tree_leaves(state)] == ptrs
    assert isinstance(step.graph, StandInGraph)
    assert step.counters["train_traces"] == want["cache_size"] == 1
    if setup["name"] == "zamba2":
        _assert_tied(eager_state, setup["tcfg"])
        _assert_tied(state, setup["tcfg"])
    if want["stats"] is not None:
        jloss, jupdate, jbwd = want["stats"]
        now = bwd_plan_stats().as_dict()
        assert warm["plan_misses"] > 0 and jbwd["plan_misses"] > 0
        for k in ("plan_misses", "traces", "plan_hits"):
            assert now[k] == warm[k], k
        for got_stats, want_stats in ((step.stats, jloss),
                                      (step.update_stats, jupdate)):
            got_stats = got_stats.as_dict()
            for k in ("plan_misses", "traces", "plan_hits"):
                assert got_stats[k] == want_stats[k], (k, got_stats)
            assert got_stats["plan_misses"] == got_stats["traces"] == 1
            assert got_stats["plan_hits"] == 0


def test_the_tied_block_is_one_parameter_set(setup):
    """One tensor and one pair of moments for the tied block: the unique
    parameters are the JAX tree's, the step's grad norm counts the
    block's gradient once."""
    state = _state(setup)
    ties = Ties(state.params)
    unique = ties.unique(state.params)
    jleaves = jax.tree.leaves(setup["jstate"].params)
    assert sum(t.numel() for t in unique) == sum(a.size for a in jleaves)
    assert [t.numel() for t in ties.unique(state.opt.m)] == \
        [t.numel() for t in unique]
    step = make_train_step(setup["tmodel"], TrainConfig(**HYPER))
    _, _, grads = step.compute_grads(state.params, setup["batches"][0])
    _, m = step(state, setup["batches"][0])
    torch.testing.assert_close(m["grad_norm"],
                               global_norm(ties.unique(grads)))
    pos = _shared(setup["tcfg"])
    assert len(pos) == (2 if setup["name"] == "zamba2" else 0)
    if pos:
        _assert_tied(state, setup["tcfg"])
        assert len(unique) < len(pytree.tree_leaves(state.params))


def test_the_tied_gradient_is_the_sum_over_positions(setup):
    """The tied block's gradient against the same block untied (a copy at
    each position): the sum of the positions' gradients."""
    pos = _shared(setup["tcfg"])
    if not pos:
        assert Ties(_state(setup).params).first == list(range(len(
            pytree.tree_leaves(_state(setup).params))))
        return
    step = make_train_step(setup["tmodel"], TrainConfig(**HYPER))
    params = _state(setup).params
    loss, _, grads = step.compute_grads(params, setup["batches"][0])
    untied = dict(params, layers=[
        pytree.tree_map(torch.clone, b) if i in pos else b
        for i, b in enumerate(params["layers"])])
    uloss, _, ugrads = step.compute_grads(untied, setup["batches"][0])
    assert float(loss) == pytest.approx(float(uloss), rel=1e-6)
    total = pytree.tree_map(lambda *g: sum(g),
                            *[ugrads["layers"][i] for i in pos])
    _close(grads["layers"][pos[0]], total, rtol=1e-5, atol=1e-6)
    for i in pos[1:]:
        assert all(a is b for a, b in zip(
            pytree.tree_leaves(grads["layers"][pos[0]]),
            pytree.tree_leaves(grads["layers"][i])))


def test_train_resumes_zamba2_bit_equal(zamba, monkeypatch, tmp_path):
    """``train()`` killed after step 2's checkpoint and restarted lands on
    the uninterrupted run's state bit for bit; the checkpoint holds the
    tied block once, and the restored state keeps it tied."""
    tcfg, shape = zamba["tcfg"], ShapeConfig("s", *SHAPE)
    monkeypatch.setattr(loop_mod, "init_train_state",
                        lambda model, seed: _state(zamba))

    def run(d, steps=None):
        return train(tcfg, shape, TrainConfig(
            **{**HYPER, "total_steps": 4}, checkpoint_every=2,
            checkpoint_dir=str(d)), steps=steps, device="cpu", log_every=0)

    ref_state, ref_hist = run(tmp_path / "ref")
    run(tmp_path / "crash", steps=3)
    assert all_steps(tmp_path / "crash") == [2]
    keys = [m["key"] for m in json.loads(
        (tmp_path / "crash" / "step_2" / "manifest.json").read_text())
        ["leaves"]]
    assert any(k.startswith(".params/shared_attn/") for k in keys)
    assert not any(k.startswith(f".params/layers/{i}/")
                   for i in _shared(tcfg) for k in keys)
    state, hist = run(tmp_path / "crash")
    assert [h["step"] for h in hist] == [3]
    assert hist[0] == ref_hist[-1]
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(ref_state)):
        assert torch.equal(a.detach(), b.detach())
    _assert_tied(state, tcfg)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_verifies_the_others_zamba2_checkpoint(zamba, tmp_path,
                                                            writer):
    if writer == "port":
        save(tmp_path, 1, _state(zamba))
    else:
        jsave(tmp_path, 1, zamba["jstate"])
    assert verify_step(tmp_path, 1) == jverify_step(tmp_path, 1) == \
        "verified"



def _manifest_keys(directory, step: int) -> list[str]:
    return sorted(m["key"] for m in json.loads(
        (directory / f"step_{step}" / "manifest.json").read_text())
        ["leaves"])


def _block_keys(keys: list[str], tree: str) -> list[str]:
    """The names under ``shared_attn`` of one tree of the state."""
    return sorted(k.split("shared_attn/", 1)[1] for k in keys
                  if k.startswith(tree) and "/shared_attn/" in k)


def test_a_jax_zamba2_checkpoint_resumes_in_the_port_tied(zamba, tmp_path):
    """The tied block is written once by both packages, under the same
    ``shared_attn`` leaf names in the parameters and both moments (the
    trees around it differ: the reference stacks its layers under
    ``decoder``, the port lists them under ``layers``).  A zamba2
    checkpoint the JAX package wrote, restored by it and converted
    (``from_jax_train_state``), is the port's state of the same seed, the
    block one tensor at every position; the port's own checkpoint
    restores into a fresh state as it was, still tied."""
    jsave(tmp_path / "jax", 1, zamba["jstate"])
    save(tmp_path / "port", 1, _state(zamba))
    jkeys = _manifest_keys(tmp_path / "jax", 1)
    pkeys = _manifest_keys(tmp_path / "port", 1)
    for tree in (".params/", ".opt/.m/", ".opt/.v/"):
        assert _block_keys(pkeys, tree) == _block_keys(jkeys, tree) != []
    want = _state(zamba)
    example = jax.tree.map(np.zeros_like, zamba["jstate"])
    got = from_jax_train_state(jrestore(tmp_path / "jax", 1, example),
                               zamba["tcfg"], device="cpu")
    fresh = from_jax_train_state(example, zamba["tcfg"], device="cpu")
    again = restore(tmp_path / "port", 1, fresh)
    for state in (got, again):
        _assert_tied(state, zamba["tcfg"])
        for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 100, 3, 8, 16, 32),
                                             (1, 64, 2, 16, 8, 64),
                                             (1, 37, 1, 4, 4, 256)])
def test_the_models_scans_are_the_kernels_plain_versions(b, s, h, p, n,
                                                         chunk, dtype):
    """The models' own chunked scans (``ssd_chunked``, ``wkv6_chunked``)
    and B12 / B13's plain versions are one arithmetic kept twice: bit-equal
    outputs and final states on seeded inputs, from zero and from a
    carried-in state."""
    gen = torch.Generator().manual_seed(s)

    def rand(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    xh, bmat, cmat = rand(b, s, h, p).to(dtype), rand(b, s, n), rand(b, s, n)
    dt, a = rand(b, s, h, lo=0.01, hi=0.5), rand(h, lo=-2.0, hi=-0.1)
    r, k = rand(b, s, h, p).to(dtype), rand(b, s, h, p).to(dtype)
    v, u = rand(b, s, h, n).to(dtype), rand(h, p)
    w = rand(b, s, h, p, lo=0.45, hi=0.95)
    for s0, w0 in ((None, None), (rand(b, h, p, n), rand(b, h, p, n))):
        got = ssd_chunked(xh, dt, a, bmat, cmat, chunk, s0)
        want = ssd_scan_plain(xh, (dt * a).float(), dt, bmat, cmat,
                              chunk=chunk, state0=s0)
        got_w = wkv6_chunked(r, k, v, w, u, chunk, w0)
        want_w = wkv6_plain(r, k, v, w, u, chunk=chunk, state0=w0)
        for g, x in zip((*got, *got_w), (*want, *want_w)):
            assert g.dtype == x.dtype and torch.equal(g, x)
