"""The port's checkpoints (``repro_torch.ckpt``) on the CPU: the
scenarios of ``tests/test_checkpoint.py`` against the port's store and
manager, crash and restart through the port's ``train()``, and the
on-disk format shared with the JAX package.

* round trip (f32, int32, a 0-d leaf, bf16 stored as its uint16 view),
  ``.tmp`` ignored, retention, multi-host reassembly, shape mismatch,
  ``verify_step`` statuses, a crash between write and rename, a corrupt
  newest step walked back, a bit flip raising ``CheckpointCorrupt``, the
  last good step never deleted, a save failure counted, the final save
  not mislabelled;
* crash and restart through ``train()`` (tiny qwen3, offloaded, the
  compiled step, ``device="cpu"``): the resumed run is bit-identical to
  the uninterrupted one, and held against the JAX ``train()`` resumed at
  the same step from converted weights (loss and grad norm 1e-4, the
  parameters 2e-3: ``tests/test_torch_train_graph.py``'s tolerances);
* format parity: each package's ``verify_step`` reads the other's
  checkpoint as ``"verified"``, and as ``"corrupt"`` after one flipped
  byte.

Small size: 2 layers, d_model 64, vocab 256, 4 x 32 tokens, float32.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from conftest import tiny

from repro.ckpt import save as jsave
from repro.ckpt import verify_step as jverify_step
from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import build_model as jbuild_model
from repro.train import train as jtrain
from repro.train.step import init_train_state as jinit_train_state
from repro_torch.ckpt import (
    CheckpointCorrupt,
    CheckpointManager,
    all_steps,
    elastic_data_axis,
    latest_step,
    newest_restorable,
    restore,
    save,
    verify_step,
)
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.convert import from_jax_train_state
from repro_torch.core import artifacts
from repro_torch.kernels import guard as guard_mod
from repro_torch.serve.faults import FaultConfig, FaultInjector, inject
from repro_torch.train import loop as loop_mod
from repro_torch.train import train

torch.set_num_threads(2)

SHAPE = (32, 4)        # seq_len, global batch
HYPER = dict(learning_rate=1e-3, warmup_steps=1, total_steps=5,
             remat=False)


@pytest.fixture(autouse=True)
def fresh_injectors(monkeypatch):
    """A fresh port guard and no disk injector for every test."""
    monkeypatch.setattr(guard_mod, "_GUARD", guard_mod.KernelGuard())
    monkeypatch.setattr(artifacts, "_DISK_INJECTOR", None)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
        "b": {"c": torch.arange(16, dtype=torch.int32) + seed,
              "d": torch.tensor(3.5 + seed, dtype=torch.float32)},
        "e": torch.from_numpy(rng.standard_normal((6, 5)).astype(
            np.float32)).to(torch.bfloat16),
    }


def _zeros(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def _assert_trees_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _mgr(d, **kw):
    return CheckpointManager(
        TrainConfig(checkpoint_dir=str(d), checkpoint_every=1, **kw))


def _flip(path, at):
    raw = bytearray(path.read_bytes())
    raw[at] ^= 0x10
    path.write_bytes(bytes(raw))


# ---------------------------------------------------------------- the store
def test_roundtrip(tmp_path):
    tree = _tree()
    save(tmp_path, 3, tree)
    out = restore(tmp_path, 3, _zeros(tree))
    _assert_trees_equal(out, tree)
    assert out["b"]["d"].dim() == 0
    assert verify_step(tmp_path, 3) == "verified"


def test_latest_ignores_tmp(tmp_path):
    save(tmp_path, 1, _tree())
    (tmp_path / "step_9.tmp").mkdir()
    assert latest_step(tmp_path) == 1


def test_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save(tmp_path, s, _tree(), keep=2)
    assert all_steps(tmp_path) == [4, 5]


def test_multi_host_reassembly(tmp_path):
    """Two hosts each save their row shard; restore reassembles globals."""
    tree = _tree()
    for host in (0, 1):
        save(tmp_path, 7, tree, host_id=host, num_hosts=2)
    out = restore(tmp_path, 7, _zeros(tree), num_hosts_now=1)
    _assert_trees_equal(out, tree)


def test_shape_mismatch_rejected(tmp_path):
    save(tmp_path, 1, _tree())
    bad = _zeros(_tree())
    bad["a"] = torch.zeros(4, 4)
    with pytest.raises(AssertionError):
        restore(tmp_path, 1, bad)


@pytest.mark.parametrize("requested,surviving", [
    (1, 1), (16, 16), (16, 15), (16, 7), (12, 5), (64, 512), (7, 3)])
def test_elastic_data_axis_properties(requested, surviving):
    size = elastic_data_axis(requested, surviving)
    assert 1 <= size <= requested
    assert size <= max(1, surviving)
    assert requested % size == 0 or size == 1


def test_verify_step_statuses(tmp_path):
    assert verify_step(tmp_path, 1) == "missing"
    save(tmp_path, 1, _tree())
    assert verify_step(tmp_path, 1) == "verified"
    # the pre-checksum format: manifest + shards but no commit marker
    save(tmp_path, 2, _tree())
    (tmp_path / "step_2" / "commit.json").unlink()
    assert verify_step(tmp_path, 2) == "legacy"
    save(tmp_path, 3, _tree())
    shard = next((tmp_path / "step_3").glob("shard_*.npz"))
    _flip(shard, shard.stat().st_size // 2)
    assert verify_step(tmp_path, 3) == "corrupt"
    assert newest_restorable(tmp_path) == 2


def test_crash_between_write_and_rename_falls_back_bit_exact(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    save(tmp_path, 1, t1)
    save(tmp_path, 2, t2)
    shutil.copytree(tmp_path / "step_2", tmp_path / "step_3.tmp")
    mgr = _mgr(tmp_path)
    state, start = mgr.restore_or_init(lambda: _zeros(t2))
    assert start == 3
    _assert_trees_equal(state, t2)
    assert mgr.counters["restore_walkbacks"] == 0


def test_corrupt_newest_walks_back_bit_exact(tmp_path):
    t1, t2, t3 = _tree(1), _tree(2), _tree(3)
    for s, t in ((1, t1), (2, t2), (3, t3)):
        save(tmp_path, s, t)
    shard = next((tmp_path / "step_3").glob("shard_*.npz"))
    shard.write_bytes(shard.read_bytes()[:40])
    mgr = _mgr(tmp_path)
    state, start = mgr.restore_or_init(lambda: _zeros(t3))
    assert start == 3
    _assert_trees_equal(state, t2)
    assert mgr.counters["restore_corrupt_skipped"] == 1
    assert mgr.counters["restore_walkbacks"] == 1


def test_restore_raises_checkpoint_corrupt_on_bitflip(tmp_path):
    tree = _tree()
    save(tmp_path, 1, tree)
    shard = next((tmp_path / "step_1").glob("shard_*.npz"))
    # a byte of the last member's data (the zip's directory follows it)
    _flip(shard, shard.stat().st_size - 400)
    with pytest.raises(CheckpointCorrupt):
        restore(tmp_path, 1, _zeros(tree))


def test_failed_load_never_leaks_into_the_state(tmp_path):
    """A step that verifies but fails to load (its per-tensor sums
    disagree) is skipped, and the state is made afresh: no leaf of the
    bad step survives in what ``restore_or_init`` returns."""
    t1, t2 = _tree(1), _tree(2)
    save(tmp_path, 1, t1)
    save(tmp_path, 2, t2)
    sums = tmp_path / "step_2" / "shard_0.sums.json"
    rec = json.loads(sums.read_text())
    rec["tensors"]["a"] = "0" * 64
    sums.write_text(json.dumps(rec))
    commit = tmp_path / "step_2" / "commit.json"
    commit.unlink()       # reads as "legacy": verified enough to load
    mgr = _mgr(tmp_path)
    made = []
    state, start = mgr.restore_or_init(
        lambda: made.append(1) or _zeros(t1))
    assert start == 2 and len(made) == 2
    _assert_trees_equal(state, t1)
    assert mgr.counters["restore_corrupt_skipped"] == 1


def test_retention_never_deletes_last_known_good(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    save(tmp_path, 1, t1, keep=5)
    save(tmp_path, 2, t2, keep=5)
    inj = FaultInjector(FaultConfig(disk_fail_rate=1.0,
                                    disk_truncate_share=1.0, seed=3))
    with inject(inj):
        save(tmp_path, 3, _tree(3), keep=1)
    assert inj.counters["disk_faults_injected"] >= 1
    assert all_steps(tmp_path) == [1, 2, 3]
    assert verify_step(tmp_path, 3) == "corrupt"
    assert newest_restorable(tmp_path) == 2
    mgr = _mgr(tmp_path)
    state, start = mgr.restore_or_init(lambda: _zeros(t2))
    assert start == 3
    _assert_trees_equal(state, t2)
    save(tmp_path, 4, _tree(4), keep=1)
    assert all_steps(tmp_path) == [4]


def test_save_failure_is_counted_not_raised(tmp_path):
    mgr = _mgr(tmp_path)
    inj = FaultInjector(FaultConfig(disk_fail_rate=1.0,
                                    disk_truncate_share=0.0, seed=0))
    with inject(inj):
        assert mgr.maybe_save(1, _tree(), force=True) is None
    assert mgr.counters["save_failures"] == 1
    assert all_steps(tmp_path) == []


def test_cadence_without_a_directory_is_refused():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TrainConfig(checkpoint_every=2)
    mgr = CheckpointManager(TrainConfig())
    state, start = mgr.restore_or_init(lambda: _tree())
    assert start == 0 and mgr.maybe_save(3, state, force=True) is None


# ------------------------------------------------- train(): crash, restart
def _tcfg():
    return dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               dtype="float32", num_layers=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages from the JAX initial state: the port's uninterrupted
    run, its crash after step 2 (checkpoints at step 2) and restart, and
    the JAX package's crash and restart at the same step."""
    root = tmp_path_factory.mktemp("runs")
    jcfg = tiny("qwen3-1.7b", num_layers=2)
    jstate = jax.tree.map(np.asarray, jinit_train_state(
        jbuild_model(jcfg), jax.random.PRNGKey(0)))
    tcfg = _tcfg()
    shape = ShapeConfig("s", *SHAPE)
    mp = pytest.MonkeyPatch()
    mp.setattr(loop_mod, "init_train_state", lambda model, seed:
               from_jax_train_state(jstate, tcfg, device="cpu"))

    def port(d, steps=None):
        return train(tcfg, shape, TrainConfig(
            **HYPER, offload=True, checkpoint_every=2,
            checkpoint_dir=str(d)), steps=steps, device="cpu", log_every=0)

    try:
        out = {"ref": port(root / "ref")}
        port(root / "crash", steps=3)
        out["crash_steps"] = all_steps(root / "crash")
        (root / "crash" / "step_4.tmp").mkdir()     # a torn later save
        out["resumed"] = port(root / "crash")
    finally:
        mp.undo()

    def jax_run(steps=None):
        return jtrain(jcfg, JShapeConfig("s", *SHAPE, "train"),
                      JTrainConfig(**HYPER, checkpoint_every=2,
                                   checkpoint_dir=str(root / "jax")),
                      steps=steps, log_every=0)

    jax_run(steps=3)
    out["jax"] = jax_run()
    out["root"] = root
    return out


def test_crash_restart_resumes_bit_identical(runs):
    """The port's ``train()`` killed after step 2's checkpoint and
    restarted lands on bit-identical parameters and moments and replays
    the same metrics as the uninterrupted run."""
    (ref_state, ref_hist), (state, hist) = runs["ref"], runs["resumed"]
    assert runs["crash_steps"] == [2]
    assert [h["step"] for h in hist] == [3, 4]      # resumed, not replayed
    _assert_trees_equal(state, ref_state)
    by_step = {h["step"]: h for h in ref_hist}
    for h in hist:
        for k in ("loss", "grad_norm", "lr"):
            assert h[k] == by_step[h["step"]][k], (h["step"], k)
    assert latest_step(runs["root"] / "crash") == 4
    assert verify_step(runs["root"] / "crash", 4) == "verified"


def test_resumed_run_matches_the_jax_resumed_run(runs):
    """The port's resumed steps against the JAX ``train()`` resumed at
    the same step: metrics (1e-4) and the final parameters (2e-3)."""
    state, hist = runs["resumed"]
    jstate, jhist = runs["jax"]
    assert [h["step"] for h in jhist] == [h["step"] for h in hist]
    for g, w in zip(hist, jhist):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4)
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    want = from_jax_train_state(jax.tree.map(np.asarray, jstate), _tcfg(),
                                device="cpu")
    for got, exp in zip(pytree.tree_leaves(state.params),
                        pytree.tree_leaves(want.params)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   exp.detach().numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_final_save_not_mislabeled_when_total_shrinks(runs, tmp_path):
    """Restarting with a total below the restored step runs nothing and
    commits nothing (no restored state saved under an earlier label)."""
    d = tmp_path / "c"
    shutil.copytree(runs["root"] / "ref", d)
    before = all_steps(d)
    assert latest_step(d) == 4
    _, hist = train(_tcfg(), ShapeConfig("s", *SHAPE), TrainConfig(
        **{**HYPER, "total_steps": 3}, checkpoint_every=2,
        checkpoint_dir=str(d)), device="cpu", log_every=0)
    assert hist == [] and all_steps(d) == before


# ------------------------------------------------------------ format parity
def _jtree(seed=0):
    t = _tree(seed)
    return {"a": jnp.asarray(t["a"].numpy()),
            "b": {"c": jnp.asarray(t["b"]["c"].numpy()),
                  "d": jnp.float32(float(t["b"]["d"]))}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_verifies_the_others_checkpoint(tmp_path, writer):
    if writer == "port":
        save(tmp_path, 1, _tree())
    else:
        jsave(tmp_path, 1, _jtree())
    reader = jverify_step if writer == "port" else verify_step
    assert verify_step(tmp_path, 1) == jverify_step(tmp_path, 1) == \
        "verified"
    assert reader(tmp_path, 1) == "verified"
    shard = next((tmp_path / "step_1").glob("shard_*.npz"))
    _flip(shard, shard.stat().st_size // 3)
    assert reader(tmp_path, 1) == "corrupt"
    assert verify_step(tmp_path, 1) == jverify_step(tmp_path, 1) == \
        "corrupt"


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """The same layout and leaf keys: a JAX package's checkpoint of f32 /
    int32 leaves restores into port tensors bit for bit."""
    jt = _jtree(4)
    jsave(tmp_path, 2, jt)
    out = restore(tmp_path, 2, _zeros({k: v for k, v in _tree().items()
                                       if k != "e"}))
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(jt["a"]))
    np.testing.assert_array_equal(out["b"]["c"].numpy(),
                                  np.asarray(jt["b"]["c"]))
    assert float(out["b"]["d"]) == float(jt["b"]["d"])
