"""The port's durable artifact store (``repro_torch.core.artifacts``) and
persistent plan cache (``mpu_offload(persist_dir=...)`` /
``MPU_PLAN_CACHE``) on the CPU.

* the store: the scenarios of ``tests/test_artifacts.py`` — round trip,
  the key including the environment, a torn write read as a miss, bit
  flip, truncation, version skew, an unparsable marker, LRU and
  max-bytes eviction, atomic write and lock — and disk faults through the
  port's ``FaultInjector``;
* the plan cache on tiny port functions, their outputs held to the JAX
  function (1e-5, f32): a fresh wrapper on a warm directory plans
  nothing (``plan_misses == 0``, ``disk_hits == traces``) and is
  bit-equal to the cold run; backward plans likewise
  (``bwd_plan_stats()`` after ``clear_bwd_plans()``); bit flip,
  truncation and version skew are counted and the cold plan serves;
  ``verify_loaded``; the environment variable; a degraded guard bypasses
  the store both ways; disk faults never raise; the stats ``repr``;
* the graph fingerprint: equal over two captures in one process and in a
  fresh process, and a warm start in a subprocess plans nothing.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import artifacts
from repro_torch.core.artifacts import (
    ArtifactStore,
    atomic_write_bytes,
    env_key,
    file_lock,
    read_bytes,
    set_disk_injector,
    sha256_bytes,
)
from repro_torch.core.offload import (
    bwd_plan_stats,
    capture,
    clear_bwd_plans,
    graph_fingerprint,
    mpu_offload,
)
from repro_torch.core.policy import OffloadPolicy
from repro_torch.kernels import guard as guard_mod
from repro_torch.serve.faults import FaultConfig, FaultInjector, inject

torch.set_num_threads(2)

POLICY = OffloadPolicy(bulk_threshold=64)
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True)
def fresh_injectors(monkeypatch):
    monkeypatch.setattr(guard_mod, "_GUARD", guard_mod.KernelGuard())
    monkeypatch.setattr(artifacts, "_DISK_INJECTOR", None)
    monkeypatch.delenv("MPU_PLAN_CACHE", raising=False)


def _inputs(seed=0, shape=(64, 32)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _chain(x, y):
    h = torch.tanh(x) * 2.0 + y
    return h * torch.sigmoid(h)


def _jchain(x, y):
    h = jnp.tanh(x) * 2.0 + y
    return h * jax.nn.sigmoid(h)


def _mlp(x, w1, w2):
    h = torch.nn.functional.gelu(x @ w1, approximate="tanh") * 1.5 + 0.5
    return (torch.tanh(h @ w2) * 2.0).square().mean()


def _jmlp(x, w1, w2):
    h = jax.nn.gelu(x @ w1, approximate=True) * 1.5 + 0.5
    return jnp.mean(jnp.square(jnp.tanh(h @ w2) * 2.0))


def _held(fn, tmp_path=None, **kw):
    """A wrapper of ``_chain`` (optionally persisted), its output on the
    seeded inputs, held to the JAX function."""
    xn, yn = _inputs()
    wrapped = mpu_offload(fn, policy=POLICY, **(
        {"persist_dir": tmp_path} if tmp_path is not None else {}), **kw)
    out = wrapped(torch.from_numpy(xn), torch.from_numpy(yn))
    np.testing.assert_allclose(out.numpy(), np.asarray(_jchain(xn, yn)),
                               rtol=1e-5, atol=1e-5)
    return wrapped, out


# ---------------------------------------------------------- ArtifactStore
def test_roundtrip_hit_miss(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("plan", "fwd", "sig")
    assert store.get(key) is None
    assert store.counters["misses"] == 1
    store.put(key, b"payload-bytes", meta={"kind": "test"})
    data, status = store.fetch(key)
    assert status == "hit" and data == b"payload-bytes"
    assert store.counters == {"hits": 1, "misses": 1, "corrupt": 0,
                              "writes": 1, "write_failures": 0,
                              "evictions": 0}
    assert len(store) == 1 and store.keys() == [key]


def test_key_includes_environment(tmp_path):
    a, b = ArtifactStore(tmp_path), ArtifactStore(tmp_path)
    assert a.key_for("x") == b.key_for("x")
    assert a.key_for("x") != a.key_for("y")
    b._env = dict(a._env, schema=a._env["schema"] + 1)
    assert a.key_for("x") != b.key_for("x")
    assert set(env_key()) == {"repro_torch", "torch", "cuda", "schema"}
    assert env_key()["torch"] == torch.__version__


def test_torn_write_is_miss_not_corrupt(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("k")
    (tmp_path / f"{key}.bin").write_bytes(b"half-written")
    assert store.fetch(key) == (None, "miss")
    assert store.counters["corrupt"] == 0


def test_bitflip_quarantined(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("k")
    store.put(key, b"A" * 64)
    bin_p = tmp_path / f"{key}.bin"
    raw = bytearray(bin_p.read_bytes())
    raw[10] ^= 0x40
    bin_p.write_bytes(bytes(raw))
    assert store.fetch(key) == (None, "corrupt")
    assert store.counters["corrupt"] == 1
    assert not (tmp_path / f"{key}.ok").exists()
    assert (tmp_path / f"{key}.corrupt").exists()
    assert "checksum" in (tmp_path / f"{key}.why").read_text()
    assert store.fetch(key) == (None, "miss")


def test_truncation_quarantined(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("k")
    store.put(key, b"B" * 128)
    bin_p = tmp_path / f"{key}.bin"
    bin_p.write_bytes(bin_p.read_bytes()[:13])
    assert store.fetch(key) == (None, "corrupt")
    assert (tmp_path / f"{key}.corrupt").exists()


def test_version_skew_quarantined(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("k")
    store.put(key, b"C" * 32)
    marker_p = tmp_path / f"{key}.ok"
    rec = json.loads(marker_p.read_text())
    rec["env"] = dict(rec["env"], torch="0.0.1-other")
    marker_p.write_text(json.dumps(rec))
    assert store.fetch(key) == (None, "corrupt")
    assert "skew" in (tmp_path / f"{key}.why").read_text()


def test_unparsable_marker_quarantined(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("k")
    store.put(key, b"D" * 32)
    (tmp_path / f"{key}.ok").write_bytes(b"not json {")
    assert store.fetch(key) == (None, "corrupt")
    assert store.counters["corrupt"] == 1


def test_lru_eviction_bounded_and_recency(tmp_path):
    store = ArtifactStore(tmp_path, max_entries=3)
    keys = [store.key_for(f"k{i}") for i in range(5)]
    for i, k in enumerate(keys[:3]):
        store.put(k, bytes([i]) * 8)
        os.utime(tmp_path / f"{k}.ok", (1000 + i, 1000 + i))
    os.utime(tmp_path / f"{keys[0]}.ok", (2000, 2000))
    store.put(keys[3], b"x" * 8)
    assert len(store) == 3 and store.counters["evictions"] == 1
    assert store.get(keys[1]) is None
    assert store.get(keys[0]) is not None
    assert store.get(keys[3]) is not None


def test_max_bytes_eviction(tmp_path):
    store = ArtifactStore(tmp_path, max_bytes=100)
    k1, k2 = store.key_for("a"), store.key_for("b")
    store.put(k1, b"x" * 80)
    os.utime(tmp_path / f"{k1}.ok", (1000, 1000))
    assert store.put(k2, b"y" * 80) == 1 and len(store) == 1
    assert store.get(k2) is not None


def test_atomic_write_and_lock(tmp_path):
    p = tmp_path / "f.bin"
    atomic_write_bytes(p, b"hello")
    assert read_bytes(p) == b"hello"
    assert not p.with_name("f.bin.tmp").exists()
    with file_lock(tmp_path / ".lock"):
        atomic_write_bytes(p, b"world")
    assert read_bytes(p) == b"world"
    assert sha256_bytes(b"world") != sha256_bytes(b"hello")


def test_disk_fault_raise_is_counted_write_failure(tmp_path):
    store = ArtifactStore(tmp_path)
    inj = FaultInjector(FaultConfig(disk_fail_rate=1.0,
                                    disk_truncate_share=0.0, seed=0))
    prev = set_disk_injector(inj)
    try:
        assert store.put(store.key_for("k"), b"payload") == -1
    finally:
        set_disk_injector(prev)
    assert store.counters["write_failures"] == 1
    assert inj.counters["disk_faults_injected"] >= 1
    assert len(store) == 0


def test_disk_fault_truncate_reads_as_corrupt(tmp_path):
    store = ArtifactStore(tmp_path)
    key = store.key_for("k")
    inj = FaultInjector(FaultConfig(disk_fail_rate=1.0,
                                    disk_truncate_share=1.0, seed=0))
    prev = set_disk_injector(inj)
    try:
        store.put(key, b"E" * 256)
    finally:
        set_disk_injector(prev)
    assert store.fetch(key)[1] in ("corrupt", "miss")
    assert store.get(key) is None


def test_inject_contextmanager_installs_disk_hook(tmp_path):
    store = ArtifactStore(tmp_path)
    inj = FaultInjector(FaultConfig(disk_fail_rate=1.0,
                                    disk_truncate_share=0.0, seed=0))
    with inject(inj):
        assert store.put(store.key_for("k"), b"z") == -1
        assert guard_mod.kernel_guard().injector is inj
    assert store.put(store.key_for("k"), b"z") >= 0
    assert guard_mod.kernel_guard().injector is None


# ------------------------------------------------------ the plan cache
def test_plan_cache_warm_start_zero_fresh_plans(tmp_path):
    cold, out_cold = _held(_chain, tmp_path)
    warm, out_warm = _held(_chain, tmp_path)
    assert cold.stats.plan_misses == 1 and cold.stats.disk_misses == 1
    assert warm.stats.plan_misses == 0
    assert warm.stats.disk_hits == warm.stats.traces == 1
    assert warm.stats.disk_corrupt == 0
    assert torch.equal(out_cold, out_warm)
    x, y = map(torch.from_numpy, _inputs())
    assert warm.explain(x, y).decisions == cold.explain(x, y).decisions


def test_plan_cache_backward_plans_warm(tmp_path):
    """The segments' backward plans go to the same store: a fresh wrapper
    plans neither direction, and the gradients are bit-equal."""
    rng = np.random.default_rng(1)
    xn = rng.standard_normal((128, 32)).astype(np.float32)
    w1n = (rng.standard_normal((32, 64)) * 0.2).astype(np.float32)
    w2n = (rng.standard_normal((64, 32)) * 0.2).astype(np.float32)
    jl, jg = jax.value_and_grad(_jmlp, argnums=(1, 2))(xn, w1n, w2n)
    runs = []
    for _ in range(2):
        clear_bwd_plans()
        w1 = torch.from_numpy(w1n).requires_grad_()
        w2 = torch.from_numpy(w2n).requires_grad_()
        fn = mpu_offload(_mlp, policy=POLICY, persist_dir=tmp_path)
        loss = fn(torch.from_numpy(xn), w1, w2)
        grads = torch.autograd.grad(loss, (w1, w2))
        runs.append((fn.stats.as_dict(), bwd_plan_stats().as_dict(),
                     loss.detach(), grads))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        for g, w in zip(grads, jg):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
    (fs0, bs0, l0, g0), (fs1, bs1, l1, g1) = runs
    assert bs0["plan_misses"] >= 1 and bs0["traces"] >= 2
    assert fs1["plan_misses"] == 0 and fs1["disk_hits"] == 1
    assert bs1["plan_misses"] == 0
    assert bs1["disk_hits"] == bs1["traces"] == bs0["traces"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _corrupt_every_bin(d, mutate):
    bins = sorted(pathlib.Path(d).glob("*.bin"))
    assert bins, "no persisted plan entry found"
    for b in bins:
        b.write_bytes(bytes(mutate(bytearray(b.read_bytes()))))


@pytest.mark.parametrize("how", ["bitflip", "truncate", "skew", "garbage"])
def test_plan_cache_corruption_counted_and_cold_identical(tmp_path, how):
    _, ref = _held(_chain)
    _held(_chain, tmp_path)
    if how == "bitflip":
        def flip(raw):
            raw[len(raw) // 2] ^= 0x01
            return raw
        _corrupt_every_bin(tmp_path, flip)
    elif how == "truncate":
        _corrupt_every_bin(tmp_path, lambda raw: raw[:len(raw) // 3])
    elif how == "skew":
        for marker_p in pathlib.Path(tmp_path).glob("*.ok"):
            rec = json.loads(marker_p.read_text())
            rec["env"] = dict(rec["env"], schema=-1)
            marker_p.write_text(json.dumps(rec))
    else:
        # checksummed clean, but not a plan of this graph
        store = ArtifactStore(tmp_path)
        for key in store.keys():
            store.put(key, json.dumps({"schema": 1, "fingerprint": "0",
                                       "segments": []}).encode())
    warm, out = _held(_chain, tmp_path)
    assert warm.stats.disk_corrupt == 1 and warm.stats.plan_misses == 1
    assert warm.stats.disk_hits == 0
    assert list(pathlib.Path(tmp_path).glob("*.corrupt"))
    assert torch.equal(out, ref)
    healed, _ = _held(_chain, tmp_path)      # the fresh plan was written
    assert healed.stats.disk_hits == 1


def test_plan_cache_verify_on_load(tmp_path):
    _, out_cold = _held(_chain, tmp_path)
    warm, out_warm = _held(_chain, tmp_path, verify_loaded=True)
    assert warm.stats.disk_hits == 1 and warm.stats.plan_misses == 0
    assert torch.equal(out_cold, out_warm)


def test_plan_cache_env_var_activates(tmp_path, monkeypatch):
    monkeypatch.setenv("MPU_PLAN_CACHE", str(tmp_path))
    _held(_chain)
    assert list(pathlib.Path(tmp_path).glob("*.ok"))
    warm, _ = _held(_chain)
    assert warm.stats.disk_hits == 1 and warm.stats.plan_misses == 0


def test_degraded_guard_bypasses_disk_both_ways(tmp_path):
    g = guard_mod.kernel_guard()
    _held(_chain, tmp_path)
    n_entries = len(list(pathlib.Path(tmp_path).glob("*.ok")))
    assert n_entries == 1
    for _ in range(g.threshold):
        g.record_failure("fused_segment_grid", "cuda")
    assert g.degraded_for(POLICY.impl)
    degraded, _ = _held(_chain, tmp_path)
    assert degraded.stats.disk_hits == degraded.stats.disk_misses == 0
    assert len(list(pathlib.Path(tmp_path).glob("*.ok"))) == n_entries
    x, y = map(torch.from_numpy, _inputs())
    assert degraded.plan_for(x, y).segments == []
    g.reset()
    healthy, _ = _held(_chain, tmp_path)
    assert healthy.stats.disk_hits == 1


def test_plan_cache_disk_fault_injection_never_raises(tmp_path):
    inj = FaultInjector(FaultConfig(disk_fail_rate=1.0,
                                    disk_truncate_share=0.5, seed=11))
    with inject(inj):
        fn, _ = _held(_chain, tmp_path)
        again, _ = _held(_chain, tmp_path)
    assert inj.counters["disk_faults_injected"] >= 1
    assert fn.stats.plan_misses == 1
    assert again.stats.disk_hits == 0


def test_stats_repr_mentions_disk_only_when_used(tmp_path):
    plain, _ = _held(_chain)
    assert "disk" not in repr(plain.stats)
    persisted, _ = _held(_chain, tmp_path)
    assert "disk_misses=1" in repr(persisted.stats)
    d = persisted.stats.as_dict()
    assert d["disk_misses"] == 1 and d["disk_hits"] == 0
    assert d["hit_rate"] == 0.0


# ------------------------------------------------------------ fingerprint
_CHILD = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, {src!r})
from repro_torch.core.offload import capture, graph_fingerprint, mpu_offload
from repro_torch.core.policy import OffloadPolicy

def _chain(x, y):
    h = torch.tanh(x) * 2.0 + y
    return h * torch.sigmoid(h)

rng = np.random.default_rng(0)
x, y = (torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
        for _ in range(2))
fn = mpu_offload(_chain, policy=OffloadPolicy(bulk_threshold=64),
                 persist_dir={d!r})
out = fn(x, y)
print(json.dumps(dict(stats=fn.stats.as_dict(),
                      fp=graph_fingerprint(capture(_chain, (x, y))[0]),
                      out=out.numpy().tobytes().hex())))
"""


def test_fingerprint_is_process_independent(tmp_path):
    xn, yn = _inputs()
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    fp = graph_fingerprint(capture(_chain, (x, y))[0])
    assert fp == graph_fingerprint(capture(_chain, (x, y))[0])
    assert fp != graph_fingerprint(capture(_chain, (x[:32], y[:32]))[0])
    cold, out = _held(_chain, tmp_path)
    child = subprocess.run(
        [sys.executable, "-c", _CHILD.format(src=SRC, d=str(tmp_path))],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONHASHSEED": "123"})
    assert child.returncode == 0, child.stderr
    got = json.loads(child.stdout.strip().splitlines()[-1])
    assert got["fp"] == fp
    assert got["stats"]["plan_misses"] == 0
    assert got["stats"]["disk_hits"] == got["stats"]["traces"] == 1
    assert got["out"] == out.numpy().tobytes().hex()
