"""The port's fault injection (``repro_torch.serve.faults``) and guarded
dispatch (``repro_torch.kernels.guard``) on the CPU.

* the port's ``FaultInjector`` against the JAX package's: the same config
  and seed give the same draws over a long call sequence, for every
  class; the classes draw from streams of their own; ``ref`` is never
  faulted; the NaN limit gives at most one slot a step;
* the guard: an injected launch failure demotes a ``cuda`` call to the
  plain version, ``threshold`` consecutive ones quarantine the pair and
  bump the epoch, ``reset`` lifts it, ``ref`` never quarantines, and a
  real (non-injected) error of the kernel propagates — driven by a stub
  wrapper, since the CPU has no kernel to launch;
* after a quarantine of a segment kernel a tiny offloaded function
  plans ``all_far`` (its output still held to the JAX function, 1e-5)
  and after ``reset`` its original plan serves again;
* the port's ``Engine`` driven by the port's injector against the JAX
  ``Engine`` driven by the JAX injector of the same config: slow steps
  (a deadline), NaN logits and page faults give the same tokens and
  statuses.

Small size: 2 layers, d_model 64, head_dim 16, vocab 256, float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny

from repro.kernels.guard import kernel_guard as jax_kernel_guard
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine
from repro.serve import FaultConfig as JFaultConfig
from repro.serve import FaultInjected as JFaultInjected
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import artifacts
from repro_torch.core.offload import mpu_offload
from repro_torch.core.policy import OffloadPolicy
from repro_torch.kernels import guard as guard_mod
from repro_torch.kernels import ops
from repro_torch.serve import (
    Engine,
    FaultConfig,
    FaultInjected,
    FaultInjector,
    Request,
    inject,
)

torch.set_num_threads(1)

CLASSES = dict(kernel=dict(kernel_fail_rate=0.3, kernel_fail_burst=2),
               nan=dict(nan_logit_rate=0.4, nan_logit_limit=0),
               page=dict(page_fail_rate=0.35),
               slow=dict(slow_step_rate=0.5, slow_step_s=1e-6),
               disk=dict(disk_fail_rate=0.4, disk_truncate_share=0.5))


@pytest.fixture(autouse=True)
def fresh_guard(monkeypatch):
    """A fresh port guard and no disk injector for every test; the JAX
    guard (set by a JAX engine built with an injector) cleared after."""
    monkeypatch.setattr(guard_mod, "_GUARD", guard_mod.KernelGuard())
    monkeypatch.setattr(artifacts, "_DISK_INJECTOR", None)
    yield
    g = jax_kernel_guard()
    g.injector = None
    g.reset()


def _draws(inj, n=400):
    """A long mixed call sequence; what each call gave."""
    rng = np.random.default_rng(7)
    out = []
    kernels = ("fused_segment_grid", "rmsnorm", "flash_attention")
    for i in range(n):
        k = kernels[i % 3]
        try:
            inj.kernel_launch(k, "cuda" if i % 5 else "ref")
            out.append(("k", False))
        except (FaultInjected, JFaultInjected):
            out.append(("k", True))
        active = rng.random(6) < 0.6
        out.append(("n", inj.poison_slots(active).tolist()))
        out.append(("p", inj.page_alloc()))
        inj.slow_step()
        out.append(("d", inj.disk_io("read" if i % 2 else "write")))
    return out, dict(inj.counters)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_injector_draws_equal_the_jax_injectors(cls):
    kw = dict(CLASSES[cls], seed=11)
    got = _draws(FaultInjector(FaultConfig(**kw)))
    want = _draws(JFaultInjector(JFaultConfig(**kw)))
    assert got == want
    assert any(v for _, v in got[0] if v not in (False, None)) or \
        cls == "slow"


def test_all_classes_at_once_equal_the_jax_injectors():
    kw = {k: v for c in CLASSES.values() for k, v in c.items()}
    got = _draws(FaultInjector(FaultConfig(**kw, seed=5)))
    want = _draws(JFaultInjector(JFaultConfig(**kw, seed=5)))
    assert got == want
    assert got[1]["slow_steps"] > 0 and got[1]["kernel_faults"] > 0


def test_fault_classes_draw_from_streams_of_their_own():
    """Enabling another class never moves one class's sequence."""
    alone = _draws(FaultInjector(FaultConfig(**CLASSES["page"], seed=2)))
    both = _draws(FaultInjector(FaultConfig(**CLASSES["page"],
                                            **CLASSES["disk"], seed=2)))
    assert [v for t, v in alone[0] if t == "p"] == \
        [v for t, v in both[0] if t == "p"]


def test_ref_is_never_faulted_and_nan_limit_holds():
    inj = FaultInjector(FaultConfig(kernel_fail_rate=1.0, nan_logit_rate=1.0,
                                    nan_logit_limit=3, seed=0))
    for _ in range(50):
        inj.kernel_launch("rmsnorm", "ref")
    masks = [inj.poison_slots(np.ones(4, bool)) for _ in range(10)]
    assert all(m.sum() <= 1 for m in masks)
    assert sum(int(m.sum()) for m in masks) == 3
    assert inj.counters["kernel_faults"] == 0
    with pytest.raises(FaultInjected):
        inj.kernel_launch("rmsnorm", "cuda")


# ---------------------------------------------------------------- the guard
def _stub(calls):
    def attempt(im):
        calls.append(im)
        return "kernel" if im == "cuda" else "plain"
    return attempt


def test_injected_failures_demote_then_quarantine_then_reset():
    g = guard_mod.kernel_guard()
    inj = FaultInjector(FaultConfig(kernel_fail_rate=1.0,
                                    kernel_fail_burst=3, seed=0))
    calls = []
    with inject(inj):
        outs = [g.run("fused_segment_grid", "cuda", _stub(calls))
                for _ in range(4)]
    assert outs == ["plain"] * 4
    # three injected failures (never reached the kernel), then quarantine
    assert calls == ["ref"] * 4
    assert g.failures("fused_segment_grid", "cuda") == (3, 3)
    assert g.is_quarantined("fused_segment_grid", "cuda")
    assert g.stats() == {"guard_epoch": 1, "kernel_failures": 3,
                         "kernel_fallbacks": 4, "quarantines": 1}
    assert g.degraded_for("auto") and g.degraded_for("cuda")
    assert not g.degraded_for("ref")
    g.reset()
    assert g.epoch == 2 and not g.degraded_for("cuda")
    calls.clear()
    assert g.run("fused_segment_grid", "cuda", _stub(calls)) == "kernel"
    assert calls == ["cuda"]


def test_a_success_clears_the_consecutive_count():
    g = guard_mod.kernel_guard()
    inj = FaultInjector(FaultConfig(kernel_fail_rate=1.0,
                                    kernel_fail_burst=2, seed=0))
    calls = []
    with inject(inj):
        for _ in range(2):
            g.run("rotary", "cuda", _stub(calls))
    inj.cfg = dataclasses.replace(inj.cfg, kernel_fail_rate=0.0)
    with inject(inj):
        assert g.run("rotary", "cuda", _stub(calls)) == "kernel"
    assert g.failures("rotary", "cuda") == (0, 2)
    assert not g.is_quarantined("rotary", "cuda") and g.epoch == 0


def test_ref_is_never_quarantined():
    g = guard_mod.kernel_guard()
    for _ in range(10):
        assert g.record_failure("rmsnorm", "ref") is False
    assert not g.is_quarantined("rmsnorm", "ref") and g.epoch == 0
    assert g.chain("rmsnorm", "ref") == ("ref",)


def test_a_real_kernel_error_propagates():
    """Only ``FaultInjected`` demotes: a launch that fails for real
    raises, is not counted, and never falls back to the plain version."""
    g = guard_mod.kernel_guard()
    calls = []

    def broken(im):
        calls.append(im)
        if im == "cuda":
            raise RuntimeError("an illegal memory access")
        return "plain"

    with pytest.raises(RuntimeError, match="illegal memory"):
        g.run("paged_decode_attention", "cuda", broken)
    assert calls == ["cuda"]
    assert g.stats()["kernel_failures"] == 0
    assert g.failures("paged_decode_attention", "cuda") == (0, 0)


def test_ops_on_cpu_tensors_take_the_plain_version_unfaulted():
    """A CPU tensor resolves to ``ref``: the injector is never asked."""
    inj = FaultInjector(FaultConfig(kernel_fail_rate=1.0, seed=0))
    x = torch.randn(4, 3, 16)
    with inject(inj):
        out = ops.rotary(x, torch.arange(4))
    assert out.shape == x.shape and inj.counters["kernel_faults"] == 0
    assert guard_mod.kernel_guard().stats()["kernel_fallbacks"] == 0


# ------------------------------------------------- degraded offload planning
def _chain(x, y):
    h = torch.tanh(x) * 2.0 + y
    return h * torch.sigmoid(h)


def _jchain(x, y):
    h = jnp.tanh(x) * 2.0 + y
    return h * jax.nn.sigmoid(h)


def test_quarantine_replans_all_far_and_reset_recovers():
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((64, 32)).astype(np.float32)
    yn = rng.standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(_jchain(xn, yn))
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    fn = mpu_offload(_chain, policy=OffloadPolicy(bulk_threshold=64))
    np.testing.assert_allclose(fn(x, y).numpy(), want, rtol=1e-5, atol=1e-5)
    assert len(fn.plan_for(x, y).segments) == 1
    g = guard_mod.kernel_guard()
    for _ in range(g.threshold):
        g.record_failure("fused_segment_grid", "cuda")
    assert g.degraded_for("auto")
    np.testing.assert_allclose(fn(x, y).numpy(), want, rtol=1e-5, atol=1e-5)
    plan = fn.plan_for(x, y)
    assert plan.policy.mode == "all_far" and plan.segments == []
    assert fn.stats.plan_misses == 2 and fn.stats.traces == 2
    g.reset()
    np.testing.assert_allclose(fn(x, y).numpy(), want, rtol=1e-5, atol=1e-5)
    assert len(fn.plan_for(x, y).segments) == 1
    assert fn.stats.plan_misses == 2 and fn.stats.plan_hits == 1


# ------------------------------------------------ the Engine, both injectors
@pytest.fixture(scope="module")
def weights():
    jcfg = tiny("qwen3-1.7b")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 250, size=5 + i).astype(np.int32)
               for i in range(4)]
    return jcfg, jparams, tcfg, tparams, prompts


@pytest.mark.parametrize("case", [
    dict(cfg=dict(slow_step_rate=1.0, slow_step_s=0.05), deadline=(1, 0.12)),
    dict(cfg=dict(nan_logit_rate=1.0, nan_logit_limit=1, seed=3)),
    dict(cfg=dict(page_fail_rate=0.5, seed=4)),
    dict(cfg=dict(nan_logit_rate=0.3, page_fail_rate=0.3, seed=9)),
], ids=["slow", "nan", "page", "nan+page"])
def test_engine_faults_match_the_jax_engine(weights, case):
    jcfg, jparams, tcfg, tparams, prompts = weights
    kw = dict(slots=4, max_len=64, page_size=8)
    over = {}
    if "deadline" in case:
        rid, seconds = case["deadline"]
        over[rid] = dict(deadline_s=seconds)
    jinj = JFaultInjector(JFaultConfig(**case["cfg"]))
    tinj = FaultInjector(FaultConfig(**case["cfg"]))
    jeng = JEngine(jcfg, jparams, fault_injector=jinj, **kw)
    teng = Engine(tcfg, tparams, device="cpu", fault_injector=tinj, **kw)
    assert guard_mod.kernel_guard().injector is tinj
    assert artifacts._DISK_INJECTOR is tinj
    want = jeng.generate([JRequest(p, max_new_tokens=6, rid=i,
                                   **over.get(i, {}))
                          for i, p in enumerate(prompts)])
    got = teng.generate([Request(p, max_new_tokens=6, rid=i,
                                 **over.get(i, {}))
                         for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert (got[i].status, got[i].reason) == \
            (want[i].status, want[i].reason), i
        if "deadline" not in case or got[i].status == "ok":
            assert got[i].tokens == want[i].tokens, i
    assert tinj.counters == jinj.counters
    for k in ("nan_aborts", "page_faults", "deadline_cancels"):
        assert teng.serve_counters[k] == jeng.serve_counters[k], k
    assert teng.pool.used_pages == 0
