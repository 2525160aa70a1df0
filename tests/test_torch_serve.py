"""Port serving engine on the CPU, held against the JAX package's paged
``Engine``: same converted weights, same request list, greedy decoding.
Token streams must be identical and ``pool.used_pages`` must follow the
same trajectory step for step.  Robustness scenarios (deadlines,
backpressure, NaN abort, page faults, preemption budget) are
re-expressed from ``tests/test_serve_robustness.py``; the fault
injector is the JAX package's, passed in as a duck-typed hook.

Small size: 2 layers, d_model 64, head_dim 16, vocab 256, float32.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny

from repro.kernels.guard import kernel_guard as jax_kernel_guard
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine, FaultConfig, FaultInjector
from repro.serve import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.serve import (
    Engine,
    PagePool,
    Request,
    bucket_length,
    ceil_pow2,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_jax_guard():
    yield
    g = jax_kernel_guard()
    g.injector = None
    g.reset()


# ---------------------------------------------------------------- kv_pool
def test_ceil_pow2_and_bucketing():
    assert [ceil_pow2(n) for n in (1, 2, 3, 4, 5, 17, 64)] == \
        [1, 2, 4, 4, 8, 32, 64]
    assert bucket_length(6, 32) == 8
    assert bucket_length(33, 32) == 32      # clamped to capacity
    assert bucket_length(200, 32) == 32
    assert bucket_length(1, 32) == 1


def test_page_pool_alloc_free_cycle():
    pool = PagePool(num_pages=8, page_size=4, table_width=4, slots=2)
    assert pool.free_pages == 7             # page 0 reserved
    assert pool.alloc(0, 3)
    assert pool.allocated(0) == 3
    assert (pool.tables[0, :3] > 0).all()   # never hands out scratch page 0
    assert pool.tables[0, 3] == 0
    assert pool.ensure(0, 2)                # already satisfied
    assert pool.alloc(1, 4)
    assert not pool.alloc(0, 1)             # exhausted: all-or-nothing
    assert pool.free_pages == 0
    assert pool.free_slot(1) == 4
    assert (pool.tables[1] == 0).all()
    assert pool.alloc(0, 1)                 # recycled pages come back
    assert not pool.ensure(0, 5)            # exceeds table_width
    assert pool.pages_for(9) == 3
    with pytest.raises(ValueError):
        PagePool(num_pages=1, page_size=4, table_width=1, slots=1)


def test_page_pool_double_ops_raise():
    pool = PagePool(num_pages=8, page_size=4, table_width=4, slots=2)
    assert pool.alloc(0, 2) and pool.alloc(1, 1)
    pool.tables[1, 0] = pool.tables[0, 0]
    with pytest.raises(RuntimeError, match="double-free"):
        pool.free_slot(1)
    pool = PagePool(num_pages=8, page_size=4, table_width=4, slots=2)
    assert pool.alloc(0, 2)
    pool._free.append(int(pool.tables[0, 0]))
    with pytest.raises(RuntimeError, match="double-alloc"):
        pool.alloc(1, 1)


# ------------------------------------------------------------------ engines
def _weights(arch="qwen3-1.7b", **over):
    over = {"num_layers": 2, **over}
    jcfg = tiny(arch, **over)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def qwen():
    return _weights()


def _traced_generate(engine, reqs):
    """``engine.generate`` recording ``pool.used_pages`` after each step."""
    traj, step = [], engine.step

    def traced():
        out = step()
        traj.append(engine.pool.used_pages)
        return out

    engine.step = traced
    return engine.generate(reqs), traj


def _both(weights, prompts, new_tokens, **kw):
    jcfg, jparams, tcfg, tparams = weights
    jreqs = [JRequest(p, max_new_tokens=new_tokens, rid=i)
             for i, p in enumerate(prompts)]
    treqs = [Request(p, max_new_tokens=new_tokens, rid=i)
             for i, p in enumerate(prompts)]
    jeng = JEngine(jcfg, jparams, **kw)
    teng = Engine(tcfg, tparams, device="cpu", **kw)
    want, jtraj = _traced_generate(jeng, jreqs)
    got, ttraj = _traced_generate(teng, treqs)
    for i in range(len(prompts)):
        assert got[i].status == want[i].status == "ok"
        assert got[i].tokens == want[i].tokens, i
        assert len(got[i].tokens) == new_tokens
    assert ttraj == jtraj                   # page accounting, step for step
    assert teng.pool.used_pages == 0 and jeng.pool.used_pages == 0
    shared = set(teng.serve_counters) & set(jeng.serve_counters)
    assert {k: teng.serve_counters[k] for k in shared} == \
        {k: jeng.serve_counters[k] for k in shared}
    return teng, ttraj


def _rand_prompts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _ramp_prompts(lens):
    return [np.arange(3, 3 + n, dtype=np.int32) % 250 for n in lens]


def test_engine_matches_jax_across_page_boundaries_under_churn(qwen):
    """page_size 8, three times as many requests as slots: generation
    crosses page boundaries and slots are reused."""
    teng, traj = _both(qwen, _rand_prompts(6, 5, 24, 0), 6,
                       slots=2, max_len=48, page_size=8)
    assert max(traj) > 2 and teng.decode_steps == len(traj)


def test_engine_matches_jax_with_chunked_prefill(qwen):
    teng, _ = _both(qwen, _ramp_prompts((21, 13, 30)), 6,
                    slots=2, max_len=64, page_size=8, prefill_chunk=8)
    assert teng._chunkable


def test_engine_matches_jax_under_preemption_by_recompute(qwen):
    """6 free pages: requests 0+1 admit (4+2), then growth finds the
    free list empty and must evict; the victim recomputes exactly."""
    teng, _ = _both(qwen, _ramp_prompts((21, 15, 30)), 10,
                    slots=3, max_len=64, page_size=8, num_pages=1 + 6)
    assert teng.serve_counters["preemptions"] > 0
    assert teng.serve_counters["preemption_retries"] > 0


def test_engine_matches_jax_mha_family():
    _both(_weights("deepseek-7b"), _rand_prompts(4, 4, 20, 3), 5,
          slots=2, max_len=32, page_size=4)


def test_engine_matches_jax_sliding_window():
    """Rolling pages: window < prompt + generation."""
    weights = _weights("qwen3-1.7b", sliding_window=8)
    prompts = [np.arange(2, 2 + n, dtype=np.int32) for n in (6, 11, 4)]
    _both(weights, prompts, 8, slots=2, max_len=32, page_size=4)


# --------------------------------------------------------------- robustness
@pytest.fixture(scope="module")
def setup(qwen):
    _, _, tcfg, tparams = qwen
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 250, size=5 + i).astype(np.int32)
               for i in range(4)]
    return tcfg, tparams, prompts


def _reqs(prompts, **over):
    return [Request(p, max_new_tokens=6, rid=i, **over)
            for i, p in enumerate(prompts)]


def _engine(setup, **kw):
    cfg, params, _ = setup
    return Engine(cfg, params, device="cpu", slots=4, max_len=64,
                  page_size=8, **kw)


@pytest.fixture(scope="module")
def baseline(setup):
    return _engine(setup).generate(_reqs(setup[2]))


def test_midflight_deadline_cancel_reclaims_pages(setup, baseline):
    inj = FaultInjector(FaultConfig(slow_step_rate=1.0, slow_step_s=0.05))
    eng = _engine(setup, fault_injector=inj)
    reqs = _reqs(setup[2])
    reqs[1] = dataclasses.replace(reqs[1], deadline_s=0.12)
    done = eng.generate(reqs)
    assert done[1].status == "cancelled" and done[1].reason == "deadline"
    assert len(done[1].tokens) < 6
    assert eng.serve_counters["deadline_cancels"] == 1
    assert eng.pool.used_pages == 0
    for i in (0, 2, 3):
        assert done[i].status == "ok"
        assert done[i].tokens == baseline[i].tokens, i


def test_expired_deadline_rejected_at_submit(setup):
    eng = _engine(setup)
    req = Request(setup[2][0], max_new_tokens=6, rid=0, deadline_s=1e-9)
    assert eng.submit(req) == "rejected_deadline"
    (c,) = eng.pop_finished()
    assert c.status == "rejected" and c.reason == "deadline"
    assert c.tokens == []
    assert eng.serve_counters["reject_deadline"] == 1


def test_nan_logits_abort_only_poisoned_request(setup, baseline):
    inj = FaultInjector(FaultConfig(nan_logit_rate=1.0, nan_logit_limit=1,
                                    seed=3))
    eng = _engine(setup, fault_injector=inj)
    done = eng.generate(_reqs(setup[2]))
    aborted = [r for r, c in done.items() if c.status == "aborted"]
    assert len(aborted) == 1
    assert done[aborted[0]].reason == "nan_logits"
    kept = done[aborted[0]].tokens
    assert kept == baseline[aborted[0]].tokens[:len(kept)]
    for r, c in done.items():
        if r not in aborted:
            assert c.status == "ok"
            assert c.tokens == baseline[r].tokens, r
    assert eng.serve_counters["nan_aborts"] == 1
    assert eng.pool.used_pages == 0


def test_transient_page_faults_pause_and_resume_exactly(setup, baseline):
    inj = FaultInjector(FaultConfig(page_fail_rate=0.5, seed=4))
    eng = _engine(setup, fault_injector=inj)
    done = eng.generate(_reqs(setup[2]))
    assert inj.counters["page_faults_injected"] > 0
    assert eng.serve_counters["page_faults"] > 0
    for i in range(4):
        assert done[i].status == "ok"
        assert done[i].tokens == baseline[i].tokens, i
    assert eng.pool.used_pages == 0


def test_bounded_queue_rejects_overflow(setup):
    eng = _engine(setup, max_queue=2)
    outcomes = [eng.submit(Request(setup[2][i % 4], max_new_tokens=4, rid=i))
                for i in range(4)]
    assert outcomes == ["queued", "queued",
                        "rejected_queue_full", "rejected_queue_full"]
    assert eng.serve_counters["reject_queue_full"] == 2
    rejected = {c.rid: c for c in eng.pop_finished()}
    assert set(rejected) == {2, 3}
    assert all(c.status == "rejected" and c.reason == "queue_full"
               for c in rejected.values())


def test_preemption_budget_and_aging_still_exact(setup, baseline):
    eng = _engine(setup, num_pages=1 + 5, max_preempts=3)
    done = eng.generate(_reqs(setup[2]))
    assert eng.serve_counters["preemptions"] > 0
    assert eng.serve_counters["preemption_retries"] > 0
    for i in range(4):
        assert done[i].status == "ok"
        assert done[i].tokens == baseline[i].tokens, i
    assert eng.pool.used_pages == 0


def test_sampled_rows_are_valid_and_seeded(setup, baseline):
    """``temperature > 0`` draws from the engine's torch.Generator: not
    comparable with jax.random, so held only to validity and to the
    seed; greedy rows beside them stay exact."""
    cfg, _, prompts = setup

    def run(seed):
        reqs = _reqs(prompts)
        reqs[0] = dataclasses.replace(reqs[0], temperature=0.9)
        reqs[2] = dataclasses.replace(reqs[2], temperature=1.5)
        return _engine(setup, seed=seed).generate(reqs)

    a, b, c = run(0), run(0), run(1)
    for i in range(4):
        assert a[i].status == "ok" and len(a[i].tokens) == 6
        assert all(0 <= t < cfg.vocab_size for t in a[i].tokens)
        assert a[i].tokens == b[i].tokens           # same seed, same draw
    for i in (1, 3):
        assert a[i].tokens == baseline[i].tokens    # greedy rows untouched
    assert any(a[i].tokens != c[i].tokens for i in (0, 2))


def test_engine_surface_of_this_slice(setup):
    cfg, params, _ = setup
    off = Engine(cfg, params, device="cpu", offload=True)
    assert off.offload and off.offload_stats["plan_misses"] == 0
    eng = _engine(setup)
    assert eng.offload_stats is None and eng.explain_decode() is None
    # the JAX engine's trace counters of its compiled functions (admit,
    # decode step, chunk, controls), in its order, at 0 before any call
    traces = ["admit_traces", "step_traces", "chunk_traces",
              "control_traces"]
    assert [k for k in eng.serve_counters if k.endswith("_traces")] == traces
    assert all(eng.serve_counters[k] == 0 for k in traces)
    stats = eng.serve_stats
    assert stats["pages_used"] == 0 and stats["decode_steps"] == 0
    assert stats["kernel_launches"] == {
        "paged_decode_attention": 0, "fused_segment_grid": 0,
        "fused_matmul_segment": 0, "fused_matmul_dlhs_segment": 0,
        "fused_matmul_drhs_segment": 0, "adamw_update": 0,
        "flash_attention": 0, "flash_attention_bwd_dkv": 0,
        "flash_attention_bwd_dq": 0, "rmsnorm": 0, "rmsnorm_bwd": 0,
        "rotary": 0, "decode_attention": 0, "ssd_scan": 0, "wkv6": 0}
    assert stats["table_width"] == 8 and stats["guard_epoch"] == 0


# ------------------------------------------------------------------ offload
def _offload_policies():
    """The tests' width (d_model 64, 2 slots) keeps every value below the
    default bulk_threshold of 1024; both engines get the same low one so
    that segments form."""
    from repro.core import OffloadPolicy as JPolicy
    from repro_torch.core import OffloadPolicy
    return JPolicy(bulk_threshold=32), OffloadPolicy(bulk_threshold=32)


def test_offloaded_engine_matches_jax_offloaded_and_eager(qwen):
    jcfg, jparams, tcfg, tparams = qwen
    jpol, tpol = _offload_policies()
    prompts = _rand_prompts(5, 5, 20, 4)
    jreqs = [JRequest(p, max_new_tokens=6, rid=i)
             for i, p in enumerate(prompts)]
    jeng = JEngine(jcfg, jparams, slots=2, max_len=48, page_size=8,
                   offload_policy=jpol)
    want, jtraj = _traced_generate(jeng, jreqs)
    results = {}
    for label, kw in (("offload", dict(offload_policy=tpol)), ("eager", {})):
        eng = Engine(tcfg, tparams, device="cpu", slots=2, max_len=48,
                     page_size=8, **kw)
        got, traj = _traced_generate(eng, [
            Request(p, max_new_tokens=6, rid=i)
            for i, p in enumerate(prompts)])
        results[label] = (eng, got, traj)
        for i in range(len(prompts)):
            assert got[i].status == "ok"
            assert got[i].tokens == want[i].tokens, (label, i)
        assert traj == jtraj, label
    off = results["offload"][0]
    plan = off.decode_plan()
    assert any(s.matmul is not None for s in plan.segments)
    assert any(s.matmul is None for s in plan.segments)
    assert off.offload_stats["plan_misses"] == 1
    assert off.pool.used_pages == 0
    report = off.explain_decode()
    assert report.n_fused == len(plan.segments) and report.n_declined > 0


def test_offloaded_engine_plans_once_under_churn(qwen):
    """24 requests through 2 slots (the JAX engine's zero-retrace test):
    the decode signature never changes, so one plan serves every step."""
    _, _, tcfg, tparams = qwen
    _, tpol = _offload_policies()
    eng = Engine(tcfg, tparams, device="cpu", slots=2, max_len=32,
                 page_size=8, offload_policy=tpol)
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(1, 250, size=rng.integers(5, 8)).astype(
        np.int32), max_new_tokens=4, rid=i) for i in range(24)]
    done = eng.generate(reqs)
    assert all(len(done[r.rid].tokens) == 4 for r in reqs)
    st = eng.offload_stats
    assert st["plan_misses"] == 1 and st["traces"] == 1, st
    # the plan is bound once, when the decode step is built: no lookup a
    # step, as the JAX engine's jitted step never re-enters the wrapper
    assert st["plan_hits"] == 0
    assert eng.serve_stats["pages_used"] == 0
