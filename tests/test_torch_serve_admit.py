"""The port's compiled admit, chunked prefill and slot controls on the
CPU, held against the JAX package's jitted ones.

On a card the ``Engine`` captures admit once per pow2 prompt bucket, the
prefill chunk once and each slot control once as CUDA graphs
(``StepGraph``, sharing one memory pool) and replays them.  Here
``test_torch_serve_graph.py``'s stand-in takes the graphs' place, with
their semantics: a warm call that stands, a capture that leaves no trace
in the fixed buffers, replays that run no counted wrapper.

* the ports of ``test_zero_retrace_steady_state_single_bucket`` and
  ``test_zero_retrace_one_trace_per_bucket``: ``admit_traces`` 1 and 4,
  frozen on the repeat, ``step_traces == 1``, offloaded ``plan_misses
  == traces == 1``, each equal to the JAX engine's ``serve_counters``;
* chunked prefill: ``chunk_traces == 1``, tokens equal to whole-prompt
  prefill and to the JAX engine;
* ``control_traces`` equal to the JAX engine's under preemption, a
  transient page-alloc pause and resume, a deadline and a poisoned row;
* sliding window with bucketed prompts longer than the window, and MHA;
* tiny zamba2 / rwkv6: admits eager (no bucket), ``admit_traces`` equal
  to the JAX engine's count of distinct prompt lengths;
* every fixed buffer keeps its storage over 24 requests through 2 slots;
* ``blockwise_attention`` with a tensor ``q_offset`` bit-equal to the
  int path;
* a kernel-guard epoch change drops the decode graph only;
* a failed capture raises, and ``capture_decode=False`` changes no token.

In every scenario the greedy tokens, the statuses, the ``pool.used_pages``
trajectories and every counter the two engines share are equal.

Small size: 2 layers (zamba2 6), d_model 64, vocab 256, float32.
"""
import numpy as np
import pytest
import torch

from test_torch_serve_graph import (
    StandInGraph,
    _buffers,
    _graph_engine,
    _ramp_prompts,
    _rand_prompts,
    _traced,
    _weights,
)

from repro.core import OffloadPolicy as JPolicy
from repro.kernels.guard import kernel_guard as jax_kernel_guard
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch.core import OffloadPolicy
from repro_torch.kernels.guard import kernel_guard
from repro_torch.models.attention import blockwise_attention
from repro_torch.serve import Engine, Request, bucket_length
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(1)

TRACES = ("admit_traces", "step_traces", "chunk_traces", "control_traces")


@pytest.fixture(autouse=True)
def stand_in(monkeypatch):
    """Every capture goes through the stand-in; the JAX guard's injector
    (set by a JAX engine built with one) is cleared afterwards."""
    monkeypatch.setattr(engine_mod, "StepGraph", StandInGraph)
    yield
    g = jax_kernel_guard()
    g.injector = None
    g.reset()


@pytest.fixture(scope="module")
def qwen():
    return _weights()


class Chaos:
    """A duck-typed fault injector, deterministic and the same for both
    engines: page allocations that fail on the given calls, a deadline
    that passes at the start of a given step (for the request ``rid``),
    and the first decoding slot poisoned at a given step."""

    def __init__(self, fail_allocs=(), deadline=(0, -1), poison_step=0):
        self.fail_allocs = set(fail_allocs)
        self.deadline_step, self.deadline_rid = deadline
        self.poison_step = poison_step
        self.allocs = self.steps = 0
        self.engine = None

    def page_alloc(self) -> bool:
        self.allocs += 1
        return self.allocs in self.fail_allocs

    def slow_step(self) -> None:
        self.steps += 1
        if self.steps == self.deadline_step:
            for r in self.engine._slot_req:
                if r is not None and r.rid == self.deadline_rid:
                    r.deadline_at = 1.0            # long past

    def poison_slots(self, active) -> np.ndarray:
        mask = np.zeros(len(active), bool)
        if self.steps == self.poison_step:
            mask[np.flatnonzero(active)[0]] = True
        return mask

    def kernel_launch(self, kernel, impl) -> None:   # the JAX guard's hook
        pass


def _sized_prompts(lens, seed):
    """Random prompts of the given lengths (pow2 buckets 4/8/16/32 for
    ``test_zero_retrace_one_trace_per_bucket``'s lengths)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in lens]


def _offload(tag):
    return dict(offload_policy=(JPolicy if tag == "jax" else OffloadPolicy)(
        bulk_threshold=32))


#: (arch, layers, config overrides, prompt sets (one run each), new
#: tokens, engine kwargs, extra kwargs by engine, chaos kwargs)
CASES = {
    "single_bucket": ("qwen3-1.7b", 2, {},
                      [_rand_prompts(24, 5, 8, 1)], 4,
                      dict(slots=2, max_len=32, page_size=8), _offload, None),
    "buckets": ("qwen3-1.7b", 2, {},
                [_sized_prompts((3, 7, 12, 20, 3, 9, 17, 30), seed)
                 for seed in (0, 1)], 3,
                dict(slots=2, max_len=64, page_size=8), _offload, None),
    "chunked": ("qwen3-1.7b", 2, {}, [_ramp_prompts((21, 13, 30, 5))], 6,
                dict(slots=2, max_len=64, page_size=8, prefill_chunk=8),
                None, None),
    "controls": ("qwen3-1.7b", 2, {}, [_ramp_prompts((21, 15, 30, 12, 9))],
                 10, dict(slots=3, max_len=64, page_size=8, num_pages=9,
                          prefill_chunk=16),
                 None, dict(fail_allocs=(9, 10), deadline=(14, 4),
                            poison_step=12)),
    "sliding_window": ("qwen3-1.7b", 2, {"sliding_window": 8},
                       [_ramp_prompts((6, 11, 20, 4, 13))], 8,
                       dict(slots=2, max_len=32, page_size=4), None, None),
    "mha": ("deepseek-7b", 2, {}, [_rand_prompts(4, 4, 20, 3)], 5,
            dict(slots=2, max_len=32, page_size=4), None, None),
    "zamba2": ("zamba2-1.2b", 6, {}, [_rand_prompts(4, 4, 12, 3)], 5,
               dict(slots=2, max_len=32, page_size=8), None, None),
    "rwkv6": ("rwkv6-1.6b", 2, {}, [_rand_prompts(4, 4, 12, 3)], 5,
              dict(slots=2, max_len=32, page_size=8), None, None),
}


def _serve(engine, prompts, new, request_cls, chaos):
    if chaos is not None:
        inj = engine._injector
        inj.engine, inj.allocs, inj.steps = engine, 0, 0
    return _traced(engine, [request_cls(p, max_new_tokens=new, rid=i)
                            for i, p in enumerate(prompts)])


@pytest.mark.parametrize("case", list(CASES))
def test_admit_chunk_and_controls_match_jax_engine(case, qwen):
    arch, layers, over, runs, new, kw, extra, chaos = CASES[case]
    jcfg, jparams, tcfg, tparams = qwen if arch == "qwen3-1.7b" and \
        not over else _weights(arch, layers, **over)
    jkw, tkw = (extra("jax"), extra("torch")) if extra else ({}, {})
    if chaos is not None:
        jkw["fault_injector"] = Chaos(**chaos)
        tkw["fault_injector"] = Chaos(**chaos)
    jeng = JEngine(jcfg, jparams, **kw, **jkw)
    eng = _graph_engine(tcfg, tparams, **kw, **tkw)
    counters = []
    for prompts in runs:
        want, jtraj = _serve(jeng, prompts, new, JRequest, chaos)
        got, traj = _serve(eng, prompts, new, Request, chaos)
        for i in range(len(prompts)):
            assert got[i].status == want[i].status, i
            assert got[i].tokens == want[i].tokens, i
        assert traj == jtraj
        assert eng.pool.used_pages == 0
        shared = set(eng.serve_counters) & set(jeng.serve_counters)
        assert set(TRACES) <= shared
        assert {k: eng.serve_counters[k] for k in shared} == \
            {k: jeng.serve_counters[k] for k in shared}
        counters.append({k: eng.serve_counters[k] for k in TRACES})
    c = counters[-1]
    assert c["step_traces"] == 1
    admits = [k for k in eng._graphs if k[0] == "admit"]
    if eng.bucket_prompts:
        # one graph per pow2 bucket, all captured into the shared pool
        assert len(admits) == c["admit_traces"]
        assert all(isinstance(g, StandInGraph) for g in eng._graphs.values())
    else:
        # no bucket: the same static admit eagerly, one build per length
        assert admits == [] and not eng.bucket_prompts
        lens = {len(p) for prompts in runs for p in prompts}
        assert c["admit_traces"] == len(lens) == jeng.serve_counters[
            "admit_traces"]
    if extra:
        keys = ("plan_misses", "traces", "plan_hits")
        assert {k: eng.offload_stats[k] for k in keys} == \
            {k: jeng.offload_stats[k] for k in keys} == \
            {"plan_misses": 1, "traces": 1, "plan_hits": 0}
    if case == "single_bucket":
        assert c["admit_traces"] == 1
    if case == "buckets":
        assert counters[0] == counters[1]          # frozen on the repeat
        assert c["admit_traces"] == 4
        assert sorted(k[1] for k in admits) == [4, 8, 16, 32]
    if case == "chunked":
        assert c["chunk_traces"] == 1 and c["control_traces"] == 1
        whole = Engine(tcfg, tparams, device="cpu",
                       **{**kw, "prefill_chunk": 0})
        full = whole.generate([Request(p, max_new_tokens=new, rid=i)
                               for i, p in enumerate(runs[0])])
        assert {i: x.tokens for i, x in full.items()} == \
            {i: x.tokens for i, x in got.items()}
    if case == "controls":
        sc = eng.serve_counters
        assert sc["preemptions"] > 0 and sc["alloc_stalls"] > 0
        assert sc["deadline_cancels"] == 1 and sc["nan_aborts"] == 1
        assert c["control_traces"] == 3 and c["chunk_traces"] == 1
        assert {k[0] for k in eng._graphs} >= {"activate", "deactivate",
                                              "reactivate", "chunk"}
    if case == "sliding_window":
        assert max(len(p) for p in runs[0]) > tcfg.sliding_window
        assert sorted(k[1] for k in admits) == [4, 8, 16, 32]


def test_fixed_buffers_keep_their_storage_through_admits(qwen):
    """24 requests through 2 slots: the admit's and the controls' fixed
    buffers (inputs, last logits, slot state, pools) keep their storage,
    and nothing is built twice."""
    _, _, tcfg, tparams = qwen
    eng = _graph_engine(tcfg, tparams, slots=2, max_len=32, page_size=8,
                        prefill_chunk=8)
    bufs = [*_buffers(eng), eng._ctrl, eng._temp, eng._row, eng._prompt]
    ptrs = [t.data_ptr() for t in bufs]
    prompts = _rand_prompts(24, 5, 14, 4)
    done = eng.generate([Request(p, max_new_tokens=4, rid=i)
                         for i, p in enumerate(prompts)])
    assert all(len(done[i].tokens) == 4 for i in range(24))
    assert [t.data_ptr() for t in bufs] == ptrs
    assert eng._temp.dtype == torch.float32 and eng._row.numel() == \
        eng.table_width
    buckets = sorted({bucket_length(len(p), 32) for p in prompts
                      if len(p) <= 8})
    assert {k: eng.serve_counters[k] for k in TRACES} == {
        "admit_traces": len(buckets), "step_traces": 1, "chunk_traces": 1,
        "control_traces": 1}
    assert sorted(eng._graphs) == [("activate",), *[
        ("admit", b) for b in buckets], ("chunk",)]


def test_eager_functions_give_the_graphs_tokens_and_counters(qwen):
    """``capture_decode=False`` runs the same static functions eagerly:
    the same tokens and the same trace counts, no graph."""
    _, _, tcfg, tparams = qwen
    kw = dict(slots=2, max_len=64, page_size=8, prefill_chunk=8)
    prompts = _ramp_prompts((21, 5, 30, 3, 12))
    out = {}
    for capture in (True, False):
        eng = _graph_engine(tcfg, tparams, **kw) if capture else \
            Engine(tcfg, tparams, device="cpu", capture_decode=False, **kw)
        done = eng.generate([Request(p, max_new_tokens=5, rid=i)
                             for i, p in enumerate(prompts)])
        out[capture] = ({i: c.tokens for i, c in done.items()},
                        {k: eng.serve_counters[k] for k in TRACES},
                        bool(eng._graphs))
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert out[True][2] and not out[False][2]


def test_guard_epoch_change_keeps_the_admit_graphs(qwen):
    """A kernel-guard epoch change drops the decode graph only, as the
    JAX engine re-jits only its step: the admit graphs are replayed on."""
    _, _, tcfg, tparams = qwen
    eng = _graph_engine(tcfg, tparams, slots=2, max_len=32, page_size=8)
    guard, step, seen = kernel_guard(), eng.step, []

    def bumping():
        if eng.decode_steps == 3:
            guard.epoch += 1
        out = step()
        seen.append(dict(eng._graphs))
        return out

    eng.step = bumping
    epoch = guard.epoch
    try:
        eng.generate([Request(p, max_new_tokens=4, rid=i)
                      for i, p in enumerate(_rand_prompts(6, 5, 8, 6))])
    finally:
        guard.epoch = epoch
    assert eng.serve_counters["step_traces"] == 2
    assert eng.serve_counters["kernel_replans"] == 1
    assert eng.serve_counters["admit_traces"] == 1
    assert all(g[("admit", 8)] is seen[0][("admit", 8)] for g in seen)


def test_failed_admit_capture_raises(qwen, monkeypatch):
    """No fallback: a capture that fails raises out of the engine."""
    _, _, tcfg, tparams = qwen

    class Refused(StandInGraph):
        def __init__(self, fn, device, pool=None):
            if getattr(fn, "func", None) is not None:       # an admit
                raise RuntimeError("capture refused")
            super().__init__(fn, device, pool)

    monkeypatch.setattr(engine_mod, "StepGraph", Refused)
    eng = _graph_engine(tcfg, tparams, slots=2, max_len=32, page_size=8)
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.generate([Request(np.arange(3, 9, dtype=np.int32),
                              max_new_tokens=3, rid=0)])


@pytest.mark.parametrize("q_offset", [0, 5, 37])
def test_blockwise_attention_tensor_offset_is_bit_equal(q_offset):
    """A 0-d tensor ``q_offset`` walks every KV block (no host read)
    and gives the int path's bits, causal, blocks wholly in the future
    included."""
    gen = torch.Generator().manual_seed(q_offset)
    q = torch.randn((1, 8, 4, 16), generator=gen)
    k = torch.randn((1, 64, 2, 16), generator=gen)
    v = torch.randn((1, 64, 2, 16), generator=gen)
    kw = dict(causal=True, q_block=4, kv_block=8)
    want = blockwise_attention(q, k, v, q_offset=q_offset, **kw)
    got = blockwise_attention(
        q, k, v, q_offset=torch.tensor(q_offset, dtype=torch.int32), **kw)
    assert torch.equal(got, want)
    # the walk does reach blocks wholly in the future of a query block
    assert q_offset + 8 <= 64 - 8
