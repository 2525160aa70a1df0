"""The port's compiled decode step on the CPU, held against the JAX
package's jitted one.

On a card the ``Engine`` runs its static decode step once eagerly, then
captures it as one CUDA graph and replays it every step (``StepGraph``).
Here a stand-in takes the graph's place, with the graph's semantics:
its "capture" runs the step with every fixed buffer put back afterwards
and the kernel launches recorded (``kernel_guard().recording()``), and a
replay runs the step without counting its wrappers' calls, then adds the
capture's record.  A counting wrapper stands in for the paged attention
kernel, so the launch bookkeeping is the card's: launches == decode
steps x attention layers.

* greedy tokens and page trajectories of the graph-driven engine equal
  the JAX ``Engine``'s under churn and page boundaries, chunked prefill,
  preemption, sliding window, MHA, tiny zamba2 and tiny rwkv6;
* every fixed buffer keeps its storage over 24 requests through 2
  slots, and ``step_traces == 1`` (``tests/test_serve_paged.py``'s
  zero-retrace contract);
* a kernel-guard epoch change rebuilds the step once
  (``step_traces == 2``, ``kernel_replans == 1``), tokens unchanged;
* offloaded: ``plan_misses == traces == 1`` and ``plan_hits == 0``,
  beside the JAX engine's ``offload_stats``;
* sampled rows: seeded, the noise advances every step, and a
  temperature of 1e-4 gives the greedy tokens;
* ``LaunchRecord``: calls inside ``recording()`` count only by replay.

Small size: 2 layers (zamba2 12), d_model 64, vocab 256, float32.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny

from repro.core import OffloadPolicy as JPolicy
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import OffloadPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.guard import kernel_guard
from repro_torch.models.transformer import ATTENTION_KINDS, layer_kinds
from repro_torch.serve import Engine, Request
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(1)

ATTENTION = "paged_decode_attention"


class StandInGraph:
    """``StepGraph`` on the CPU: a warm call that stands, a capture that
    leaves no trace in the buffers, replays counted from the record.
    ``fn`` is one of the engine's static functions (the decode step,
    admit for a bucket, the chunk, a control)."""

    def __init__(self, fn, device, pool=None):
        self.eng = eng = _engine_of(fn)
        warm = fn()                              # the warm call
        saved = [t.clone() for t in _buffers(eng)]
        with kernel_guard().recording() as self.launches:
            self.out = fn()                      # the capture
        for t, s in zip(_buffers(eng), saved):
            t.copy_(s)
        if self.out is not warm:
            self.out.copy_(warm)
        self.fn = fn

    def replay(self):
        with kernel_guard().recording():         # no wrapper runs
            self.out.copy_(self.fn())            # into the graph's output
        if self.fn == self.eng._static_step:
            self.eng._logits = self.out          # no Python ran
        self.launches.replay()


def _engine_of(fn):
    """The engine a static function belongs to (a bound method, or a
    partial of one)."""
    return getattr(fn, "__self__", None) or fn.func.__self__


def _buffers(eng) -> list:
    """Every fixed buffer of the static functions."""
    return [*eng._state.values(), eng._tables, eng._poison, eng._noise,
            eng._emit, eng._inputs, eng._prefill_logits,
            *[t for layer in eng.cache for t in layer.values()]]


@pytest.fixture(autouse=True)
def counted_attention(monkeypatch):
    """The plain paged attention counts a launch as its kernel's wrapper
    does; the engine's capture goes through ``StandInGraph``."""
    plain = ops.paged_decode_attention_plain

    def counted(*a, **kw):
        out = plain(*a, **kw)
        kernel_guard().count_launch(ATTENTION)
        return out

    monkeypatch.setattr(ops, "paged_decode_attention_plain", counted)
    monkeypatch.setattr(engine_mod, "StepGraph", StandInGraph)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _graph_engine(cfg, params, **kw) -> Engine:
    eng = Engine(cfg, params, device="cpu", **kw)
    eng._capture = True        # what a CUDA device sets
    return eng


def _weights(arch="qwen3-1.7b", layers=2, **over):
    jcfg = tiny(arch, num_layers=layers, **over)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               num_layers=layers, **over)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def qwen():
    return _weights()


def _rand_prompts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _ramp_prompts(lens):
    return [np.arange(3, 3 + n, dtype=np.int32) % 250 for n in lens]


def _traced(engine, reqs):
    traj, step = [], engine.step

    def traced():
        out = step()
        traj.append(engine.pool.used_pages)
        return out

    engine.step = traced
    return engine.generate(reqs), traj


#: (arch, layers, config overrides, prompts, new tokens, engine kwargs),
#: the paths of ``test_torch_serve.py`` / ``test_torch_zoo.py``
CASES = {
    "churn": ("qwen3-1.7b", 2, {}, _rand_prompts(6, 5, 24, 0), 6,
              dict(slots=2, max_len=48, page_size=8)),
    "chunked": ("qwen3-1.7b", 2, {}, _ramp_prompts((21, 13, 30)), 6,
                dict(slots=2, max_len=64, page_size=8, prefill_chunk=8)),
    "preemption": ("qwen3-1.7b", 2, {}, _ramp_prompts((21, 15, 30)), 10,
                   dict(slots=3, max_len=64, page_size=8, num_pages=7)),
    "sliding_window": ("qwen3-1.7b", 2, {"sliding_window": 8},
                       [np.arange(2, 2 + n, dtype=np.int32)
                        for n in (6, 11, 4)], 8,
                       dict(slots=2, max_len=32, page_size=4)),
    "mha": ("deepseek-7b", 2, {}, _rand_prompts(4, 4, 20, 3), 5,
            dict(slots=2, max_len=32, page_size=4)),
    "zamba2": ("zamba2-1.2b", 12, {}, _rand_prompts(4, 4, 12, 3), 6,
               dict(slots=2, max_len=32, page_size=8)),
    "rwkv6": ("rwkv6-1.6b", 2, {}, _rand_prompts(4, 4, 12, 3), 6,
              dict(slots=2, max_len=32, page_size=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graph_driven_step_matches_jax_engine(case, qwen):
    arch, layers, over, prompts, new, kw = CASES[case]
    jcfg, jparams, tcfg, tparams = qwen if case in (
        "churn", "chunked", "preemption") else _weights(arch, layers, **over)
    want, jtraj = _traced(JEngine(jcfg, jparams, **kw), [
        JRequest(p, max_new_tokens=new, rid=i) for i, p in enumerate(prompts)])
    eng = _graph_engine(tcfg, tparams, **kw)
    got, traj = _traced(eng, [Request(p, max_new_tokens=new, rid=i)
                              for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].status == want[i].status == "ok"
        assert got[i].tokens == want[i].tokens, i
    assert traj == jtraj
    assert eng.pool.used_pages == 0
    assert isinstance(eng._graph, StandInGraph)
    assert eng.serve_counters["step_traces"] == 1
    attn = sum(k in ATTENTION_KINDS for k in layer_kinds(tcfg))
    assert ops.launch_counts()[ATTENTION] == eng.decode_steps * attn
    if case == "preemption":
        assert eng.serve_counters["preemptions"] > 0


def _churn(n=24, new=4, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=rng.integers(5, 8)).astype(np.int32)
            for _ in range(n)], new


@pytest.mark.parametrize("capture", [False, True],
                         ids=["eager", "stand-in graph"])
def test_fixed_buffers_keep_their_storage_under_churn(capture, qwen):
    """24 requests through 2 slots: the static step reads and writes the
    same storage throughout, and is built once."""
    _, _, tcfg, tparams = qwen
    kw = dict(slots=2, max_len=32, page_size=8)
    eng = _graph_engine(tcfg, tparams, **kw) if capture else \
        Engine(tcfg, tparams, device="cpu", **kw)
    ptrs = [t.data_ptr() for t in _buffers(eng)]
    prompts, new = _churn()
    done = eng.generate([Request(p, max_new_tokens=new, rid=i)
                         for i, p in enumerate(prompts)])
    assert all(len(done[i].tokens) == new for i in range(len(prompts)))
    assert [t.data_ptr() for t in _buffers(eng)] == ptrs
    assert eng.serve_counters["step_traces"] == 1
    assert (eng._graph is not None) == capture
    assert eng.decode_steps >= len(prompts) * new // 2
    assert ops.launch_counts()[ATTENTION] == eng.decode_steps * 2


def test_each_step_leaves_the_eager_engines_logits(qwen):
    """``_logits`` after every step — the graph's output once captured,
    which holds the warm step's values until the first replay — equals
    the eager engine's, step for step."""
    _, _, tcfg, tparams = qwen
    prompts = _rand_prompts(4, 5, 12, 5)
    kw = dict(slots=2, max_len=48, page_size=8)
    got = {}
    for capture in (False, True):
        eng = _graph_engine(tcfg, tparams, **kw) if capture else \
            Engine(tcfg, tparams, device="cpu", **kw)
        logits, step = [], eng.step

        def keeping(eng=eng, logits=logits, step=step):
            n = eng.decode_steps
            out = step()
            if eng.decode_steps > n:
                logits.append(eng._logits.clone())
            return out

        eng.step = keeping
        eng.generate([Request(p, max_new_tokens=5, rid=i)
                      for i, p in enumerate(prompts)])
        got[capture] = logits
    assert len(got[True]) == len(got[False]) > 2
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)


def test_guard_epoch_change_rebuilds_the_step_once(qwen):
    _, _, tcfg, tparams = qwen
    kw = dict(slots=2, max_len=48, page_size=8)
    prompts = _rand_prompts(4, 5, 12, 2)
    reqs = [Request(p, max_new_tokens=6, rid=i) for i, p in enumerate(prompts)]
    want = _graph_engine(tcfg, tparams, **kw).generate(reqs)
    eng = _graph_engine(tcfg, tparams, **kw)
    guard, step, graphs = kernel_guard(), eng.step, []

    def bumping():
        if eng.decode_steps == 3:
            guard.epoch += 1
        out = step()
        graphs.append(eng._graph)
        return out

    eng.step = bumping
    epoch = guard.epoch
    ops.reset_launch_counts()
    try:
        got = eng.generate([Request(p, max_new_tokens=6, rid=i)
                            for i, p in enumerate(prompts)])
    finally:
        guard.epoch = epoch
    assert {i: c.tokens for i, c in got.items()} == \
        {i: c.tokens for i, c in want.items()}
    assert eng.serve_counters["step_traces"] == 2
    assert eng.serve_counters["kernel_replans"] == 1
    assert len({id(g) for g in graphs if g is not None}) == 2
    assert ops.launch_counts()[ATTENTION] == eng.decode_steps * 2


def test_offloaded_step_plans_once_like_the_jax_engine(qwen):
    """The plan is bound once, when the step is built: the JAX engine's
    zero-retrace steady state, counter for counter."""
    jcfg, jparams, tcfg, tparams = qwen
    prompts, new = _churn(n=8)
    kw = dict(slots=2, max_len=32, page_size=8)
    jeng = JEngine(jcfg, jparams, offload_policy=JPolicy(bulk_threshold=32),
                   **kw)
    want = jeng.generate([JRequest(p, max_new_tokens=new, rid=i)
                          for i, p in enumerate(prompts)])
    eng = _graph_engine(tcfg, tparams,
                        offload_policy=OffloadPolicy(bulk_threshold=32), **kw)
    got = eng.generate([Request(p, max_new_tokens=new, rid=i)
                        for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].tokens == want[i].tokens, i
    keys = ("plan_misses", "traces", "plan_hits")
    assert {k: eng.offload_stats[k] for k in keys} == \
        {k: jeng.offload_stats[k] for k in keys} == \
        {"plan_misses": 1, "traces": 1, "plan_hits": 0}
    assert eng.serve_counters["step_traces"] == 1
    assert jeng.serve_stats["step_traces"] == 1
    # introspection does not count, and prepare_decode binds the plan as
    # the first step would
    assert eng.explain_decode().n_fused == len(eng.decode_plan().segments)
    fresh = _graph_engine(tcfg, tparams,
                          offload_policy=OffloadPolicy(bulk_threshold=32),
                          **kw)
    assert fresh.prepare_decode() is fresh._decode_run.plan
    fresh.generate([Request(prompts[0], max_new_tokens=new, rid=0)])
    assert {k: fresh.offload_stats[k] for k in keys} == \
        {"plan_misses": 1, "traces": 1, "plan_hits": 0}


def test_sampled_rows_are_seeded_advance_and_cool_to_greedy(qwen):
    _, _, tcfg, tparams = qwen
    prompts = _rand_prompts(3, 5, 12, 7)
    kw = dict(slots=3, max_len=48, page_size=8)

    def run(seed, temps):
        eng = _graph_engine(tcfg, tparams, seed=seed, **kw)
        noise, step = [], eng.step

        def keeping():
            steps = eng.decode_steps
            out = step()
            if eng.decode_steps > steps:
                noise.append(eng._noise.clone())
            return out

        eng.step = keeping
        done = eng.generate([Request(p, max_new_tokens=8, temperature=t,
                                     rid=i)
                             for i, (p, t) in enumerate(zip(prompts, temps))])
        return [done[i].tokens for i in range(len(prompts))], noise

    greedy, _ = run(0, (0.0, 0.0, 0.0))
    a, noise = run(0, (1.0, 1e-4, 0.0))
    b, _ = run(0, (1.0, 1e-4, 0.0))
    c, _ = run(1, (1.0, 1e-4, 0.0))
    assert a == b                               # same seed, same draws
    assert a[0] != c[0]                         # another seed, other draws
    assert a[1] == greedy[1] and c[1] == greedy[1]   # T = 1e-4: greedy
    assert a[2] == greedy[2]                    # a greedy row beside them
    assert all(0 <= t < tcfg.vocab_size for t in a[0])
    # every step draws afresh (no replay reuses one draw)
    assert all(not torch.equal(x, y) for x, y in zip(noise, noise[1:]))


def test_launch_record_counts_once_per_replay():
    guard = kernel_guard()
    ops.reset_launch_counts()
    with guard.recording() as rec:
        guard.count_launch(ATTENTION)
        guard.count_launch(ATTENTION)
        guard.count_variant("fused_matmul_segment", "sym", "stream cp.async")
        with guard.recording() as inner:        # a nested capture
            guard.count_launch("rmsnorm")
        guard.count_launch("fused_segment_grid")
    assert ops.launch_counts()[ATTENTION] == 0
    assert guard.variants == {} and "sym" not in guard.last_variant
    for n in (1, 2, 3):
        rec.replay()
        counts = ops.launch_counts()
        assert counts[ATTENTION] == 2 * n
        assert counts["fused_segment_grid"] == n
        assert counts["rmsnorm"] == 0
        assert guard.variants[
            "fused_matmul_segment", "stream cp.async"] == n
    assert guard.last_variant["sym"] == "stream cp.async"
    inner.replay()
    assert ops.launch_counts()["rmsnorm"] == 1
    guard.count_launch(ATTENTION)               # outside: counted at once
    assert ops.launch_counts()[ATTENTION] == 7
    with pytest.raises(RuntimeError):
        with guard.recording():
            raise RuntimeError("capture failed")
    guard.count_launch(ATTENTION)               # recording ended
    assert ops.launch_counts()[ATTENTION] == 8
