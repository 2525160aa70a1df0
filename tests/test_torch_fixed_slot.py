"""The port's dense-cache ``FixedSlotEngine`` on the CPU, held against the
JAX ``FixedSlotEngine`` and the port's paged ``Engine``: the same weights
(``from_jax_params``) and prompts through each, greedy tokens equal
token for token, on the scenarios of ``tests/test_serve_paged.py`` that
the port's configs have (qwen3 across page boundaries, qwen3 with
``sliding_window=8``, deepseek-7b's MHA, zamba2, rwkv6) and qwen3
offloaded (``offload_stats`` equal to the JAX engine's: one plan, one
trace, no hit).  The decode step is also driven as a captured graph (a
stand-in with the CUDA graph's semantics: a capture that leaves no trace
in the fixed buffers, replays that rerun it): the same tokens,
``step_traces == 1``, and the fixed buffers keep their storage.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny

from repro.core import OffloadPolicy as JPolicy
from repro.models import build_model as jbuild
from repro.serve import Request as JRequest
from repro.serve.engine import FixedSlotEngine as JFixedSlotEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import OffloadPolicy
from repro_torch.serve import Engine, FixedSlotEngine, Request
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(1)


def _rand_prompts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


#: (arch, layers, config overrides, prompts, new tokens, slots, max_len,
#: page size of the paged engine)
CASES = {
    "page_boundaries": ("qwen3-1.7b", 2, {}, _rand_prompts(6, 5, 24, 0), 6,
                        2, 48, 8),
    "sliding_window": ("qwen3-1.7b", 2, {"sliding_window": 8},
                       [np.arange(2, 2 + n, dtype=np.int32)
                        for n in (6, 11, 4)], 8, 2, 32, 4),
    "mha": ("deepseek-7b", 2, {}, _rand_prompts(4, 4, 20, 3), 5, 2, 32, 4),
    "zamba2": ("zamba2-1.2b", 12, {}, _rand_prompts(4, 4, 12, 3), 6, 2, 32,
               8),
    "rwkv6": ("rwkv6-1.6b", 2, {}, _rand_prompts(4, 4, 12, 3), 6, 2, 32, 8),
}


#: each case's weights, built once for the module's tests
_WEIGHTS: dict = {}


def _weights(arch, layers, over):
    key = (arch, layers, tuple(sorted(over.items())))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = _build_weights(arch, layers, over)
    return _WEIGHTS[key]


def _build_weights(arch, layers, over):
    jcfg = tiny(arch, num_layers=layers, **over)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               num_layers=layers, **over)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


class StandInGraph:
    """``StepGraph`` on the CPU for the dense engine's step: a warm call
    that stands, a capture that leaves the fixed buffers as they were,
    replays that rerun the step into the capture's output."""

    def __init__(self, fn, device, pool=None):
        eng = fn.__self__
        warm = fn()
        bufs = [eng._inputs, eng._noise, eng._next,
                *[t for layer in eng.cache for t in layer.values()]]
        saved = [t.clone() for t in bufs]
        self.out = fn()
        for t, s in zip(bufs, saved):
            t.copy_(s)
        self.out.copy_(warm)
        self.fn, self.eng = fn, eng

    def replay(self):
        self.out.copy_(self.fn())
        self.eng._logits = self.out


def _requests(cls, prompts, new):
    return [cls(p, max_new_tokens=new, rid=i) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("case", list(CASES))
def test_fixed_slot_matches_jax_and_paged(case):
    arch, layers, over, prompts, new, slots, max_len, page = CASES[case]
    jcfg, jparams, tcfg, tparams = _weights(arch, layers, over)
    want = JFixedSlotEngine(jcfg, jparams, slots=slots, max_len=max_len
                            ).generate(_requests(JRequest, prompts, new))
    eng = FixedSlotEngine(tcfg, tparams, slots=slots, max_len=max_len,
                          device="cpu")
    got = eng.generate(_requests(Request, prompts, new))
    paged = Engine(tcfg, tparams, slots=slots, max_len=max_len,
                   page_size=page, device="cpu").generate(
        _requests(Request, prompts, new))
    for i in range(len(prompts)):
        assert got[i].tokens == want[i].tokens == paged[i].tokens, i
        assert len(got[i].tokens) == new
    assert not eng.active.any()
    assert eng.serve_counters["step_traces"] == 1
    assert eng.serve_counters["admit_traces"] == len(
        {len(p) for p in prompts})
    assert eng.offload_stats is None and eng.explain_decode() is None


def test_offloaded_fixed_slot_matches_jax_offloaded():
    arch, layers, over, prompts, new, slots, max_len, page = \
        CASES["page_boundaries"]
    jcfg, jparams, tcfg, tparams = _weights(arch, layers, over)
    jeng = JFixedSlotEngine(jcfg, jparams, slots=slots, max_len=max_len,
                            offload_policy=JPolicy(bulk_threshold=32))
    want = jeng.generate(_requests(JRequest, prompts, new))
    eng = FixedSlotEngine(tcfg, tparams, slots=slots, max_len=max_len,
                          device="cpu",
                          offload_policy=OffloadPolicy(bulk_threshold=32))
    got = eng.generate(_requests(Request, prompts, new))
    paged = Engine(tcfg, tparams, slots=slots, max_len=max_len,
                   page_size=page, device="cpu",
                   offload_policy=OffloadPolicy(bulk_threshold=32)).generate(
        _requests(Request, prompts, new))
    for i in range(len(prompts)):
        assert got[i].tokens == want[i].tokens == paged[i].tokens, i
    keys = ("plan_misses", "traces", "plan_hits")
    assert {k: eng.offload_stats[k] for k in keys} == \
        {k: jeng.offload_stats[k] for k in keys} == \
        {"plan_misses": 1, "traces": 1, "plan_hits": 0}
    plan = eng.decode_plan()
    assert any(s.matmul is not None for s in plan.segments)
    assert eng.explain_decode().n_fused == len(plan.segments)
    assert plan.verify() == []


@pytest.mark.parametrize("offload", [False, True], ids=["plain", "offload"])
def test_captured_step_matches_eager(offload, monkeypatch):
    arch, layers, over, prompts, new, slots, max_len, _ = \
        CASES["page_boundaries"]
    _, _, tcfg, tparams = _weights(arch, layers, over)
    kw = dict(slots=slots, max_len=max_len, device="cpu",
              offload_policy=OffloadPolicy(bulk_threshold=32)
              if offload else None)
    want = FixedSlotEngine(tcfg, tparams, **kw).generate(
        _requests(Request, prompts, new))
    monkeypatch.setattr(engine_mod, "StepGraph", StandInGraph)
    eng = FixedSlotEngine(tcfg, tparams, **kw)
    eng._capture = True
    ptrs = [eng._inputs.data_ptr(), eng._next.data_ptr(),
            eng.cache[0]["k"].data_ptr()]
    got = eng.generate(_requests(Request, prompts, new))
    for i in range(len(prompts)):
        assert got[i].tokens == want[i].tokens, i
    assert isinstance(eng._graph, StandInGraph)
    assert eng.serve_counters["step_traces"] == 1
    assert ptrs == [eng._inputs.data_ptr(), eng._next.data_ptr(),
                    eng.cache[0]["k"].data_ptr()]
    if offload:
        assert (eng.offload_stats["plan_misses"],
                eng.offload_stats["plan_hits"]) == (1, 0)


def test_sampled_rows_draw_fresh_noise_and_cool_to_greedy():
    arch, layers, over, prompts, new, slots, max_len, _ = \
        CASES["page_boundaries"]
    _, _, tcfg, tparams = _weights(arch, layers, over)
    greedy = FixedSlotEngine(tcfg, tparams, slots=slots, max_len=max_len,
                             device="cpu").generate(
        _requests(Request, prompts[:2], new))

    def run(seed, temp):
        eng = FixedSlotEngine(tcfg, tparams, slots=slots, max_len=max_len,
                              device="cpu", seed=seed)
        return eng.generate([Request(p, max_new_tokens=new, rid=i,
                                     temperature=temp)
                             for i, p in enumerate(prompts[:2])])

    assert {i: c.tokens for i, c in run(0, 1e-4).items()} == \
        {i: c.tokens for i, c in greedy.items()}
    a, b, c = run(1, 5.0), run(1, 5.0), run(2, 5.0)
    assert {i: x.tokens for i, x in a.items()} == \
        {i: x.tokens for i, x in b.items()}
    assert {i: x.tokens for i, x in a.items()} != \
        {i: x.tokens for i, x in c.items()}
