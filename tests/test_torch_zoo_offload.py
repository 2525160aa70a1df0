"""The offloaded paged ``Engine`` of the hybrid Mamba2 stack (zamba2) and
RWKV6 in the port, on the CPU, held against the JAX offloaded ``Engine``
(``OffloadPolicy(bulk_threshold=32)`` on both): the same weights
(``from_jax_params``) and prompts through each.

* greedy tokens and the page trajectory equal, with the decode step
  driven as a captured graph (``test_torch_serve_graph.StandInGraph``)
  and eagerly, and ``offload_stats`` equal to the JAX engine's
  (``plan_misses == traces == 1``, ``plan_hits == 0``);
* one plan over a churn of 24 requests through 2 slots;
* ``explain_decode`` / ``decode_plan``: anchored and grid segments, every
  fused row verified, the plan free of verifier errors, one weight for
  the tied shared-attention block's positions;
* an injected B2 fault quarantined mid-run, through
  ``Engine(fault_injector=...)``: the step is rebuilt with all_far plans
  (``kernel_replans``) and every request still gets the tokens the
  unfaulted engine gives.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny
from test_torch_serve_graph import StandInGraph

from repro.core import OffloadPolicy as JPolicy
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch.analysis import has_errors
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import OffloadPolicy, artifacts
from repro_torch.kernels import guard as guard_mod
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import layer_kinds
from repro_torch.serve import Engine, FaultConfig, FaultInjector, Request
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(1)

CASES = {"zamba2": ("zamba2-1.2b", 12), "rwkv6": ("rwkv6-1.6b", 2)}
KW = dict(slots=2, max_len=32, page_size=8)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    arch, layers = CASES[request.param]
    jcfg = tiny(arch, num_layers=layers)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               num_layers=layers)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return request.param, jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jax_run(pair):
    """The JAX offloaded engine's completions, page trajectory and plan
    counters on ``_prompts(4)``, once per model."""
    _, jcfg, jparams, _, _ = pair
    jeng = JEngine(jcfg, jparams, offload_policy=JPolicy(bulk_threshold=32),
                   **KW)
    want, jtraj = _traced(jeng, [JRequest(p, max_new_tokens=6, rid=i)
                                 for i, p in enumerate(_prompts(4))])
    return want, jtraj, jeng.offload_stats


@pytest.fixture(autouse=True)
def fresh_guard(monkeypatch):
    monkeypatch.setattr(guard_mod, "_GUARD", guard_mod.KernelGuard())
    monkeypatch.setattr(artifacts, "_DISK_INJECTOR", None)


def _prompts(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=rng.integers(4, 12)).astype(np.int32)
            for _ in range(n)]


def _engine(tcfg, tparams, **kw):
    return Engine(tcfg, tparams, device="cpu",
                  offload_policy=OffloadPolicy(bulk_threshold=32), **KW, **kw)


def _traced(engine, reqs):
    traj, step = [], engine.step

    def traced():
        out = step()
        traj.append(engine.pool.used_pages)
        return out

    engine.step = traced
    return engine.generate(reqs), traj


@pytest.mark.parametrize("captured", [True, False],
                         ids=["captured", "eager"])
def test_offloaded_engine_matches_jax_offloaded_engine(pair, jax_run,
                                                       captured, monkeypatch):
    _, _, _, tcfg, tparams = pair
    prompts = _prompts(4)
    want, jtraj, jstats = jax_run
    if captured:
        monkeypatch.setattr(engine_mod, "StepGraph", StandInGraph)
    eng = _engine(tcfg, tparams)
    eng._capture = captured
    got, traj = _traced(eng, [Request(p, max_new_tokens=6, rid=i)
                              for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].status == want[i].status == "ok"
        assert got[i].tokens == want[i].tokens, i
    assert traj == jtraj
    assert isinstance(eng._graph, StandInGraph) == captured
    keys = ("plan_misses", "traces", "plan_hits")
    assert {k: eng.offload_stats[k] for k in keys} == \
        {k: jstats[k] for k in keys} == \
        {"plan_misses": 1, "traces": 1, "plan_hits": 0}
    assert eng.serve_counters["step_traces"] == 1


def test_one_plan_under_churn(pair):
    """24 requests through 2 slots: the plan is looked up once, when the
    step is built, whatever the admission churn."""
    _, _, _, tcfg, tparams = pair
    eng = _engine(tcfg, tparams)
    reqs = [Request(p, max_new_tokens=3, rid=i)
            for i, p in enumerate(_prompts(24, seed=1))]
    done = eng.generate(reqs)
    assert all(len(done[r.rid].tokens) == 3 for r in reqs)
    st = eng.offload_stats
    assert (st["plan_misses"], st["traces"], st["plan_hits"]) == (1, 1, 0)
    assert eng.serve_counters["step_traces"] == 1
    assert eng.pool.used_pages == 0


def test_explain_and_plan_of_the_recurrent_decode(pair):
    name, _, _, tcfg, tparams = pair
    eng = _engine(tcfg, tparams)
    plan = eng.decode_plan()
    report = eng.explain_decode()
    anchored = [s for s in plan.segments if s.matmul is not None]
    grid = [s for s in plan.segments if s.matmul is None]
    assert anchored and grid
    assert report.n_fused == len(plan.segments)
    assert {d.verified for d in report.decisions if d.fused} == {"ok"}
    assert not has_errors(plan.verify())
    # the captured step holds one weight per tensor: the tied block's
    # positions read one placeholder each of the same stored tensor
    if name == "zamba2":
        kinds = layer_kinds(tcfg)
        shared = [i for i, k in enumerate(kinds) if k == "shared_attention"]
        wq = [eng.params["layers"][i]["attn"]["wq"] for i in shared]
        assert len(shared) == 2 and wq[0] is wq[1]
        anchored_w = {s.matmul.rhs.meta["val"].shape for s in anchored}
        assert tuple(wq[0].shape) in anchored_w


def test_quarantine_mid_run_replans_all_far(pair, monkeypatch):
    """An injected B2 fault, through ``Engine(fault_injector=...)``: from
    the fourth decode step B2's launches resolve to the kernel, as a CUDA
    tensor's do (on the CPU they take the plain version), the injector
    faults each (``kernel_fail_rate=1``), each demotes to the plain
    version, the guard quarantines B2 at its threshold, and the step is
    rebuilt once (``kernel_replans``) on an all_far plan; every request
    gets the unfaulted engine's tokens."""
    _, _, _, tcfg, tparams = pair
    prompts = _prompts(4)
    reqs = [Request(p, max_new_tokens=6, rid=i)
            for i, p in enumerate(prompts)]
    want = _engine(tcfg, tparams).generate(
        [dataclasses.replace(r) for r in reqs])
    inj = FaultInjector(FaultConfig(kernel_fail_rate=1.0, seed=0,
                                    kernel_targets=("fused_segment_grid",)))
    eng = _engine(tcfg, tparams, fault_injector=inj)
    g = guard_mod.kernel_guard()
    assert g.injector is inj
    dispatch = kops._dispatch

    def as_on_the_card(kernel, impl, t, launch, plain):
        if kernel == "fused_segment_grid" and eng.decode_steps >= 3:
            return g.run(kernel, "cuda",
                         lambda im: plain() if im == "ref" else launch())
        return dispatch(kernel, impl, t, launch, plain)

    monkeypatch.setattr(kops, "_dispatch", as_on_the_card)
    got = eng.generate(reqs)
    for i in range(len(prompts)):
        assert got[i].status == "ok"
        assert got[i].tokens == want[i].tokens, i
    assert inj.counters["kernel_faults"] == g.threshold
    assert g.is_quarantined("fused_segment_grid", "cuda")
    assert eng.serve_counters["kernel_replans"] == 1
    assert eng.serve_counters["step_traces"] == 2
    assert eng.decode_plan().policy.mode == "all_far"
    st = eng.offload_stats
    assert st["quarantines"] == 1 and st["kernel_failures"] == g.threshold
