"""The port's static plan verifier (``repro_torch.analysis``) held against
the reference's (``repro.analysis``), on the CPU.

Each scenario of ``tests/test_analysis.py`` runs on the port's plan of
the same function: clean elementwise, GEMM + gradient and flash plans
prove out; the ``verified`` column renders; a plan applied to another
graph fails its fingerprint; and each mutation (aliasing a live buffer,
donating the weight stream, breaking an operand's tiling, fusing a far
op, dropping a segment, an accumulator budget beyond the card) fires the
same rule id in both packages on the same mutation of each package's own
plan.  The enforcement surfaces (``verify_plans``, ``MPU_VERIFY_PLANS``,
``wrapped.verify``, the ``"verified"`` meta of a persisted plan,
``PlanVerificationError``), the paged-table rules against the reference's
findings on the same tables (and the engines' ``verify_paged_tables``),
the kernels' interior-broadcast row maps against numpy broadcasting,
``lint --arch`` for every port config, ``launch.inputs``' abstract
inputs against the reference's, and the shared memory the generated
anchored segments launch with equal to the verifier's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny

import repro.analysis as janalysis
from repro.analysis.verifier import _bcast_reference_row as j_bcast_row
from repro.core import offload_report as j_offload_report
from repro.core.offload import OperandSpec as JOperandSpec
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch.analysis import (
    PlanVerificationError,
    has_errors,
    max_severity,
    verify_paged_decode,
    verify_plan,
)
from repro_torch.analysis import lint
from repro_torch.analysis.verifier import _bcast_reference_row
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import OffloadPolicy
from repro_torch.core import offload as offload_mod
from repro_torch.core.offload import OperandSpec, mpu_offload, offload_report
from repro_torch.kernels.codegen import bcast_row_of
from repro_torch.kernels.fused_elementwise import _bcast_row_index
from repro_torch.serve import Engine, Request

torch.set_num_threads(1)

POLICY = OffloadPolicy(bulk_threshold=64)


def _rules(findings):
    return {f.rule for f in findings if f.severity == "error"}


def _plans(tfn, jfn, *shapes, dtypes=None):
    """The port's and the reference's plans of one function on zeros of
    ``shapes`` (f32, or ``dtypes``)."""
    dtypes = dtypes or [np.float32] * len(shapes)
    arrs = [np.zeros(s, dt) for s, dt in zip(shapes, dtypes)]
    tplan = offload_report(tfn, *map(torch.from_numpy, arrs), policy=POLICY)
    jplan = j_offload_report(jfn, *map(jnp.asarray, arrs), bulk_threshold=64)
    return tplan, jplan


def _ew_chain(x, y):
    h = torch.tanh(x) * 2.0 + y
    return h * torch.sigmoid(h)


def _jew_chain(x, y):
    h = jnp.tanh(x) * 2.0 + y
    return h * jax.nn.sigmoid(h)


def _ew_plans():
    return _plans(_ew_chain, _jew_chain, (64, 32), (64, 32))


def _both(mutate, tplan, jplan):
    """The same mutation on both plans; the error rules each verifier
    finds."""
    mutate(tplan, torch)
    mutate(jplan, jax)
    return _rules(verify_plan(tplan)), _rules(janalysis.verify_plan(jplan))


# ---------------------------------------------------------------- clean plans
def test_clean_elementwise_plan_verifies():
    tplan, jplan = _ew_plans()
    assert tplan.segments and jplan.segments
    assert not has_errors(verify_plan(tplan))
    assert not has_errors(janalysis.verify_plan(jplan))


def test_clean_gemm_and_grad_plans_verify():
    tplan, _ = _plans(lambda x, w: torch.tanh(x @ w) * 2.0,
                      lambda x, w: jnp.tanh(x @ w) * 2.0, (128, 64), (64, 64))
    assert any(s.matmul is not None for s in tplan.segments)
    assert verify_plan(tplan) == []

    def gemm_bwd(g, x, w):
        dx = torch.tanh(g @ w.t()) * 0.5 + x * 0.1
        return dx, x.t() @ g + 0.01 * w

    gplan = offload_report(gemm_bwd, torch.zeros(512, 256),
                           torch.zeros(512, 256), torch.zeros(256, 256),
                           policy=POLICY)
    forms = {s.matmul.form for s in gplan.segments if s.matmul is not None}
    assert {"dlhs", "drhs"} <= forms
    assert not has_errors(verify_plan(gplan))


def test_clean_flash_plan_verifies():
    def attn(q, k, v):
        s = torch.einsum("bhsd,bhtd->bhst", q, k) / 8.0
        return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1), v)

    shape = (2, 4, 128, 64)
    plan = offload_report(attn, *(torch.zeros(shape) for _ in range(3)),
                          policy=POLICY)
    assert any(s.matmul is not None and s.matmul.flash is not None
               for s in plan.segments)
    assert verify_plan(plan) == []


def test_explain_renders_verified_column():
    tplan, _ = _ew_plans()
    text = str(tplan.report())
    assert "verified" in text.splitlines()[1]
    assert [d.verified for d in tplan.report().decisions] == ["ok"]


def test_fingerprint_mismatch_is_detected():
    tplan, _ = _ew_plans()
    other = offload_report(lambda x, w: torch.tanh(x @ w) * 2.0,
                           torch.zeros(128, 64), torch.zeros(64, 64),
                           policy=POLICY)
    assert not has_errors(tplan.verify(tplan.annotation.graph))
    assert "plan-fingerprint" in _rules(
        verify_plan(tplan, other.annotation.graph))


# ------------------------------------------------------------------ mutations
def test_mutation_alias_of_live_buffer():
    """Donating an input that is also a program output: both packages
    find ``alias-live``."""
    def mutate(plan, lib):
        seg = plan.segments[0]
        bi = next(i for i, s in enumerate(seg.operand_specs)
                  if s.role == "bulk")
        seg.donations = [(bi, 0)]

    got, want = _both(mutate, *_plans(
        lambda x: (torch.tanh(x) * 2.0 + 1.0, x),
        lambda x: (jnp.tanh(x) * 2.0 + 1.0, x), (64, 32)))
    assert "alias-live" in got and "alias-live" in want


def test_mutation_kaxis_race():
    """The weight stream smuggled into the donation list: each package
    finds the race on its own kernel's schedule (the port's: the output
    tiles written in the tile while other row tiles' CTAs still read the
    weight)."""
    def mutate(plan, lib):
        seg = next(s for s in plan.segments if s.matmul is not None)
        mm = seg.matmul
        spec = OperandSpec if lib is torch else JOperandSpec
        seg.operand_specs = seg.operand_specs + [spec(mm.rhs, "bulk", 512,
                                                      8192)]
        seg.donations = [(len(seg.operand_specs) - 1, 0)]

    tplan, jplan = _plans(lambda x, w: torch.tanh(x @ w) * 2.0,
                          lambda x, w: jnp.tanh(x @ w) * 2.0,
                          (512, 512), (512, 8192))
    got, want = _both(mutate, tplan, jplan)
    assert "alias-kaxis-race" in got and "alias-kaxis-race" in want


def test_mutation_broken_block_tiling():
    def mutate(plan, lib):
        seg = plan.segments[0]
        sp = seg.operand_specs[0]
        seg.operand_specs[0] = dataclasses.replace(sp, cols=sp.cols * 2)

    got, want = _both(mutate, *_ew_plans())
    assert "index-bounds" in got and "index-bounds" in want


def test_mutation_far_prim_in_segment():
    def mutate(plan, lib):
        seg = plan.segments[0]
        name = "index" if lib is torch else "gather"
        eqns = plan.eqns if lib is torch else plan.annotation.jaxpr.jaxpr.eqns
        gi = next(i for i, e in enumerate(eqns)
                  if (e.target.name().partition("::")[2].split(".")[0]
                      if lib is torch else e.primitive.name) == name)
        seg.eqn_idx = seg.eqn_idx + [gi]

    got, want = _both(mutate, *_plans(
        lambda x, idx: (torch.tanh(x) * 2.0 + 1.0)[idx.long()],
        lambda x, idx: (jnp.tanh(x) * 2.0 + 1.0)[idx], (64, 32), (8,),
        dtypes=[np.float32, np.int32]))
    assert "far-prim-in-segment" in got and "far-prim-in-segment" in want


def test_mutation_missing_segment_is_decision_drift():
    tplan, jplan = _ew_plans()
    got, want = _both(lambda plan, lib: plan.segments.pop(), tplan, jplan)
    assert "decision-drift" in got and "decision-drift" in want
    assert "MISSING-SEGMENT" in str(tplan.report())


def test_mutation_budget_beyond_the_card():
    """An accumulator budget corrupted to 2^40 bytes lets the anchored
    kernel take a row block whose f32 tile the card cannot hold (the
    reference: beyond physical VMEM) — an error in both packages, where
    the planned plan has none."""
    tplan, jplan = _plans(lambda x, w: torch.tanh(x @ w) * 2.0,
                          lambda x, w: jnp.tanh(x @ w) * 2.0,
                          (512, 256), (256, 65536))
    assert not has_errors(verify_plan(tplan))
    assert not has_errors(janalysis.verify_plan(jplan))

    def mutate(plan, lib):
        seg = next(s for s in plan.segments
                   if s.matmul is not None and s.matmul.form == "fwd")
        if lib is torch:
            seg.smem_budget = 1 << 40
        else:
            seg.vmem_bytes = 1 << 40

    got, want = _both(mutate, tplan, jplan)
    assert "vmem-accumulator" in got and "vmem-accumulator" in want


# ------------------------------------------------------- enforcement surfaces
def test_verify_plans_wrapper_and_accessors(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    xn, yn = (rng.standard_normal((64, 32)).astype(np.float32)
              for _ in range(2))
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    wrapped = mpu_offload(_ew_chain, policy=POLICY, verify_plans=True,
                          persist_dir=tmp_path)
    np.testing.assert_allclose(wrapped(x, y).numpy(),
                               np.asarray(_jew_chain(xn, yn)),
                               rtol=1e-5, atol=1e-5)
    assert wrapped.verify_plans
    assert not has_errors(wrapped.verify(x, y))
    metas = [json.loads(p.read_text())["meta"] for p in tmp_path.glob("*.ok")]
    assert metas and all(m["verified"] is True for m in metas)
    monkeypatch.setenv("MPU_VERIFY_PLANS", "1")
    assert mpu_offload(_ew_chain).verify_plans
    monkeypatch.setenv("MPU_VERIFY_PLANS", "0")
    assert not mpu_offload(_ew_chain).verify_plans

    # a planner that emits a broken plan: the wrapper refuses to run it,
    # and the plan loaded from the store is verified again
    real = offload_mod.plan_offload

    def broken(gm, policy=None, **kw):
        plan = real(gm, policy=policy, **kw)
        sp = plan.segments[0].operand_specs[0]
        plan.segments[0].operand_specs[0] = dataclasses.replace(
            sp, cols=sp.cols * 2)
        return plan

    monkeypatch.setattr(offload_mod, "plan_offload", broken)
    with pytest.raises(PlanVerificationError, match="index-bounds"):
        mpu_offload(_ew_chain, policy=POLICY, verify_plans=True)(x, y)
    with pytest.raises(RuntimeError, match="invalid"):  # unverified: runs
        mpu_offload(_ew_chain, policy=POLICY)(x, y)
    store = tmp_path / "second"
    mpu_offload(_ew_chain, policy=POLICY, persist_dir=store).warm(x, y)
    loaded = mpu_offload(_ew_chain, policy=POLICY, persist_dir=store,
                         verify_plans=True)
    with pytest.raises(PlanVerificationError):
        loaded(x, y)
    assert loaded.stats.disk_hits == 1


def test_verification_error_carries_findings():
    tplan, _ = _ew_plans()
    seg = tplan.segments[0]
    sp = seg.operand_specs[0]
    seg.operand_specs[0] = dataclasses.replace(sp, cols=sp.cols * 2)
    findings = verify_plan(tplan)
    assert max_severity(findings) == "error"
    err = PlanVerificationError([f for f in findings
                                 if f.severity == "error"])
    assert "index-bounds" in str(err) and err.findings


# --------------------------------------------------------- paged decode tables
PAGED_CASES = {
    "clean": (np.arange(32, dtype=np.int32).reshape(4, 8) % 16,
              np.array([0, 5, 64, 17], np.int32)),
    "out_of_range": (np.where(np.arange(32).reshape(4, 8) == 11, 99, 0
                              ).astype(np.int32), np.zeros((4,), np.int32)),
    "many_out_of_range": (np.full((4, 8), -1, np.int32),
                          np.zeros((4,), np.int32)),
    "too_long": (np.zeros((4, 8), np.int32),
                 np.array([0, 0, 100, 0], np.int32)),
    "not_2d": (np.zeros((32,), np.int32), np.zeros((4,), np.int32)),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_tables_match_the_reference(case):
    tables, lengths = PAGED_CASES[case]
    got = verify_paged_decode(tables, lengths, num_pages=16, page_size=8)
    want = janalysis.verify_paged_decode(tables, lengths, num_pages=16,
                                         page_size=8)
    key = [(f.rule, f.severity, f.segment) for f in got]
    assert key == [(f.rule, f.severity, f.segment) for f in want]
    assert (case == "clean") == (got == [])


def test_engine_verify_paged_tables_mid_flight():
    """Both engines mid-flight on the same requests: the same findings
    on their (equal) tables, none; a corrupted entry is found by both."""
    jcfg = tiny("qwen3-1.7b")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 250, size=n).astype(np.int32)
               for n in (9, 17, 5)]
    kw = dict(slots=3, max_len=48, page_size=8)
    jeng, teng = JEngine(jcfg, jparams, **kw), Engine(tcfg, tparams,
                                                      device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(p, max_new_tokens=12, rid=i))
        teng.submit(Request(p, max_new_tokens=12, rid=i))
    for _ in range(4):
        jeng._pump(), teng._pump()
        jeng.step(), teng.step()
    np.testing.assert_array_equal(teng.pool.tables, jeng.pool.tables)
    assert teng.verify_paged_tables() == [] == jeng.verify_paged_tables()
    teng.pool.tables[1, -1] = jeng.pool.tables[1, -1] = teng.num_pages
    assert [f.rule for f in teng.verify_paged_tables()] == \
        [f.rule for f in jeng.verify_paged_tables()] == ["page-table-bounds"]


# ------------------------------------------ interior-broadcast row maps
def _bcast_patterns(n=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out_lead = tuple(int(d) for d in
                         rng.choice([1, 2, 3, 4], size=rng.integers(1, 4)))
        lead = tuple(d if rng.random() < 0.5 else 1 for d in out_lead)
        rb = int(rng.choice([d for d in (1, 2, 4) if out_lead[-1] % d == 0]))
        out.append((lead, out_lead, rb))
    return out


@pytest.mark.parametrize("pattern", _bcast_patterns(),
                         ids=lambda p: f"{p[0]}->{p[1]}/rb{p[2]}")
def test_bcast_row_maps_match_broadcasting(pattern):
    """B2's row expression (``bcast_row_of``, free of any row block) at
    every output row, and ``_bcast_row_index`` at every row block, read
    the row numpy broadcasting reads — by the port's reference and the
    JAX package's."""
    lead, out_lead, rb = pattern
    rows, op_rows = int(np.prod(out_lead)), int(np.prod(lead))
    expr = compile(bcast_row_of(lead, out_lead, "grow"), "<row>", "eval")
    for r in range(rows):
        want = _bcast_reference_row(r, lead, out_lead)
        assert want == j_bcast_row(r, lead, out_lead)
        assert eval(expr, {"grow": r}) == want          # noqa: S307
    brows, fn = _bcast_row_index(lead, out_lead, rb)
    for i in range(rows // rb):
        bidx = fn(i)
        assert 0 <= bidx and (bidx + 1) * brows <= op_rows
        assert bidx * brows == _bcast_reference_row(i * rb, lead, out_lead)


# ---------------------------------------------------------------------- lint
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lint_arch_exits_zero(arch, capsys):
    assert lint.main(["--arch", arch]) == 0
    out = capsys.readouterr().out
    assert f"ok    {arch}:fwd" in out and f"ok    {arch}:grad" in out



# ------------------------------------------------------- abstract inputs
@pytest.mark.parametrize("kind", ["batch", "prefill", "decode"])
def test_input_specs_match_the_reference(kind):
    """``launch.inputs``: the reference's ShapeDtypeStructs as meta
    tensors (and as fake tensors of a given mode), nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    import repro.launch.inputs as jinputs
    from repro.configs import ShapeConfig as JShape, get_config as jget
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import inputs

    shape = ShapeConfig("lint", seq_len=128, global_batch=2)
    jshape = JShape("lint", seq_len=128, global_batch=2)
    for arch in ARCH_IDS:
        got = getattr(inputs, f"{kind}_specs")(get_config(arch), shape)
        want = getattr(jinputs, f"{kind}_specs")(jget(arch), jshape)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
    mode = FakeTensorMode()
    fake = getattr(inputs, f"{kind}_specs")(get_config(ARCH_IDS[0]), shape,
                                            fake_mode=mode)
    assert all(isinstance(t, FakeTensor) for t in fake.values())


# ------------------------------------------- shared memory, one helper
@pytest.mark.parametrize("rows", [8, 256], ids=["stream", "sm90"])
def test_generated_segments_carry_the_verifiers_shared_memory(rows):
    """A bf16 anchored segment's generated code sets and launches with
    ``S::SMEM``, the value the verifier reads (``segment_smem``), and
    exports the read-back probe; the helpers give what the launchers'
    attribute read back on the H100 (``chip_smoke.py``: 197,696 /
    197,728 B for the sm90 ring at tn 256 / 128, 165,888 B for B5 at
    head dim 128 in bf16)."""
    from repro_torch.analysis import segment_smem
    from repro_torch.core.offload import _matmul_gen, segment_call
    from repro_torch.kernels import fused_matmul_bwd as fmb
    from repro_torch.kernels.flash_attention import fwd_smem_bytes

    plan = offload_report(lambda x, w: torch.tanh(x @ w) * 2.0,
                          torch.zeros(rows, 512, dtype=torch.bfloat16),
                          torch.zeros(512, 512, dtype=torch.bfloat16),
                          policy=POLICY)
    seg = next(s for s in plan.segments if s.matmul is not None)
    gen = _matmul_gen(segment_call(plan.eqns, seg))
    path = "stream" if rows == 8 else "sm90"
    assert gen["path"] == path
    want = fmb.stream_smem_bytes(gen["kch"]) if path == "stream" else \
        fmb.sm90_smem_bytes(gen["tn"])
    assert gen["smem"] == want == segment_smem(plan.eqns, seg)[path]
    assert f"SMEM = {want};" in gen["source"]
    assert f'int {gen["name"]}_smem(void)' in gen["source"]
    assert not has_errors(verify_plan(plan))
    assert (fmb.sm90_smem_bytes(256), fmb.sm90_smem_bytes(128)) == \
        (197_696, 197_728)
    assert fwd_smem_bytes(128, torch.bfloat16) == 165_888
