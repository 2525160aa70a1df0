"""The Hopper mainloop of B4 (dlhs) and B6 (drhs) on the CPU: what can
be held without the card.  The kernel itself (``csrc/fused_matmul_sm90.
cuh``) runs only on an H100; ``chip_smoke.py`` phases 7 and 8 hold it
against the plain versions there.  Here:

- the geometry helper ``sm90_tiles`` and the predicate ``sm90_eligible``
  at the full-width training shapes of qwen3-1.7b and at the CPU tests'
  tiny ones;
- ``segment_source`` emitting the sm90 mainloop for bf16 dlhs / drhs
  segments (with and without an lhs prologue, with ``batch`` > 1), and
  the TMA / register-staged variants each can take;
- byte-identical source and symbol names for every f32 and f16
  segment, against digests of what the generator emitted before the
  mainloop existed (bf16 fwd segments: ``tests/test_torch_sm90_fwd.py``);
- ``Segment.io_bytes`` of a bf16 dlhs / drhs segment equal to what the
  helper's grid gives through ``operand_streams``;
- the backward plans of the tiny training step keeping their decisions.
"""
import dataclasses
import hashlib

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import (
    _matmul_gen,
    bwd_plans,
    clear_bwd_plans,
    offload_report,
    segment_call,
)
from repro_torch.data import SyntheticLM, make_data_config
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import fused_matmul_bwd as fmb
from repro_torch.models import build_model
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.step import device_batch

torch.set_num_threads(2)

H100_SMS = 132


def _t(gen, *shape, dtype, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).to(dtype)


def _chains(dtype):
    """(label, form, fn, args): small chains whose plans hold one
    anchored segment each, in every contraction form."""
    gen = torch.Generator().manual_seed(3)
    B, S, K, N = 2, 12, 40, 24

    def t(*shape, scale=1.0):
        return _t(gen, *shape, dtype=dtype, scale=scale)
    yield ("fwd gelu", "fwd", lambda x, w: F.gelu(x @ w, approximate="tanh"),
           (t(B * S, K), t(K, N, scale=K ** -0.5)))
    yield ("fwd lane reduce", "fwd",
           lambda x, w, y: (lambda h: h * torch.rsqrt(torch.mean(
               h * h, -1, keepdim=True) + 1e-5))(x @ w + y),
           (t(B * S, K), t(K, N, scale=K ** -0.5), t(B * S, N)))
    yield ("dlhs param/rep/tile", "dlhs",
           lambda g, w, p, r, q: (torch.tanh(g @ w.t()) * p + r) * q,
           (t(B, S, K), t(N, K, scale=K ** -0.5), t(N), t(B, 1, N),
            t(1, S, N)))
    yield ("dlhs lhs prologue, lane reduce", "dlhs",
           lambda g, s, w: (lambda h: h * torch.rsqrt(torch.mean(
               h * h, -1, keepdim=True) + 1e-5))((g * s) @ w.t()),
           (t(B * S, K), t(K), t(N, K, scale=K ** -0.5)))
    yield ("dlhs batch 2", "dlhs",
           lambda g, w, y: torch.tanh(torch.bmm(g, w.transpose(1, 2))) + y,
           (t(B, S, K), t(B, N, K, scale=K ** -0.5), t(B, S, N)))
    yield ("drhs bulk/param", "drhs",
           lambda x, g, w, b: ((x.t() @ g) * 0.5 + 0.01 * w) * b,
           (t(B * S, K), t(B * S, N), t(K, N), t(N)))
    yield ("drhs batch 2", "drhs",
           lambda x, g, w: torch.bmm(x.transpose(1, 2), g) + 0.01 * w,
           (t(B, S, K), t(B, S, N), t(B, K, N)))


def _anchored(fn, args):
    plan = offload_report(fn, *args, policy=OffloadPolicy(bulk_threshold=16))
    return [segment_call(plan.eqns, s) for s in plan.segments
            if s.matmul is not None]


def _digest(gen: dict) -> str:
    return hashlib.sha1(gen["source"].encode()).hexdigest()[:16]


def _emitted(dtypes=(torch.float32, torch.float16, torch.bfloat16)):
    """(label, dtype, form, gen) of every anchored segment of the chains."""
    out = []
    for dtype in dtypes:
        for label, form, fn, args in _chains(dtype):
            for call in _anchored(fn, args):
                out.append((label, str(dtype)[6:], call["form"],
                            _matmul_gen(call)))
    return out


def _training_plans(dtype: str) -> list:
    """The forward and backward plans of one offloaded step of the tiny
    2-layer qwen3 build (bf16 compute over f32 masters, or f32), as
    tests/test_torch_train.py plans them."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              dtype=dtype, num_layers=2)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0)
    batch = device_batch(SyntheticLM(make_data_config(
        cfg, ShapeConfig("s", 32, 4))).batch(0), "cpu")
    clear_bwd_plans()
    step = make_train_step(model, TrainConfig(remat=False), offload=True)
    fplan = step.loss_fn.warm(state.params, batch)
    step.loss_fn.warm_backward(state.params, batch)
    return [fplan, *bwd_plans()]


def _plan_summary(plans) -> dict:
    """(fused, form) -> decisions over the plans."""
    out: dict = {}
    for p in plans:
        for d in p.decisions:
            key = (d.fused, d.form or "grid")
            out[key] = out.get(key, 0) + 1
    return out


def _plan_gens(plans) -> dict:
    """symbol -> (form, generated code) of the plans' anchored segments."""
    out = {}
    for p in plans:
        for s in p.segments:
            if s.matmul is not None:
                gen = _matmul_gen(segment_call(p.eqns, s))
                out[gen["name"]] = (s.matmul.form, gen)
    return out


# ----------------------------------------------------------- geometry
@pytest.mark.parametrize("form,rows,k,n,batch,want", [
    # qwen3-1.7b, 2 x 1,024 tokens: MLP dx (gate / up) and dW
    ("dlhs", 2048, 6144, 2048, 1, (128, 256, 1)),
    ("drhs", 2048, 2048, 6144, 1, (128, 256, 1)),
    # k / v projection dx, down-projection dW, the LM head's dx and dW
    ("dlhs", 2048, 1024, 2048, 1, (128, 256, 1)),
    ("drhs", 6144, 2048, 2048, 1, (128, 256, 1)),
    ("dlhs", 2048, 151936, 2048, 1, (128, 256, 1)),
    ("drhs", 2048, 2048, 151936, 1, (128, 256, 1)),
    # the attention backward: softmax recompute (32 slices), dv
    ("dlhs", 65536, 128, 2048, 32, (128, 256, 1)),
    ("drhs", 65536, 2048, 128, 32, (128, 128, 1)),
    # the CPU tests' tiny shapes: one tile, too short to split
    ("dlhs", 128, 64, 64, 1, (128, 128, 1)),
    ("dlhs", 128, 256, 64, 1, (128, 128, 1)),
    ("drhs", 64, 128, 256, 1, (128, 256, 1)),
    ("dlhs", 80, 12, 24, 2, (128, 128, 1)),
    # a long contraction on few tiles splits (dlhs), never for drhs
    ("dlhs", 128, 8192, 128, 1, (128, 128, 16)),
    ("dlhs", 256, 4000, 128, 1, (128, 128, 7)),
    ("drhs", 128, 8192, 128, 1, (128, 128, 1)),
])
def test_sm90_tiles(form, rows, k, n, batch, want):
    assert fmb.sm90_tiles(form, rows, k, n, batch, H100_SMS) == want
    tm, tn, splits = want
    k_stages = -(-k // fmb.SM90_BK)
    chunk = -(-k_stages // splits)
    # every split walks at least one stage, and the splits cover K
    assert (splits - 1) * chunk < k_stages <= splits * chunk


def test_sm90_eligible_and_grid_blocks():
    for per in (8, 24, 2048):
        assert fmb.sm90_eligible("dlhs", "bfloat16", "bfloat16", per)
        assert fmb.sm90_eligible("drhs", "bfloat16", "bfloat16", per)
    # fwd from 64 rows a batch slice; below, the weight stream
    assert not fmb.sm90_eligible("fwd", "bfloat16", "bfloat16", 8)
    assert not fmb.sm90_eligible("fwd", "bfloat16", "bfloat16", 63)
    assert fmb.sm90_eligible("fwd", "bfloat16", "bfloat16", 64)
    for lhs, rhs in (("float32", "float32"), ("float16", "float16"),
                     ("float32", "bfloat16"), ("bfloat16", "float32")):
        for form in ("fwd", "dlhs", "drhs"):
            assert not fmb.sm90_eligible(form, lhs, rhs, 2048)
    assert fmb.sm90_grid_blocks(2048, 6144, 128, 256) == (16, 24)
    assert fmb.sm90_grid_blocks(65536, 2048, 128, 256, 32) == (16, 8)
    assert fmb.sm90_grid_blocks(80, 24, 128, 128, 2) == (1, 1)


# --------------------------------------------------------- generation
def test_bf16_backward_segments_emit_the_sm90_mainloop():
    """Every bf16 dlhs / drhs segment of the chains generates the Hopper
    mainloop, with the TMA operands its layout allows: none for A under
    an lhs prologue; the staged launcher beside a TMA one.  The chains'
    bf16 fwd segments (24 rows) take the weight stream."""
    seen = set()
    for label, dt, form, gen in _emitted((torch.bfloat16,)):
        src = gen["source"]
        if form == "fwd":
            assert gen["path"] == "stream" and "fm90" not in src, label
            continue
        seen.add(label)
        assert gen["path"] == "sm90", label
        assert src.startswith('#include "fused_matmul_sm90.cuh"\n')
        assert "fm_gemm<" not in src and "fm90_run<" in src
        assert f"DRHS = {'true' if form == 'drhs' else 'false'}" in src
        want = (False, True) if "prologue" in label else (True, True)
        assert gen["tma"] == want, label
        assert f"{gen['name']}_launch_staged(" in src
        assert src.count("fm90_run<") == 2
        if "batch 2" in label:
            assert "BATCH = 2" in src
    assert len(seen) == 5


def test_sm90_variant_from_the_operand_bases():
    """The TMA launcher only where every TMA operand's base is 16-byte
    aligned; an lhs prologue is register-staged whatever the bases."""
    aligned = torch.empty(64, dtype=torch.bfloat16)
    odd = torch.empty(65, dtype=torch.bfloat16)[1:]
    assert aligned.data_ptr() % 16 == 0 and odd.data_ptr() % 16 != 0
    both = {"tma": (True, True), "tma_ops": [0, 1]}
    assert fm.sm90_variant(both, [aligned, aligned]) == ("", fm.SM90_TMA)
    assert fm.sm90_variant(both, [aligned, odd]) == \
        ("_staged", fm.SM90_STAGED)
    pro = {"tma": (False, True), "tma_ops": [2]}
    assert fm.sm90_variant(pro, [odd, aligned, aligned]) == \
        ("", fm.SM90_STAGED)
    assert fm.sm90_variant(pro, [aligned, aligned, odd]) == \
        ("_staged", fm.SM90_STAGED)
    none = {"tma": (False, False), "tma_ops": []}
    assert fm.sm90_variant(none, [odd, odd]) == ("", fm.SM90_STAGED)


#: (label, dtype) -> (symbol, sha1 of the source) the generator emitted
#: for the chains' f32 and f16 segments before the sm90 mainloop (the
#: bf16 fwd ones left the WMMA template for the weight stream)
GOLDEN_CHAINS = {
    ("fwd gelu", "float32"): ("fm_7d4b5c84c3477747", "0d65516c910545e0"),
    ("fwd lane reduce", "float32"): ("fm_fd7e1bdf69c1bcdd",
                                     "c3c1128c4f7585ce"),
    ("dlhs param/rep/tile", "float32"): ("fm_7e5ed563089c7423",
                                         "39da03c9645c3e1d"),
    ("dlhs lhs prologue, lane reduce", "float32"): ("fm_283fbd71f94eba6d",
                                                    "3d6b3a848dc8fabc"),
    ("dlhs batch 2", "float32"): ("fm_1361539f03e72308", "5b0de17256cdb1f9"),
    ("drhs bulk/param", "float32"): ("fm_925c3cf47ccf7a0b",
                                     "aed47db9089f3ac3"),
    ("drhs batch 2", "float32"): ("fm_a64a0066d57de099", "44277f786dc2f72a"),
    ("fwd gelu", "float16"): ("fm_93ce8c4596da100e", "792a787777b7a6f7"),
    ("fwd lane reduce", "float16"): ("fm_89853dc342cce330",
                                     "91398affd06f67bd"),
    ("dlhs param/rep/tile", "float16"): ("fm_1feba83c0c3b62a8",
                                         "f00055f21b00d132"),
    ("dlhs lhs prologue, lane reduce", "float16"): ("fm_66020b110f4e772b",
                                                    "dacca8a0cbc34531"),
    ("dlhs batch 2", "float16"): ("fm_565a531eeb890758", "acf6c3e6f517d274"),
    ("drhs bulk/param", "float16"): ("fm_34580c37d2d185ea",
                                     "9ebe121b9cb41e56"),
    ("drhs batch 2", "float16"): ("fm_da81755a40ca66c3", "339b8d31b2da77b2"),
}

#: symbol -> sha1 of the source of the tiny training plans' anchored
#: segments that stay on the FMA template (f32 fwd), as emitted before
#: the sm90 mainloop; the bf16 plans keep none (their fwd segments, 128
#: rows, left the WMMA template for the sm90 mainloop)
GOLDEN_TRAINING = {
    "bfloat16": {},
    "float32": {
        "fm_07a475fe8cf2277c": "c9789c00c0951eee",
        "fm_08dbfa2fbf40d475": "c4c8f73060fcfdce",
        "fm_6699f8416417fea4": "4b033025b38295f4",
        "fm_88135d6e9caa54b7": "56651d1ba6be4ed1",
        "fm_a1030b277e478f0c": "a634a6b7914bc66e",
        "fm_bcd8251f491fa6ff": "6f1d7b99c67de4a6",
        "fm_d11ba553082372d2": "dc70ac73d312320e",
        "fm_d31ccff4fb3ba4d1": "7384ae9114da39fc",
        "fm_ed9a63aef5794313": "22001d2423a3628c",
    },
}

#: (fused, form) -> decisions of the tiny training step's forward and
#: backward plans, as planned before the sm90 cost model
GOLDEN_DECISIONS = {
    "bfloat16": {(False, "bmm"): 4, (False, "grid"): 47, (True, "dlhs"): 15,
                 (True, "drhs"): 15, (True, "fwd"): 22, (True, "grid"): 63},
    "float32": {(False, "bmm"): 4, (False, "dlhs"): 7, (False, "drhs"): 7,
                (False, "fwd"): 8, (False, "grid"): 32, (True, "fwd"): 14,
                (True, "grid"): 59},
}


def test_fwd_f32_f16_chain_segments_are_byte_identical():
    got = {(label, dt): (gen["name"], _digest(gen))
           for label, dt, form, gen in _emitted()
           if gen["path"] == "fma"}
    assert got == GOLDEN_CHAINS


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiny_training_plans_keep_their_segments_and_decisions(dtype):
    """The tiny training step's forward and backward plans: the same
    decisions as before the sm90 cost model, every f32 segment
    byte-identical, and (bf16) every fwd / dlhs / drhs on the sm90
    mainloop."""
    plans = _training_plans(dtype)
    assert _plan_summary(plans) == GOLDEN_DECISIONS[dtype]
    gens = _plan_gens(plans)
    kept = {name: _digest(gen) for name, (form, gen) in gens.items()
            if gen["path"] == "fma"}
    assert kept == GOLDEN_TRAINING[dtype]
    sm90 = {form for form, gen in gens.values() if gen["path"] == "sm90"}
    assert sm90 == ({"fwd", "dlhs", "drhs"} if dtype == "bfloat16"
                    else set())


# ------------------------------------------------------------ planner
def test_io_bytes_of_sm90_segments_follow_the_helpers():
    """A bf16 dlhs / drhs segment's modeled bytes: one read per operand,
    one write per output, the operands' re-reads by the sm90 grid through
    ``operand_streams``, and the workspace of an epilogue that does not
    run in the tile."""
    from repro_torch.core.offload import _nbytes

    checked = 0
    for label, form, fn, args in _chains(torch.bfloat16):
        if form == "fwd":
            continue
        plan = offload_report(fn, *args,
                              policy=OffloadPolicy(bulk_threshold=16))
        (seg,) = [s for s in plan.segments if s.matmul is not None]
        mm = seg.matmul
        want = sum(_nbytes(sp.var) for sp in seg.operand_specs) + \
            sum(_nbytes(v) for v in seg.outputs)
        lhs_b = sum(_nbytes(sp.var) for sp in mm.lhs_specs)
        rhs_b = sum(_nbytes(sp.var) for sp in mm.rhs_specs)
        tm, tn, ks = fmb.sm90_tiles(form, seg.rows, mm.k, mm.n, mm.batch,
                                    seg.sms)
        rb, ct = fmb.sm90_grid_blocks(seg.rows, mm.n, tm, tn, mm.batch)
        ln, rn = fm.operand_streams(lhs_b, rb, ct, l2_bytes=seg.l2_bytes,
                                    sms=seg.sms)
        want += lhs_b * ln + rhs_b * rn
        gen = _matmul_gen(segment_call(plan.eqns, seg))
        if gen["ks"]:
            want += 2 * 4 * seg.rows * mm.n * gen["ks"]
        assert gen["path"] == "sm90" and seg.io_bytes() == want, label
        checked += 1
    assert checked == 5
