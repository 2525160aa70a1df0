"""B3's forward form on Hopper, on the CPU: what can be held without the
card.  The kernels (the wgmma mainloop of ``csrc/fused_matmul_sm90.cuh``
for 64 rows a batch slice or more, the weight stream of
``csrc/fused_matmul_stream.cuh`` below) run only on an H100;
``chip_smoke.py`` phases 6 and 7 hold them against the plain versions
there.  Here:

- the geometry (``sm90_eligible``, ``sm90_tiles``, ``stream_eligible``,
  ``stream_blocks``) at qwen3-1.7b's full-width training and decode
  shapes and at the tiny ones;
- ``segment_source`` emitting the sm90 mainloop for bf16 fwd segments of
  64 rows a slice or more (TMA, register-staged lhs prologue,
  register-staged f32 weight cast, batched) and the weight stream below
  (cp.async, register-staged), with the 8-lane accessors;
- f32 and f16 fwd sources byte-identical to what the generator emitted
  before either path existed;
- ``Segment.io_bytes`` of a bf16 fwd segment on either path equal to what
  the helpers' grid gives through ``operand_streams``;
- a decode-shaped block chain planned as the JAX planner plans it, its
  anchored segments on the weight stream.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import OffloadPolicy as JPolicy
from repro.core import offload_explain as joffload_explain
from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import (
    _matmul_gen,
    _nbytes,
    offload_report,
    segment_call,
)
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import fused_matmul_bwd as fmb

torch.set_num_threads(2)

H100_SMS = 132
BF16 = "bfloat16"


# ----------------------------------------------------------- geometry
@pytest.mark.parametrize("rows,k,n,batch,want", [
    # qwen3-1.7b, 2 x 1,024 tokens: MLP gate / up, down, q / o
    (2048, 2048, 6144, 1, (128, 256, 1)),
    (2048, 6144, 2048, 1, (128, 256, 1)),
    (2048, 2048, 2048, 1, (128, 256, 1)),
    # k / v: 16 x 4 = 64 tiles fill less than half the card: a K split
    (2048, 2048, 1024, 1, (128, 256, 3)),
    # the LM head: 16 x 594 tiles
    (2048, 2048, 152064, 1, (128, 256, 1)),
    # the CPU tests' shapes: one tile; a long contraction splits
    (128, 40, 24, 1, (128, 128, 1)),
    (128, 40, 24, 2, (128, 128, 1)),
    (80, 100, 36, 1, (128, 128, 1)),
    (128, 8192, 128, 1, (128, 128, 16)),
])
def test_sm90_tiles_of_the_forward_form(rows, k, n, batch, want):
    assert fmb.sm90_eligible("fwd", BF16, BF16, rows // batch)
    assert not fmb.stream_eligible("fwd", BF16, BF16, rows // batch)
    assert fmb.sm90_tiles("fwd", rows, k, n, batch, H100_SMS) == want
    tm, tn, splits = want
    k_stages = -(-k // fmb.SM90_BK)
    chunk = -(-k_stages // splits)
    assert (splits - 1) * chunk < k_stages <= splits * chunk
    assert fmb.sm90_grid_blocks(rows, n, tm, tn, batch) == (
        -(-(rows // batch) // 128), -(-n // tn))


@pytest.mark.parametrize("rows,k,n,batch,want,grid", [
    # qwen3-1.7b decode, 8 slots: gate / up 48 x 5 CTAs, down, q / o,
    # k / v, the LM head (1,188 column tiles: no split)
    (8, 2048, 6144, 1, (128, 5), (1, 48)),
    (8, 6144, 2048, 1, (128, 16), (1, 16)),
    (8, 2048, 2048, 1, (128, 16), (1, 16)),
    (8, 2048, 1024, 1, (128, 32), (1, 8)),
    (8, 2048, 152064, 1, (128, 1), (1, 1188)),
    # the CPU tests' shapes: row groups of 8, a slice's rows apart
    (24, 40, 24, 1, (128, 1), (3, 1)),
    (24, 40, 24, 2, (128, 1), (2, 1)),
    (24, 8192, 128, 1, (128, 64), (3, 1)),
    (63, 6144, 2048, 1, (128, 3), (8, 16)),
])
def test_stream_blocks_below_64_rows(rows, k, n, batch, want, grid):
    per = rows // batch
    assert fmb.stream_eligible("fwd", BF16, BF16, per)
    assert not fmb.sm90_eligible("fwd", BF16, BF16, per)
    assert fmb.stream_blocks(rows, k, n, H100_SMS, batch) == want
    assert fmb.stream_grid_blocks(rows, n, batch) == grid
    tn, splits = want
    k_stages = -(-k // fmb.STREAM_BK)
    chunk = -(-k_stages // splits)
    # the splits cover K, each walks a stage, and one split's 8 rows of
    # x fit the shared memory set aside for them
    assert (splits - 1) * chunk < k_stages <= splits * chunk
    assert chunk * fmb.STREAM_BK * fmb.STREAM_ROWS * 2 <= fmb.STREAM_X_BYTES
    # the grid fills the card where K has the stages for it, with at most
    # two CTAs an SM (no partial second round) where one split's x fits
    tiles = batch * grid[0] * grid[1]
    assert tiles * splits >= min(H100_SMS, tiles * k_stages)
    if k_stages <= 32 and tiles <= 2 * H100_SMS:
        assert tiles * splits <= 2 * H100_SMS
    assert splits == -(-k_stages // -(-k_stages // min(
        k_stages, max(2 * H100_SMS // tiles, -(-k_stages // 32), 1))))


@pytest.mark.parametrize("form", ["fwd", "dlhs", "drhs"])
def test_paths_by_dtype_and_rows(form):
    for per in (1, 8, 63, 64, 2048):
        for lhs, rhs in ((BF16, BF16), ("float32", "float32"),
                         ("float16", "float16"), (BF16, "float32"),
                         ("float32", BF16)):
            want = "fma"
            if lhs == rhs == BF16:
                want = "stream" if form == "fwd" and per < 64 else "sm90"
            assert fm.gemm_path(form, lhs, rhs, per) == want


# --------------------------------------------------------- generation
def _t(gen, *shape, dtype, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).to(dtype)


def _fwd_chains(dtype, rows):
    """(label, fn, args): fwd chains of one anchored segment each; ``rows``
    rows (two batch slices of half for ``batch 2``)."""
    gen = torch.Generator().manual_seed(5)
    K, N = 40, 24

    def t(*shape, scale=1.0):
        return _t(gen, *shape, dtype=dtype, scale=scale)
    yield ("gelu", lambda x, w: F.gelu(x @ w, approximate="tanh"),
           (t(rows, K), t(K, N)))
    yield ("lane reduce",
           lambda x, w, y: (lambda h: h * torch.rsqrt(torch.mean(
               h * h, -1, keepdim=True) + 1e-5))(x @ w + y),
           (t(rows, K), t(K, N), t(rows, N)))
    yield ("lhs prologue", lambda x, s, w: torch.tanh((x * s) @ w),
           (t(rows, K), t(K), t(K, N)))
    yield ("batch 2", lambda x, w, y: torch.tanh(torch.bmm(x, w)) + y,
           (t(2, rows // 2, K), t(2, K, N), t(2, rows // 2, N)))


def _f32_weight_cast(rows):
    gen = torch.Generator().manual_seed(6)
    return ("f32 weight cast",
            lambda x, w: torch.tanh(x @ w.to(torch.bfloat16)),
            (_t(gen, rows, 40, dtype=torch.bfloat16),
             _t(gen, 40, 24, dtype=torch.float32)))


def _segment(fn, args):
    plan = offload_report(fn, *args, policy=OffloadPolicy(bulk_threshold=16))
    (seg,) = [s for s in plan.segments if s.matmul is not None]
    return plan, seg, _matmul_gen(segment_call(plan.eqns, seg))


#: the TMA operands (A, B) of each bf16 chain at 128 rows: an lhs
#: prologue and an f32 weight cast are register-staged
SM90_TMA = {"gelu": (True, True), "lane reduce": (True, True),
            "lhs prologue": (False, True), "batch 2": (True, True),
            "f32 weight cast": (True, False)}


@pytest.mark.parametrize("label", sorted(SM90_TMA))
def test_bf16_fwd_from_64_rows_emits_the_sm90_mainloop(label):
    chains = {c[0]: c for c in _fwd_chains(torch.bfloat16, 128)}
    chains["f32 weight cast"] = _f32_weight_cast(128)
    _, fn, args = chains[label]
    _, seg, gen = _segment(fn, args)
    src = gen["source"]
    assert gen["path"] == "sm90" and gen["tma"] == SM90_TMA[label]
    assert src.startswith('#include "fused_matmul_sm90.cuh"\n')
    assert "DRHS = false, FWD = true" in src
    assert "fm_gemm<" not in src and "fms_run<" not in src
    # the fwd operands are read 8 lanes at a time along their
    # contiguous axis; no scalar accessor is emitted
    for fn_name in ("lhs_ld", "lhs_at", "rhs_ld", "rhs_at"):
        assert f"void {fn_name}(" in src or f"float {fn_name}(" in src
    assert "fm_ld8(" in src and "float lhs(" not in src
    # a TMA launcher and (where TMA loads an operand) a staged one
    assert src.count("fm90_run<") == 1 + any(gen["tma"])
    want = {"fwd": 2 if label == "batch 2" else 1}
    assert f"BATCH = {want['fwd']}" in src
    if label == "f32 weight cast":
        # the f32 weight read 8 lanes at a time by 16-byte loads and cast
        # by the loading warpgroup: the launcher with A by TMA, B staged
        assert "const float* __restrict__ w0;" in src
        assert "fm_ld8(a.w0 + (size_t)k * 24 + L0" in src
        assert f"fm90_run<{gen['name']}_S, true, false>" in src
    if label == "lhs prologue":
        assert seg.matmul.pro_eqns and "a.l1[" in src


@pytest.mark.parametrize("rows", [8, 24])
def test_bf16_fwd_below_64_rows_emits_the_weight_stream(rows):
    chains = list(_fwd_chains(torch.bfloat16, rows)) + \
        [_f32_weight_cast(rows)]
    for label, fn, args in chains:
        _, seg, gen = _segment(fn, args)
        src = gen["source"]
        assert gen["path"] == "stream", label
        assert src.startswith('#include "fused_matmul_stream.cuh"\n')
        assert "fm_gemm<" not in src and "fm90_run<" not in src
        # the weight by cp.async unless a prologue must be evaluated
        cast = label == "f32 weight cast"
        assert gen["tma"] == (not cast,), label
        assert gen["tma_ops"] == ([] if cast else [len(seg.matmul.lhs_specs)])
        assert src.count("fms_run<") == 1 + (not cast)
        _, splits = fmb.stream_blocks(seg.rows, seg.matmul.k, seg.matmul.n,
                                      seg.sms, seg.matmul.batch)
        assert f"KS = {splits}," in src


def test_stream_and_sm90_variants_from_the_operand_bases():
    aligned = torch.empty(64, dtype=torch.bfloat16)
    odd = torch.empty(65, dtype=torch.bfloat16)[1:]
    stream = {"path": "stream", "tma": (True,), "tma_ops": [1]}
    assert fm.sm90_variant(stream, [aligned, aligned]) == \
        ("", fm.STREAM_ASYNC)
    assert fm.sm90_variant(stream, [aligned, odd]) == \
        ("_staged", fm.STREAM_STAGED)
    cast = {"path": "stream", "tma": (False,), "tma_ops": []}
    assert fm.sm90_variant(cast, [odd, odd]) == ("", fm.STREAM_STAGED)
    sm90 = {"path": "sm90", "tma": (True, False), "tma_ops": [0]}
    assert fm.sm90_variant(sm90, [aligned, odd]) == ("", fm.SM90_STAGED)
    assert fm.sm90_variant(sm90, [odd, aligned]) == \
        ("_staged", fm.SM90_STAGED)


#: (label, rows, dtype) -> (symbol, sha1 of the source) of f32 and f16
#: fwd segments, as the generator emitted them before the sm90 fwd form
#: and the weight stream existed
GOLDEN_FWD = {
    ("gelu", 24, "float32"): ("fm_7d4b5c84c3477747", "0d65516c910545e0"),
    ("lane reduce", 24, "float32"): ("fm_fd7e1bdf69c1bcdd",
                                     "c3c1128c4f7585ce"),
    ("lhs prologue", 24, "float32"): ("fm_01a3747e51b78a07",
                                      "d7308baca006d7c8"),
    ("batch 2", 24, "float32"): ("fm_adb467c6a0b536f6", "fe91cb7367720566"),
    ("gelu", 128, "float32"): ("fm_8d77c03fabcd380f", "e4b8fd9328c18a1e"),
    ("lane reduce", 128, "float32"): ("fm_5a39df391ba99614",
                                      "2ce9a665752c7d15"),
    ("lhs prologue", 128, "float32"): ("fm_7d44f68f9c0008a6",
                                       "bf60be29260f08a9"),
    ("batch 2", 128, "float32"): ("fm_a6d98efc5f7bee3d", "552e332ce245fbcb"),
    ("gelu", 24, "float16"): ("fm_93ce8c4596da100e", "792a787777b7a6f7"),
    ("lane reduce", 24, "float16"): ("fm_89853dc342cce330",
                                     "91398affd06f67bd"),
    ("lhs prologue", 24, "float16"): ("fm_7e7745271df998ec",
                                      "bd011fff36e23539"),
    ("batch 2", 24, "float16"): ("fm_42697c112867ca90", "1b567f5964ae90f3"),
    ("gelu", 128, "float16"): ("fm_9cac238c757b5a1c", "06d7aa3128a17029"),
    ("lane reduce", 128, "float16"): ("fm_f97afede280363cd",
                                      "7aad4fb9ffd8d817"),
    ("lhs prologue", 128, "float16"): ("fm_80cac1b2973d9faa",
                                       "224a91c06967b51e"),
    ("batch 2", 128, "float16"): ("fm_a1b83c571e312289", "d41bff06c36e51a0"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_f32_f16_fwd_sources_are_byte_identical(dtype):
    got = {}
    for rows in (24, 128):
        for label, fn, args in _fwd_chains(dtype, rows):
            _, _, gen = _segment(fn, args)
            assert gen["path"] == "fma" and "fm_gemm<" in gen["source"]
            got[(label, rows, str(dtype)[6:])] = (
                gen["name"],
                hashlib.sha1(gen["source"].encode()).hexdigest()[:16])
    assert got == {k: v for k, v in GOLDEN_FWD.items()
                   if k[2] == str(dtype)[6:]}


# ------------------------------------------------------------ planner
@pytest.mark.parametrize("rows", [8, 24, 128])
def test_io_bytes_of_bf16_fwd_segments_follow_the_helpers(rows):
    """A bf16 fwd segment's modeled bytes: one read per operand, one write
    per output, the operands' re-reads by its path's grid through
    ``operand_streams``, and the workspace of an epilogue that does not
    run in the tile."""
    chains = list(_fwd_chains(torch.bfloat16, rows)) + \
        [_f32_weight_cast(rows)]
    for label, fn, args in chains:
        _, seg, gen = _segment(fn, args)
        mm = seg.matmul
        want = sum(_nbytes(sp.var) for sp in seg.operand_specs) + \
            sum(_nbytes(v) for v in seg.outputs)
        lhs_b = sum(_nbytes(sp.var) for sp in mm.lhs_specs)
        rhs_b = sum(_nbytes(sp.var) for sp in mm.rhs_specs)
        if gen["path"] == "sm90":
            tm, tn, ks = fmb.sm90_tiles("fwd", seg.rows, mm.k, mm.n,
                                        mm.batch, seg.sms)
            rb, ct = fmb.sm90_grid_blocks(seg.rows, mm.n, tm, tn, mm.batch)
        else:
            assert gen["path"] == "stream"
            _, ks = fmb.stream_blocks(seg.rows, mm.k, mm.n, seg.sms,
                                      mm.batch)
            rb, ct = fmb.stream_grid_blocks(seg.rows, mm.n, mm.batch)
        ln, rn = fm.operand_streams(lhs_b, rb, ct, l2_bytes=seg.l2_bytes,
                                    sms=seg.sms)
        want += lhs_b * ln + rhs_b * rn
        assert gen["ks"] in (0, ks)
        if gen["ks"]:
            want += 2 * 4 * seg.rows * mm.n * ks
        assert seg.io_bytes() == want, label


# ------------------------------------------------- decode against JAX
D, FF, NQH = 64, 128, 64


def _decode_data(rows, seed=3):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    return dict(a=rng.standard_normal((rows, 1, NQH)).astype(np.float32),
                x=rng.standard_normal((rows, 1, D)).astype(np.float32),
                s=(1.0 + 0.1 * rng.standard_normal((D,))).astype(np.float32),
                wo=w(NQH, D), wg=w(D, FF), wu=w(D, FF), wd=w(FF, D))


def _jmlp(a, x, wo, s, wg, wu, wd):
    x = x + a @ wo
    h = x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + 1e-5) * s
    g = h @ wg
    return x + (g * jax.lax.logistic(g) * (h @ wu)) @ wd


def _tmlp(a, x, wo, s, wg, wu, wd):
    x = x + a @ wo
    h = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-5) * s
    g = h @ wg
    return x + (F.silu(g) * (h @ wu)) @ wd


@pytest.mark.parametrize("rows", [8, 128])
def test_decode_shaped_block_plans_like_jax(rows):
    """The o-projection / rmsnorm / SwiGLU / down chain of a decoder
    block at decode's 8 rows and at 128: the port plans the decisions the
    JAX planner plans (the anchored segments' path does not enter the
    decisions), and its bf16 anchored segments take the weight stream at
    8 rows and the sm90 mainloop at 128."""
    names = ("a", "x", "wo", "s", "wg", "wu", "wd")
    data = _decode_data(rows)
    jrep = joffload_explain(_jmlp, *[jnp.asarray(data[n]) for n in names],
                            policy=JPolicy(bulk_threshold=8))
    want = [(d.tier, d.form, d.fused, d.roles) for d in jrep.decisions]
    for dtype in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(data[n]).to(dtype) for n in names]
        plan = offload_report(_tmlp, *args,
                              policy=OffloadPolicy(bulk_threshold=8))
        got = [(d.tier, d.form, d.fused, d.roles)
               for d in plan.report().decisions]
        assert got == want and any(d.fused and d.form == "fwd"
                                   for d in jrep.decisions)
        paths = {_matmul_gen(segment_call(plan.eqns, s))["path"]
                 for s in plan.segments if s.matmul is not None}
        if dtype == torch.float32:
            assert paths == {"fma"}
        else:
            assert paths == {"stream" if rows < 64 else "sm90"}


def test_tiny_engine_decode_plan_streams_every_anchored_segment():
    """The tiny 2-layer engine's paged bf16 decode step (2 slots): the
    fused / declined / anchored counts its plan has had since the forward
    slice (tests/test_torch_offload.py pins them against the JAX-planned
    counts), and every anchored segment on the weight stream."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              dtype="bfloat16", num_layers=2)
    eng = Engine(cfg, build_model(cfg, device="cpu").init(0), device="cpu",
                 slots=2, max_len=48, page_size=8,
                 offload_policy=OffloadPolicy(bulk_threshold=32))
    plan = eng.decode_plan()
    report = plan.report()
    anchored = [s for s in plan.segments if s.matmul is not None]
    assert (report.n_fused, report.n_declined, len(anchored)) == (16, 8, 7)
    for seg in anchored:
        gen = _matmul_gen(segment_call(plan.eqns, seg))
        assert gen["path"] == "stream" and seg.rows < 64
        _, splits = fmb.stream_blocks(seg.rows, seg.matmul.k, seg.matmul.n,
                                      seg.sms, seg.matmul.batch)
        assert gen["ks"] in (0, splits)
