"""B5 / B7's wgmma kernels, what the CPU can hold of them: the tile
helper the planner shares with the CUDA sources, the operands the
kernels take and refuse (bf16 and f16 at head dims that are multiples
of 8 up to 256, f32 at the FMA kernels' head dims), the flash segment's
modeled bytes, the plain versions against the Pallas kernels in
interpret mode in f16 and at head dims 24 / 96 / 256, and f16 chains
planned as one flash segment as the JAX planner plans them.

The CUDA kernels run only on the card: ``chip_smoke.py`` phase 8 holds
them against these plain versions, phase 9 shows the refusals there.

Tolerances (same numpy inputs on both sides, both compute in f32 and
round the result once): f16 outputs 2e-3 (two f16 ulps of an O(1)
value), bf16 2e-2 (the reference's, tests/test_kernels.py); the f32
log-sum-exp 1e-5; 16-bit gradients 2 ulps of the gradient's max-abs
(2^-9 of it in f16, 2^-6 in bf16), the f32 sums differing only in
order.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import offload_report as joffload_report
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention_bwd import (
    flash_attention_bwd as jflash_bwd,
)
from repro_torch.core import OffloadPolicy
from repro_torch.core.offload import _nbytes, offload_report
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention_bwd import (
    bwd_refusal,
    flash_attention_bwd_plain,
)
# the module, not the entry point of the same name the package exports
fa = importlib.import_module("repro_torch.kernels.flash_attention")

torch.set_num_threads(1)

_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}
_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
#: forward output tolerance by dtype, and gradients' share of max-abs
OUT_TOL = {"float16": 2e-3, "bfloat16": 2e-2}
GRAD_REL = {"float16": 2.0 ** -9, "bfloat16": 2.0 ** -6}
POLICY = OffloadPolicy(bulk_threshold=64)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------------------ tile helper
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_tile_rows_and_q_blocks_over_head_dims(dtype):
    """16-bit: two warpgroups of 64 rows a CTA; the forward's kv tile is
    128 rows at the 64-wide instantiation and 64 wider (S, O and P in 168
    registers).  f32: the FMA kernels' tiles.  The forward's q tile is
    128 rows either way, so k and v stream once per 128 / G
    positions."""
    for h in range(8, 257, 8):
        width = fa.sm90_width(h)
        assert width in fa.SM90_WIDTHS and width >= h
        assert width == 64 or width // 2 < h
        if dtype == torch.float32:
            want = {"fwd": (128, 64), "dkv": (64, 64), "dq": (64, 64)}
        else:
            want = {"fwd": (128, 128 if h <= 64 else 64),
                    "dkv": (64, 128), "dq": (128, 64)}
        for kernel, rows in want.items():
            assert fa.tile_rows(kernel, h, dtype) == rows
        for g in (1, 2, 3, 8, 64):
            assert fa.q_block(g, h, dtype) == 128 // g
            assert fa.q_blocks(2048, g, h, dtype) == \
                -(-2048 // (128 // g))
    with pytest.raises(ValueError):
        fa.tile_rows("bwd", 64, dtype)


# ----------------------------------------------------- taken and refused
@pytest.mark.parametrize("h,dtype,group,match", [
    (8, torch.float16, 1, None), (24, torch.float16, 1, None),
    (96, torch.bfloat16, 2, None), (256, torch.bfloat16, 64, None),
    (136, torch.float16, 4, None), (128, torch.float32, 1, None),
    (12, torch.bfloat16, 1, "head_dim 12"),
    (264, torch.float16, 1, "head_dim 264"),
    (0, torch.bfloat16, 1, "head_dim 0"),
    (96, torch.float32, 1, "head_dim 96"),
    (24, torch.float32, 1, "head_dim 24"),
    (32, torch.bfloat16, 128, "G=128"),
    (32, torch.float64, 1, "dtype torch.float64")])
def test_refusal_and_check_operands(h, dtype, group, match):
    """B5 takes bf16 / f16 at head dims that are multiples of 8 from 8 to
    256 and f32 at 16 / 32 / 64 / 128, G up to 64; ``check_operands``
    raises with ``refusal``'s reason (the messages phase 9 matches)."""
    why = fa.refusal(h, dtype, group)
    assert (why is None) == (match is None)
    if match is None:
        return
    assert match in why
    if h == 0:
        return
    q = torch.zeros((1, 8, group, h), dtype=dtype)
    k = torch.zeros((1, 8, 1, h), dtype=dtype)
    exc = TypeError if "dtype" in match else ValueError
    with pytest.raises(exc, match=match):
        fa.check_operands(q, k, k)


@pytest.mark.parametrize("h,dtype,match", [
    (64, torch.float32, None), (128, torch.bfloat16, None),
    (256, torch.float16, None), (96, torch.bfloat16, None),
    (128, torch.float32, "head_dim <= 64"),
    (96, torch.float32, "head_dim 96"), (12, torch.float16, "head_dim 12")])
def test_bwd_refusal(h, dtype, match):
    """B7 takes what B5 takes, except f32 above head dim 64."""
    why = bwd_refusal(h, dtype)
    assert (why is None) == (match is None)
    if match is not None:
        assert match in why


# --------------------------------------------------- the planned segment
def _tattn(q, k, v):
    scale = torch.tensor(math.sqrt(q.shape[-1])).to(q.dtype)
    s = torch.einsum("bhsd,bhtd->bhst", q, k) / scale
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), v)


def _jattn_working(q, k, v):
    """The chain with its softmax in the working dtype, as the port's
    capture of ``torch.softmax`` has it (``jax.nn.softmax`` sums a
    16-bit row in f32, which the JAX planner's flash pattern declines)."""
    scale = jnp.sqrt(q.shape[-1]).astype(q.dtype)
    s = jnp.einsum("bhsd,bhtd->bhst", q, k) / scale
    e = jnp.exp(s - jax.lax.reduce_max(s, (3,))[..., None])
    p = e / jax.lax.reduce(e, np.array(0, e.dtype), jax.lax.add,
                           (3,))[..., None]
    return jnp.einsum("bhst,bhtd->bhsd", p, v)


@pytest.mark.parametrize("s,d,dtype", [
    (256, 64, torch.float32), (300, 96, torch.bfloat16),
    (130, 256, torch.float16), (128, 24, torch.float16)])
def test_flash_segment_io_bytes_follow_the_tile_helper(s, d, dtype):
    """A flash segment's modeled bytes: every operand and output once, q
    once more, and k and v once per forward q tile of
    ``tile_rows("fwd", d, dtype)``'s q rows."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _arrays([(1, 2, s, d)] * 3, seed=1))
    plan = offload_report(_tattn, q, k, v, policy=POLICY)
    (seg,) = [x for x in plan.segments
              if x.matmul is not None and x.matmul.flash is not None]
    mm = seg.matmul
    q_rows = fa.tile_rows("fwd", d, dtype)[0]
    tiles = -(-(seg.rows // mm.batch) // q_rows)
    base = sum(_nbytes(sp.var) for sp in seg.operand_specs) + \
        sum(_nbytes(o) for o in seg.outputs)
    lhs = sum(_nbytes(sp.var) for sp in mm.lhs_specs)
    rhs = sum(_nbytes(sp.var) for sp in mm.rhs_specs)
    assert tiles == -(-s // 128)
    assert seg.io_bytes() == base + lhs + rhs * tiles


@pytest.mark.parametrize("d,dtype", [
    (64, torch.float16), (40, torch.float16), (256, torch.float16),
    (12, torch.bfloat16), (264, torch.bfloat16), (80, torch.float32),
    (32, torch.float32)])
def test_planner_admits_exactly_what_b5_takes(d, dtype):
    """The flash pair fuses where ``refusal`` takes the operands and is
    declined with its reason elsewhere; where it fuses, the JAX planner
    plans the same single flash segment (batch axes, scale) on the same
    chain."""
    arrays = _arrays([(2, 4, 32, d)] * 3, seed=2)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    plan = offload_report(_tattn, q, k, v, policy=POLICY)
    flash = [x for x in plan.segments
             if x.matmul is not None and x.matmul.flash is not None]
    declined = [x.reason for x in plan.decisions
                if x.form == "flash" and not x.fused]
    why = fa.refusal(d, dtype)
    if why is not None:
        assert not flash and len(declined) == 1 and why in declined[0]
        return
    assert len(flash) == 1 and not declined
    jdt = {torch.float32: jnp.float32, torch.float16: jnp.float16}[dtype]
    jplan = joffload_report(_jattn_working,
                            *(jnp.asarray(a).astype(jdt) for a in arrays),
                            bulk_threshold=64)
    (jseg,) = jplan.segments
    assert jseg.matmul.flash is not None
    assert flash[0].matmul.batch_shape == tuple(jseg.matmul.batch_shape)
    assert flash[0].matmul.flash["scale"] == \
        pytest.approx(jseg.matmul.flash["scale"])


# ------------------------------- plain versions against Pallas interpret
FWD_CASES = [  # B, S, NQ, NK, H, causal, window, dtype
    (1, 64, 4, 2, 16, True, 0, "float16"),
    (1, 48, 2, 1, 64, False, 0, "float16"),
    (1, 40, 2, 2, 24, True, 16, "bfloat16"),
    (1, 40, 4, 2, 96, True, 0, "bfloat16"),
    (1, 32, 2, 1, 256, False, 0, "bfloat16"),
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_plain_forward_and_lse_match_pallas_interpret(case):
    b, s, nq, nk, h, causal, window, dt = case
    arrays = _arrays([(b, s, nq, h), (b, s, nk, h), (b, s, nk, h)], seed=3)
    q, k, v = (torch.from_numpy(a).to(_TD[dt]) for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype(_JD[dt]) for a in arrays)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    jout, jlse = jflash(jq, jk, jv, causal=causal, window=window,
                        q_block=16, kv_block=16, interpret=True,
                        return_lse=True)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=OUT_TOL[dt],
                               atol=OUT_TOL[dt])
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  impl="interpret", q_block=16, kv_block=16)
    np.testing.assert_allclose(_np(out), _np(kernel), rtol=OUT_TOL[dt],
                               atol=OUT_TOL[dt])


@pytest.mark.parametrize("case", FWD_CASES)
def test_plain_backward_matches_pallas_interpret(case):
    """B7's plain version against the JAX kernels on the same o / lse /
    dO (the JAX forward's), each gradient in its operand's dtype."""
    b, s, nq, nk, h, causal, window, dt = case
    arrays = _arrays([(b, s, nq, h), (b, s, nk, h), (b, s, nk, h),
                      (b, s, nq, h)], seed=4)
    q, k, v, do = (torch.from_numpy(a).to(_TD[dt]) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(_JD[dt]) for a in arrays)
    jo, jlse = jflash(jq, jk, jv, causal=causal, window=window, q_block=16,
                      kv_block=16, interpret=True, return_lse=True)
    want = jflash_bwd(jq, jk, jv, jo, jlse, jdo, causal=causal,
                      window=window, q_block=16, kv_block=16,
                      interpret=True)
    got = flash_attention_bwd_plain(
        q, k, v, torch.from_numpy(np.array(_np(jo))).to(_TD[dt]),
        torch.from_numpy(np.array(_np(jlse))), do, causal=causal,
        window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == _TD[dt]
        w = _np(w)
        tol = GRAD_REL[dt] * float(np.abs(w).max())
        np.testing.assert_allclose(_np(g), w, rtol=GRAD_REL[dt], atol=tol,
                                   err_msg=name)
