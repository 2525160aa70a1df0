"""Port kernels on the CPU: the plain PyTorch version of each kernel is
held against the JAX package's kernel (run in interpret mode, as that
package's own tests run it) and against its ``ref`` oracle, on the same
numpy inputs.  The CUDA kernel itself is compared with the plain version
on the GPU by ``chip_smoke.py``.

Tolerances: f32 2e-5 (summation order differs), bf16 2e-2 compared in
f32 (one bf16 rounding of the output on either side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    default_num_splits,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.kernels.guard import kernel_guard, resolve_impl

torch.set_num_threads(1)

SHAPES = [
    (2, 4, 64, 8, 2, 32),
    (3, 3, 32, 4, 4, 16),
    (1, 8, 16, 2, 1, 64),
]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _case(b, np_, page, nq, nk, h, dtype, seed=0):
    """Seeded numpy inputs, rounded to ``dtype`` so both sides see the
    same values; tables are a permuted non-contiguous page assignment."""
    rng = np.random.default_rng(seed)
    pool_pages = 1 + b * np_
    q = rng.standard_normal((b, nq, h)).astype(np.float32)
    k = rng.standard_normal((pool_pages, nk, page, h)).astype(np.float32)
    v = rng.standard_normal((pool_pages, nk, page, h)).astype(np.float32)
    perm = rng.permutation(np.arange(1, pool_pages))
    tables = perm.reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * page + 1, size=(b,)).astype(np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    return jx, tx, tables, lengths


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("b,np_,page,nq,nk,h", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_oracle(b, np_, page, nq, nk, h, dtype):
    jx, tx, tables, lengths = _case(b, np_, page, nq, nk, h, dtype)
    got = ops.paged_decode_attention(
        *tx, torch.from_numpy(tables), torch.from_numpy(lengths))
    assert got.dtype == tx[0].dtype and got.shape == (b, nq, h)
    kern = jops.paged_decode_attention(
        *jx, jnp.asarray(tables), jnp.asarray(lengths), impl="interpret")
    oracle = jref.ref_paged_decode_attention(
        *jx, jnp.asarray(tables), jnp.asarray(lengths))
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


def test_length_zero_row_is_zeros_like_the_kernel():
    """The JAX oracle averages V for an empty row; the kernel (and the
    plain version, which follows the kernel) yields zeros."""
    jx, tx, tables, lengths = _case(3, 3, 32, 4, 4, 16, "float32", seed=1)
    lengths[1] = 0
    got = paged_decode_attention_plain(
        *tx, torch.from_numpy(tables), torch.from_numpy(lengths))
    kern = jops.paged_decode_attention(
        *jx, jnp.asarray(tables), jnp.asarray(lengths), impl="interpret")
    assert (got[1] == 0).all() and (np.asarray(kern)[1] == 0).all()
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL["float32"])


def test_pages_past_length_are_ignored():
    """Stale table tails — zero (scratch) ids and garbage ids alike —
    must not change the output bit for bit: the engine leaves them."""
    b, np_, page, nq, nk, h = 2, 4, 16, 4, 2, 32
    _, tx, _, _ = _case(b, np_, page, nq, nk, h, "float32")
    tables = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    lengths = torch.tensor([page + 3, 2 * page], dtype=torch.int32)
    base = paged_decode_attention_plain(*tx, torch.from_numpy(tables),
                                        lengths)
    scrambled = tables.copy()
    scrambled[0, 2:] = 0
    scrambled[1, 2:] = [b * np_, 1]
    out = paged_decode_attention_plain(*tx, torch.from_numpy(scrambled),
                                       lengths)
    assert torch.equal(base, out)


def test_cpu_tensor_never_reaches_the_cuda_kernel():
    _, tx, tables, lengths = _case(2, 4, 64, 8, 2, 32, "float32")
    args = (*tx, torch.from_numpy(tables), torch.from_numpy(lengths))
    before = dict(kernel_guard().launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.paged_decode_attention(*args, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_decode_attention(*args)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(*args, impl="pallas")
    # the fused-segment kernels (B2 Triton, B3 CUDA) refuse CPU tensors too
    from repro_torch.core import OffloadPolicy
    from repro_torch.core.offload import offload_report, segment_call

    x, w = torch.ones((8, 16)), torch.ones((16, 32))
    plan = offload_report(lambda x, w: torch.tanh(x @ w) * 2.0 + x.sum(),
                          x, w, policy=OffloadPolicy(bulk_threshold=8))
    calls = [segment_call(plan.eqns, s) for s in plan.segments]
    assert {c["kind"] for c in calls} == {"matmul"}
    grid = offload_report(lambda x: torch.tanh(x) * 2.0 + 1.0, x,
                          policy=OffloadPolicy(bulk_threshold=8))
    calls += [segment_call(grid.eqns, s) for s in grid.segments]
    for call in calls:
        vals = [torch.ones(s[1], s[2]) for s in call["specs"]]
        with pytest.raises(RuntimeError, match="CUDA"):
            if call["kind"] == "grid":
                ops.fused_segment_grid(
                    call["progs"].body, vals, call["specs"],
                    rows=call["rows"], out_cols=call["out_cols"],
                    out_dtypes=call["out_dtypes"], impl="cuda")
            else:
                ops.fused_matmul_segment(
                    None, None, call["progs"].body, vals[:1],
                    call["specs"][:1], vals[1:2], call["specs"][1:2],
                    vals[2:], call["specs"][2:], rows=call["rows"],
                    k_dim=call["k"], n_dim=call["n"],
                    acc_dtype=call["acc_dtype"], out_cols=call["out_cols"],
                    out_dtypes=call["out_dtypes"],
                    vmem_bytes=call["vmem_bytes"], sms=call["sms"],
                    impl="cuda")
    assert kernel_guard().launches == before        # nothing was launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert resolve_impl("auto", tx[0]) == "ref"


def test_default_num_splits_fills_the_card_from_shapes_alone():
    from repro_torch.core.machine import H100_SXM

    sms = H100_SXM.sms
    # main-path shape: 8 slots x 8 kv heads = 64 blocks -> 4 splits
    assert default_num_splits(8, 16, 8, 32, sms) == 4
    assert default_num_splits(1, 2, 1, 8, sms) == 8     # capped by pages
    assert default_num_splits(64, 32, 32, 32, sms) == 1  # already full
    assert default_num_splits(2, 6, 2, 16, sms) == 16   # G=3 -> tile of 1
    assert default_num_splits(8, 16, 8, 32, sms // 2) == 2  # half the SMs
