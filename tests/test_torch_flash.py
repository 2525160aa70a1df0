"""B5 (flash attention forward) and B7 (its backward) of the port, held
against the JAX package on the CPU: the plain versions beside the CUDA
kernels (``repro_torch.kernels.flash_attention`` /
``flash_attention_bwd``) against the Pallas kernels in interpret mode and
the ``ref`` oracle, the log-sum-exp against ``return_lse``, and
``flash_attention_diff``'s gradients against ``jax.grad`` of the JAX
package's ``flash_attention_diff``.  Same numpy inputs on both sides.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
phase 8 holds them against these plain versions.

Tolerances: the reference's (``tests/test_kernels.py``) — f32 2e-5,
bf16 2e-2 forward; gradients 2e-4 relative / 2e-5 absolute (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention_bwd import (
    flash_attention_bwd as jflash_bwd,
)
from repro.kernels.flash_attention_bwd import (
    flash_attention_diff as jflash_diff,
)
from repro_torch.kernels import flash_attention_diff, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)

torch.set_num_threads(1)

_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# tests/test_kernels.py:20-27
FWD_CASES = [
    (1, 64, 4, 4, 16, True, 0),
    (2, 128, 8, 2, 32, True, 0),
    (1, 96, 4, 1, 64, False, 0),
    (2, 160, 4, 2, 16, True, 24),
    (1, 70, 2, 2, 16, True, 0),     # non-multiple of block
]
# tests/test_kernels.py:153-158
BWD_CASES = [
    (1, 64, 4, 2, 16, True, 0),
    (2, 96, 4, 4, 32, False, 0),
    (1, 80, 2, 1, 16, True, 24),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _qkv(b, s, nq, nk, h, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nq, h)).astype(np.float32),
            rng.standard_normal((b, s, nk, h)).astype(np.float32),
            rng.standard_normal((b, s, nk, h)).astype(np.float32))


def _both(arrays, dtype):
    return ([torch.from_numpy(a).to(_TD[dtype]) for a in arrays],
            [jnp.asarray(a).astype(_JD[dtype]) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", FWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_interpret_and_oracle(case, dtype):
    b, s, nq, nk, h, causal, window = case
    (q, k, v), (jq, jk, jv) = _both(_qkv(b, s, nq, nk, h), dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  impl="interpret", q_block=32, kv_block=32)
    oracle = jref.ref_flash_attention(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("case", [(1, 48, 2, 2, 16, True, 0),
                                  (2, 70, 4, 2, 32, True, 24),
                                  (1, 96, 4, 1, 64, False, 0)])
def test_plain_lse_matches_the_kernel_return_lse(case):
    b, s, nq, nk, h, causal, window = case
    (q, k, v), (jq, jk, jv) = _both(_qkv(b, s, nq, nk, h, seed=1),
                                    "float32")
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    jout, jlse = jflash(jq, jk, jv, causal=causal, window=window,
                        q_block=16, kv_block=16, interpret=True,
                        return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, s, nq)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(jout), **_tol("float32"))


def test_explicit_scale_matches_the_kernel():
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 64, 4, 2, 32, seed=2),
                                    "float32")
    got = ops.flash_attention(q, k, v, causal=False, scale=0.3)
    want = jflash(jq, jk, jv, causal=False, scale=0.3, q_block=32,
                  kv_block=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_backward_matches_pallas_interpret(case):
    """B7's plain version against the JAX kernels on the same o / lse /
    dO (the forward's, computed by the JAX kernel)."""
    b, s, nq, nk, h, causal, window = case
    arrays = _qkv(b, s, nq, nk, h, seed=3)
    do = np.random.default_rng(4).standard_normal(
        (b, s, nq, h)).astype(np.float32)
    (q, k, v), (jq, jk, jv) = _both(arrays, "float32")
    jo, jlse = jflash(jq, jk, jv, causal=causal, window=window, q_block=32,
                      kv_block=32, interpret=True, return_lse=True)
    want = jflash_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), causal=causal,
                      window=window, q_block=32, kv_block=32,
                      interpret=True)
    got = flash_attention_bwd_plain(
        q, k, v, torch.from_numpy(np.array(jo)),
        torch.from_numpy(np.array(jlse)), torch.from_numpy(do),
        causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_diff_grads_match_jax_grad(case):
    """d/d(q, k, v) of sum(sin(flash_attention_diff)) — the port's
    autograd Function (B5 forward with lse, B7 backward; plain versions
    here) against jax.grad of the JAX package's custom VJP (interpret)."""
    b, s, nq, nk, h, causal, window = case
    arrays = _qkv(b, s, nq, nk, h, seed=5)
    tq, tk, tv = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = flash_attention_diff(tq, tk, tv, causal, window)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))

    def f(q, k, v):
        return jnp.sum(jnp.sin(jflash_diff(q, k, v, causal, window, 32, 32,
                                           True)))
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_cpu_tensors_never_reach_the_cuda_kernels():
    """On the CPU ``impl="auto"`` takes the plain versions; asking for
    the kernels raises rather than standing anything in for them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, 2, 1, 16))
    with pytest.raises(RuntimeError, match="impl='cuda' needs tensors"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(RuntimeError, match="launches a CUDA kernel"):
        fa.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="launches CUDA kernels"):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 32, 2), q)
    with pytest.raises(RuntimeError, match="impl='cuda' needs tensors"):
        flash_attention_diff(q, k, v, impl="cuda")


def test_launch_counters_are_registered():
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert name in ops.KERNELS and name in ops.launch_counts()


def test_q_tile_helper():
    """B5's q tile folds G heads into 128 rows: 128 / G query positions;
    k and v stream once per q tile."""
    assert [fa.q_block(g) for g in (1, 2, 4, 64)] == [128, 64, 32, 2]
    assert fa.q_blocks(2048, 2) == 32 and fa.q_blocks(130, 1) == 2
    with pytest.raises(ValueError):
        fa.q_block(65)


def test_fused_flash_segment_plain_is_the_unmasked_chain():
    """The planner's flash call (one head per batch slice, no mask, the
    extracted scale) equals softmax(q k^T * scale) v."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 40, 32)).astype(
        np.float32)) for _ in range(3))
    (out,) = ops.fused_flash_segment(
        q.reshape(240, 32), k.reshape(240, 32), v.reshape(240, 32),
        batch=6, rows=240, head_dim=32, t_dim=40, n_dim=32, scale=0.2,
        out_dtype=torch.float32)
    want = torch.softmax(q @ k.transpose(1, 2) * 0.2, dim=-1) @ v
    torch.testing.assert_close(out.reshape(6, 40, 32), want, rtol=2e-5,
                               atol=2e-5)
