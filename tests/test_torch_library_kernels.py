"""The kernel library's rmsnorm (B9, forward and backward), rotary (B10)
and dense decode attention (B11) on the CPU: ``repro_torch.kernels.ops``
(the plain versions, as a CPU tensor takes them) against the JAX
package's ``ops`` in interpret mode, as that package's own tests run
its kernels, and against its ``ref`` oracles, on the same numpy inputs.
The CUDA kernels themselves are held against the plain versions on the
GPU by ``chip_smoke.py`` (phase 9).

Tolerances are those of ``tests/test_kernels.py``: f32 2e-5 (summation
order), bf16 2e-2 compared in f32 (one bf16 rounding of the output on
either side); f16, which B9 and B10 take since queue C3's lift, 4e-3 (one
f16 rounding, 2^-11 of the value, on either side, and an ulp of the
cotangent's rounding under autograd; phase 8's flash tolerance), with two
stated exceptions for rotary:

* against the Pallas kernel, the reference's own kernel-vs-oracle bound
  for rotary (1e-4, ``tests/test_kernels.py:test_rotary``): that kernel
  raises theta to its exponents at run time inside the kernel, a few
  ulps off the oracle's frequencies, and the error grows with the
  position;
* above position 4,096, against the oracle, a bound per element: a
  one-ulp difference in a frequency f (``2^-24 f`` for f in [0.5, 1))
  moves the angle at position P by up to ``P * 2^-23 * f``, and the
  output by that times ``|x1| + |x2|``; plus the f32 slack.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jkernels
import repro_torch.kernels as tkernels
from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.guard import kernel_guard

# the modules, not the entry points of the same names the package exports
dec = importlib.import_module("repro_torch.kernels.decode_attention")
rn = importlib.import_module("repro_torch.kernels.rmsnorm")
ro = importlib.import_module("repro_torch.kernels.rotary")

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2),
       "float16": dict(rtol=4e-3, atol=4e-3)}
#: the reference's own bound between its rotary kernel and its oracle
ROPE_KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "float16": torch.float16}


def _pair(a: np.ndarray, dtype: str):
    """The same values on both sides, rounded to ``dtype``."""
    return jnp.asarray(a).astype(JD[dtype]), torch.from_numpy(a).to(TD[dtype])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _norm_inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (rng.standard_normal((d,)) * 0.1 + 1.0).astype(np.float32)
    return x, s


@pytest.mark.parametrize("rows,d", [(64, 128), (33, 96), (257, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rmsnorm_fwd(rows, d, dtype):
    x, s = _norm_inputs(rows, d)
    jx, tx = _pair(x, dtype)
    got = ops.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == (rows, d)
    kern = jops.rmsnorm(jx, jnp.asarray(s), impl="interpret", rows_block=32)
    oracle = jref.ref_rmsnorm(jx, jnp.asarray(s))
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


def test_rmsnorm_takes_any_leading_dims():
    """[..., D] with a row count that is no block multiple, no padding."""
    x, s = _norm_inputs(2 * 17 * 3, 64, seed=1)
    x = x.reshape(2, 17, 3, 64)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), eps=1e-6)
    kern = jops.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=1e-6,
                        impl="interpret", rows_block=32)
    assert got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL["float32"])


@pytest.mark.parametrize("rows,d,dtype,scale_dtype", [
    (64, 96, "float32", "float32"),
    (33, 96, "float32", "float32"),
    (33, 96, "float32", "bfloat16"),
    (33, 96, "bfloat16", "bfloat16"),
    (33, 96, "float16", "float16"),
    (64, 128, "float16", "float32"),
])
def test_rmsnorm_bwd(rows, d, dtype, scale_dtype):
    """dx and ds of sum(sin(rmsnorm(x, s))): autograd through the port's
    ``RMSNormFn`` against ``jax.grad`` through the Pallas custom VJP.  A
    bf16 or f16 scale gets its ds back in its dtype on both sides."""
    x, s = _norm_inputs(rows, d, seed=2)
    jx, tx = _pair(x, dtype)
    js, ts = _pair(s, scale_dtype)
    tx.requires_grad_()
    ts.requires_grad_()
    y = ops.rmsnorm(tx, ts)
    assert type(y.grad_fn).__name__ == "RMSNormFnBackward"
    torch.sin(y).sum().backward()

    def loss(x, s):
        return jnp.sum(jnp.sin(jops.rmsnorm(x, s, impl="interpret",
                                            rows_block=32)))

    gx, gs = jax.grad(loss, argnums=(0, 1))(jx, js)
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == ts.dtype
    assert gs.dtype == JD[scale_dtype]
    np.testing.assert_allclose(_f32(tx.grad), _f32(gx), **TOL[dtype])
    np.testing.assert_allclose(_f32(ts.grad), _f32(gs), **TOL[scale_dtype])


def test_rmsnorm_bwd_plain_is_the_formula_autograd_agrees_with():
    """The backward's plain version is the explicit formula; autograd of
    the plain forward gives the same gradients."""
    x, s = _norm_inputs(40, 48, seed=3)
    tx, ts = (torch.from_numpy(a).requires_grad_() for a in (x, s))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (40, 48)).astype(np.float32))
    rn.rmsnorm_plain(tx, ts).backward(g)
    dx, ds = rn.rmsnorm_bwd_plain(tx.detach(), ts.detach(), g)
    np.testing.assert_allclose(dx.numpy(), tx.grad.numpy(), **TOL["float32"])
    np.testing.assert_allclose(ds.numpy(), ts.grad.numpy(), **TOL["float32"])


def _rope_case(r, n, h, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, n, h)).astype(np.float32)
    pos = rng.integers(lo, hi, size=(r,)).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("r,n,h,theta", [(100, 4, 32, 1e4), (64, 1, 64, 1e6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rotary(r, n, h, theta, dtype):
    """Positions below 4,096: 2e-5 (f32) against the oracle, and the
    reference's own 1e-4 against its Pallas kernel (module docstring);
    16-bit types at their rounding tolerance on both."""
    x, pos = _rope_case(r, n, h, 0, 4096)
    jx, tx = _pair(x, dtype)
    got = ops.rotary(tx, torch.from_numpy(pos), theta=theta)
    assert got.dtype == tx.dtype and got.shape == (r, n, h)
    kern = jops.rotary(jx, jnp.asarray(pos), theta=theta, impl="interpret",
                       rows_block=32)
    oracle = jref.ref_rotary(jx, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])
    tol = TOL[dtype] if dtype != "float32" else ROPE_KERNEL_TOL
    np.testing.assert_allclose(_f32(got), _f32(kern), **tol)


def rope_far_bound(x: np.ndarray, pos: np.ndarray, theta: float):
    """Per-element bound at large positions (module docstring)."""
    h = x.shape[-1]
    freqs = ro.rotary_freqs(h, theta).numpy()
    shift = pos[:, None, None] * 2.0 ** -23 * freqs[None, None, :]
    mag = np.abs(x[..., : h // 2]) + np.abs(x[..., h // 2:])
    return np.concatenate([shift * mag] * 2, axis=-1) + 2e-5


@pytest.mark.parametrize("r,n,h,theta", [(100, 4, 32, 1e4), (64, 1, 64, 1e6),
                                         (96, 2, 128, 1e6)])
def test_rotary_far_positions(r, n, h, theta):
    """f32, positions 4,096..32,767 against the oracle, within the
    per-element bound of a one-ulp frequency difference; int64 positions
    give the same result as int32."""
    x, pos = _rope_case(r, n, h, 4096, 32768, seed=5)
    got = ops.rotary(torch.from_numpy(x), torch.from_numpy(pos), theta=theta)
    oracle = np.asarray(jref.ref_rotary(jnp.asarray(x), jnp.asarray(pos),
                                        theta))
    err = np.abs(got.numpy() - oracle)
    assert (err <= rope_far_bound(x, pos, theta)).all(), err.max()
    got64 = ops.rotary(torch.from_numpy(x),
                       torch.from_numpy(pos.astype(np.int64)), theta=theta)
    assert torch.equal(got, got64)


DECODE_SHAPES = [(2, 256, 8, 2, 32), (3, 100, 4, 4, 16), (1, 513, 2, 1, 64)]


def _decode_case(b, t, nq, nk, h, seed=0):
    """Ragged lengths: T and 1 where there are two rows, and 0 where
    there are three."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h)).astype(np.float32)
    kc = rng.standard_normal((b, t, nk, h)).astype(np.float32)
    vc = rng.standard_normal((b, t, nk, h)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    if b >= 2:
        lengths[0], lengths[-1] = t, 1
    if b >= 3:
        lengths[1] = 0
    return q, kc, vc, lengths


@functools.lru_cache(maxsize=None)
def _jax_decode(shape: tuple, dtype: str) -> tuple:
    """The Pallas kernel (interpret mode, head-major cache read in place;
    the token-major wrapper only transposes into it) and the oracle, once
    per shape and dtype for both layouts' cases."""
    q, kc, vc, lengths = _decode_case(*shape)
    jq, jk, jv = (_pair(a, dtype)[0] for a in (q, kc, vc))
    kern = jops.decode_attention(jq, jk.transpose(0, 2, 1, 3),
                                 jv.transpose(0, 2, 1, 3),
                                 jnp.asarray(lengths), impl="interpret",
                                 kv_block=64, head_major=True)
    oracle = jref.ref_decode_attention(jq, jk, jv, jnp.asarray(lengths))
    return _f32(kern), _f32(oracle)


@pytest.mark.parametrize("b,t,nq,nk,h", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_major", [False, True])
def test_decode_attention(b, t, nq, nk, h, dtype, head_major):
    """Both layouts, each read as given, against the Pallas kernel (every
    row; a length-0 row gives zeros on both sides) and the oracle (rows
    with keys)."""
    q, kc, vc, lengths = _decode_case(b, t, nq, nk, h)
    if head_major:
        kc, vc = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                  for a in (kc, vc))
    tq, tk, tv = (_pair(a, dtype)[1] for a in (q, kc, vc))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                               head_major=head_major)
    assert got.dtype == tq.dtype and got.shape == (b, nq, h)
    kern, oracle = _jax_decode((b, t, nq, nk, h), dtype)
    np.testing.assert_allclose(_f32(got), kern, **TOL[dtype])
    live = lengths > 0
    np.testing.assert_allclose(_f32(got)[live], oracle[live], **TOL[dtype])
    assert (_f32(got)[~live] == 0).all()


def test_dense_and_paged_plain_versions_agree():
    """A dense cache and the page pool holding the same rows (64-token
    pages, permuted tables) give the same output."""
    b, t, nq, nk, h, page = 2, 256, 8, 2, 32, 64
    q, kc, vc, lengths = (torch.from_numpy(a)
                          for a in _decode_case(b, t, nq, nk, h, seed=6))
    n_pages = t // page
    perm = torch.from_numpy(np.random.default_rng(7).permutation(
        b * n_pages).astype(np.int32)) + 1
    tables = perm.reshape(b, n_pages)

    def pool(cache):     # [B, T, NK, H] -> [1 + B*NP, NK, page, H]
        pages = cache.reshape(b, n_pages, page, nk, h).permute(0, 1, 3, 2, 4)
        out = torch.zeros((1 + b * n_pages, nk, page, h))
        out[tables.long()] = pages
        return out

    dense = ops.decode_attention(q, kc, vc, lengths)
    paged = ops.paged_decode_attention(q, pool(kc), pool(vc), tables,
                                       lengths)
    np.testing.assert_allclose(dense.numpy(), paged.numpy(),
                               **TOL["float32"])


def test_cuda_impl_on_cpu_tensors_raises():
    """Asking for a kernel with CPU tensors raises; nothing stands in for
    it and nothing is counted."""
    before = dict(kernel_guard().launches)
    x, s = (torch.from_numpy(a) for a in _norm_inputs(8, 32))
    q, kc, vc, lengths = (torch.from_numpy(a)
                          for a in _decode_case(2, 64, 4, 2, 16))
    pos = torch.arange(8, dtype=torch.int32)
    x3 = x.reshape(8, 1, 32)
    for call in (lambda: ops.rmsnorm(x, s, impl="cuda"),
                 lambda: ops.rotary(x3, pos, impl="cuda"),
                 lambda: ops.decode_attention(q, kc, vc, lengths,
                                              impl="cuda"),
                 lambda: ops.decode_attention(q, kc, vc, lengths,
                                              head_major=True, impl="cuda")):
        with pytest.raises(RuntimeError, match="impl='cuda' needs tensors"):
            call()
    for call in (lambda: rn.rmsnorm(x, s), lambda: rn.rmsnorm_bwd(x, s, x),
                 lambda: ro.rotary(x3, pos),
                 lambda: dec.decode_attention(q, kc, vc, lengths)):
        with pytest.raises(RuntimeError, match="launches a CUDA kernel"):
            call()
    assert kernel_guard().launches == before


def test_launch_counters_are_registered():
    for name in ("rmsnorm", "rmsnorm_bwd", "rotary", "decode_attention"):
        assert name in ops.KERNELS and name in ops.launch_counts()


def test_package_exports_the_reference_names_that_are_ported():
    """Every name ``repro.kernels`` exports: since ``ssd_scan`` and
    ``wkv6`` (B12, B13) every one is ported, none a stub."""
    want = set(jkernels.__all__)
    assert set(tkernels.__all__) == want
    for name in want:
        assert getattr(tkernels, name) is not None
    for name in ("ssd_scan", "wkv6"):
        assert getattr(tkernels, name) is getattr(ops, name)
