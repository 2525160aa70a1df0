"""The kernel library's SSD chunk scan (B12) and WKV6 recurrence (B13) on
the CPU: ``repro_torch.kernels.ops`` (the plain versions, as a CPU
tensor takes them) against the JAX package's ``ops`` in interpret mode,
as that package's own tests run its kernels, and against its ``ref``
oracles, on the same numpy inputs.  The CUDA kernels themselves are held
against the plain versions on the GPU by ``chip_smoke.py`` (phase 10).

Tolerances: ``tests/test_kernels.py``'s 1e-3 (rtol and atol) in f32
against the Pallas kernels and the sequential oracles; bf16 inputs 2e-2
against the oracle on the same rounded values (one bf16 rounding of the
output); between chunk lengths, 1e-5 of the largest magnitude of the
output (the chunk changes only the order of f32 sums, each off by a few
units of 2^-24 of the terms it adds).  B13 at strong decay is held to
the oracle alone: there the reference's Pallas kernel overflows (its
``k * exp(-cum)``), by design not the port's.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tkernels
from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops, ref

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
wkv = importlib.import_module("repro_torch.kernels.wkv6")

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ssd_inputs(b, s, h, p, n):
    x = _rand(0, (b, s, h, p))
    dt = np.log1p(np.exp(_rand(1, (b, s, h))))           # softplus
    a = -np.exp(_rand(2, (h,)))
    return [x, (dt * a).astype(np.float32), dt.astype(np.float32),
            _rand(3, (b, s, n)), _rand(4, (b, s, n))]


def _wkv_inputs(b, s, h, k, lo=0.45, hi=0.95, seed=0):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32)
                for _ in range(3))
    w = rng.uniform(lo, hi, (b, s, h, k)).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    return [r, kk, v, w, u]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 2, 16, 8, 16),
    (1, 100, 3, 8, 16, 32),
])
def test_ssd_scan_matches_pallas_and_oracle(b, s, h, p, n, chunk):
    arrays = _ssd_inputs(b, s, h, p, n)
    got = ops.ssd_scan(*_t(arrays))
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    kern = jops.ssd_scan(*_j(arrays), impl="interpret", chunk=chunk)
    want, state = jref.ref_ssd_scan(*_j(arrays))
    np.testing.assert_allclose(_np(got), _np(kern), **TOL)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    y, st = ref.ref_ssd_scan(*_t(arrays))      # (y, state), as the oracle
    assert torch.equal(y, got) and st.shape == (b, h, p, n)
    np.testing.assert_allclose(_np(st), _np(state), **TOL)


@pytest.mark.parametrize("b,s,h,k,chunk", [(2, 48, 2, 16, 16),
                                           (1, 70, 1, 32, 8)])
def test_wkv6_matches_pallas_and_oracle(b, s, h, k, chunk):
    arrays = _wkv_inputs(b, s, h, k)
    got = ops.wkv6(*_t(arrays))
    assert got.shape == (b, s, h, k) and got.dtype == torch.float32
    kern = jops.wkv6(*_j(arrays), impl="interpret", chunk=chunk)
    want, state = jref.ref_wkv6(*_j(arrays))
    np.testing.assert_allclose(_np(got), _np(kern), **TOL)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    y, st = ref.ref_wkv6(*_t(arrays))
    assert torch.equal(y, got) and st.shape == (b, h, k, k)
    np.testing.assert_allclose(_np(st), _np(state), **TOL)


def test_bf16_inputs_give_bf16_outputs_near_the_oracle():
    """x (B12) and r / k / v (B13) in bf16, the rest f32: y comes out in
    bf16 within one rounding of the oracle on the same rounded values."""
    arrays = _ssd_inputs(2, 40, 2, 16, 8)
    x16 = torch.from_numpy(arrays[0]).bfloat16()
    got = ops.ssd_scan(x16, *_t(arrays[1:]))
    want, _ = jref.ref_ssd_scan(jnp.asarray(x16.float().numpy()),
                                *_j(arrays[1:]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    arrays = _wkv_inputs(2, 40, 2, 16)
    rkv = [torch.from_numpy(a).bfloat16() for a in arrays[:3]]
    got = ops.wkv6(*rkv, *_t(arrays[3:]))
    want, _ = jref.ref_wkv6(*(jnp.asarray(t.float().numpy()) for t in rkv),
                            *_j(arrays[3:]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_wkv6_at_strong_decay_follows_the_oracle():
    """Chunk 64, S = 128, w in [0.1, 0.2]: a chunk's summed log-decay
    reaches about -147, past f32's exp range.  The port stays finite and
    within 1e-3 of the sequential oracle, at that chunk and at B13's."""
    arrays = _wkv_inputs(1, 128, 2, 16, lo=0.1, hi=0.2, seed=7)
    want, state = jref.ref_wkv6(*_j(arrays))
    assert np.isfinite(_np(want)).all()
    for got, st in (wkv.wkv6_plain(*_t(arrays), chunk=64),
                    (ops.wkv6(*_t(arrays)), None)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        if st is not None:
            np.testing.assert_allclose(_np(st), _np(state), **TOL)


def _rounding_apart(got, want):
    scale = float(np.abs(_np(want)).max())
    assert float(np.abs(_np(got) - _np(want)).max()) <= 1e-5 * scale


def test_results_do_not_depend_on_the_chunk():
    arrays = _ssd_inputs(1, 100, 3, 8, 16)
    y64, s64 = ssd.ssd_scan_plain(*_t(arrays))
    for chunk in (8, 16, 33, 100):
        y, s = ssd.ssd_scan_plain(*_t(arrays), chunk=chunk)
        _rounding_apart(y, y64)
        _rounding_apart(s, s64)
    arrays = _wkv_inputs(1, 70, 2, 16)
    y32, s32 = wkv.wkv6_plain(*_t(arrays))
    for chunk in (8, 16, 64, 70):
        y, s = wkv.wkv6_plain(*_t(arrays), chunk=chunk)
        _rounding_apart(y, y32)
        _rounding_apart(s, s32)


def test_state_carries_across_calls():
    """Two halves with the first half's state carried in equal one call
    (the plain versions' ``state0``, which the models use)."""
    arrays = _ssd_inputs(1, 64, 2, 8, 8)
    whole, s_all = ssd.ssd_scan_plain(*_t(arrays))
    first, s1 = ssd.ssd_scan_plain(*(t[:, :40] for t in _t(arrays)))
    second, s2 = ssd.ssd_scan_plain(*(t[:, 40:] for t in _t(arrays)),
                                    state0=s1)
    _rounding_apart(torch.cat([first, second], 1), whole)
    _rounding_apart(s2, s_all)
    arrays = _wkv_inputs(1, 64, 2, 8)
    whole, s_all = wkv.wkv6_plain(*_t(arrays))
    halves = [t[:, :40] for t in _t(arrays[:4])]
    rest = [t[:, 40:] for t in _t(arrays[:4])]
    u = torch.from_numpy(arrays[4])
    first, s1 = wkv.wkv6_plain(*halves, u)
    second, s2 = wkv.wkv6_plain(*rest, u, state0=s1)
    _rounding_apart(torch.cat([first, second], 1), whole)
    _rounding_apart(s2, s_all)


def test_cuda_on_cpu_tensors_raises():
    s_args = _t(_ssd_inputs(1, 8, 1, 4, 4))
    w_args = _t(_wkv_inputs(1, 8, 1, 4))
    with pytest.raises(RuntimeError, match="impl='cuda' needs tensors"):
        ops.ssd_scan(*s_args, impl="cuda")
    with pytest.raises(RuntimeError, match="impl='cuda' needs tensors"):
        ops.wkv6(*w_args, impl="cuda")
    with pytest.raises(RuntimeError, match="launches a CUDA kernel"):
        ssd.ssd_scan(*s_args)
    with pytest.raises(RuntimeError, match="launches a CUDA kernel"):
        wkv.wkv6(*w_args)
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.wkv6(*w_args, impl="interpret")


def test_package_exports_the_reference_names():
    assert tkernels.ssd_scan is ops.ssd_scan
    assert tkernels.wkv6 is ops.wkv6
    assert {"ssd_scan", "wkv6"} <= set(tkernels.__all__)
    assert ref.ref_ssd_scan is ssd.ssd_scan_plain
    assert ref.ref_wkv6 is wkv.wkv6_plain
    assert {"ref_ssd_scan", "ref_wkv6"} <= set(ref.__all__)
    assert {"ssd_scan", "wkv6"} <= set(ops.KERNELS)
    assert "not yet" not in tkernels.__doc__
