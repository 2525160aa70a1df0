"""B12 / B13's Hopper design on the CPU: the launch geometry, and plain
mirrors of the kernels' decompositions held against the plain versions
and the JAX package.

``launch_geometry`` (``repro_torch/kernels/ssd_scan.py``, ``wkv6.py``) is
what the wrappers pass to ``csrc/ssd_scan.cu`` / ``csrc/wkv6.cu``: the
path, grid, threads, chunk and sub-chunk, ring stages and shared memory a
block.  It is checked at ``chip_smoke.py`` phase 10's shapes (the CPU
tests' shapes, S = 999, the odd widths P, N = 40, 24 and K, V = 24, 40,
strong decay, full width) in f32, bf16 and f16: each takes the
tensor-core path, within the H100's 227 KB of shared memory a block,
every (b, h, slice) owned by one block, sub-chunks that tile the chunk;
what that path does not take goes to the FMA path.

The mirrors repeat in plain f32 PyTorch what the tensor-core kernels
compute: the TF32 split of every f32 operand (round to nearest, ties
away, by integer operations on the f32 bits, as ``cvt.rna.tf32.f32``),
products as a_lo b_hi + a_hi b_lo + a_hi b_hi (two passes where one side
is a 16-bit input, exact in TF32); B12's C B^T once per batch row and
chunk, dt folded into the score columns and B, exp(csum) into C; B13's
sub-chunks of 8 with reference points (running products of the decays,
the tables d, P, Q, T) and per-pair decays on the diagonal blocks only.
Tolerances: against the plain versions, phase 10's ``scan_close`` (2e-5
of the largest |y|, plus one ulp of a 16-bit y: 2^-7 of the value in
bf16, 2^-10 in f16); against the Pallas kernels in interpret mode and the
``ref`` oracles, ``tests/test_kernels.py``'s 1e-3; f16 through ``ops``
(the plain versions, as CPU tensors take them) against the Pallas
kernels on the same f16 values, 4e-3 (one f16 rounding of the output on
either side), as ``tests/test_torch_library_kernels.py`` holds f16.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
wkv = importlib.import_module("repro_torch.kernels.wkv6")

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
F16_TOL = dict(rtol=4e-3, atol=4e-3)
SCAN_F32_SLACK = 2e-5
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

#: chip_smoke.py phase 10's shapes: B12 (B, S, H, P, N), B13 (B, S, H, K,
#: V); the CPU tests' shapes, S = 999, odd widths, strong decay, full width
SSD_SHAPES = [(2, 64, 2, 16, 8), (1, 100, 3, 8, 16), (1, 999, 4, 64, 64),
              (1, 77, 2, 40, 24), (2, 2048, 64, 64, 64)]
WKV_SHAPES = [(2, 48, 2, 16, 16), (1, 70, 1, 32, 32), (1, 999, 3, 64, 64),
              (1, 45, 2, 24, 40), (2, 256, 4, 64, 64), (2, 2048, 32, 64, 64)]


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_geometry_at_phase_10_shapes(shape, dtype):
    b, s, h, p, n = shape
    geo = ssd.launch_geometry(shape, dtype)
    assert geo.path == "tc" and geo.threads == 256 and geo.stages == 2
    assert geo.smem <= ssd.MAX_SMEM
    blocks = geo.blocks()
    assert len(blocks) == len(set(blocks)) == b * h * -(-p // geo.rows)
    assert {r0 for _, _, r0 in blocks} == set(range(0, p, geo.rows))
    assert geo.cb_grid == (-(-s // ssd.CHUNK), b)
    assert geo.chunk == ssd.CHUNK and geo.chunk % geo.sub_chunk == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_geometry_at_phase_10_shapes(shape, dtype):
    b, s, h, k, v = shape
    geo = wkv.launch_geometry(shape, dtype)
    vs = geo.columns
    assert geo.path == "tc" and vs == wkv.SLICE == 32 and geo.stages == 2
    assert geo.smem <= wkv.MAX_SMEM
    blocks = geo.blocks()
    assert len(blocks) == len(set(blocks)) == b * h * -(-v // vs)
    assert {v0 for _, _, v0 in blocks} == set(range(0, v, vs))
    assert geo.chunk == wkv.CHUNK and geo.chunk % geo.sub_chunk == 0
    # one sub-chunk a warp
    assert geo.chunk // geo.sub_chunk == geo.threads // 32


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_geometry_past_65535_chunks(dtype):
    """The C B^T kernel puts the chunks on grid.x: an S of more than
    65,535 chunks, which the parent's kernel took, stays on the
    tensor-core path."""
    s = 65_537 * ssd.CHUNK - 5
    geo = ssd.launch_geometry((1, s, 2, 64, 64), dtype)
    assert geo.path == "tc" and geo.cb_grid == (65_537, 1)


def test_what_the_tensor_core_paths_do_not_take_goes_to_fma():
    """N or K past 64, rows not in 16-byte vectors, misaligned operands:
    the previous design's FMA kernels, never a refusal the parent did not
    make."""
    for shape, dtype in (((1, 64, 2, 16, 128), torch.float32),
                         ((1, 64, 2, 12, 16), torch.bfloat16),
                         ((1, 64, 2, 16, 6), torch.float16)):
        geo = ssd.launch_geometry(shape, dtype)
        assert geo.path == "fma" and geo.cb_grid is None
        assert geo.smem == ssd.fma_smem(shape[4]) <= ssd.MAX_SMEM
    assert ssd.launch_geometry((1, 64, 2, 16, 8), torch.float32,
                               aligned=False).path == "fma"
    for shape, dtype in (((1, 64, 2, 128, 64), torch.float32),
                         ((1, 64, 2, 20, 16), torch.bfloat16),
                         ((1, 64, 2, 16, 12), torch.float16)):
        geo = wkv.launch_geometry(shape, dtype)
        assert geo.path == "fma" and geo.chunk == wkv.FMA_CHUNK
        assert geo.smem == wkv.fma_smem(shape[3]) <= wkv.MAX_SMEM
    assert wkv.launch_geometry((1, 64, 2, 16, 16), torch.bfloat16,
                               aligned=False).path == "fma"
    with pytest.raises(ValueError, match="tiles"):
        ssd.launch_geometry((1, 64, 1, 8, 600), torch.float32)


# ----------------------------------------------------------- 3xTF32

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit significand bits), to nearest, ties
    away from zero, by integer operations on the bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a: torch.Tensor, b: torch.Tensor, a_exact=False, b_exact=False):
    """a @ b as the kernels take it: the small terms, then hi @ hi."""
    ah, al = (a, None) if a_exact else split(a)
    bh, bl = (b, None) if b_exact else split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if al is not None:
        acc = acc + al @ bh
    if bl is not None:
        acc = acc + ah @ bl
    return acc + ah @ bh


def test_tf32_rounding_and_16_bit_exactness():
    one = 1.0 + 2.0 ** -10                       # exactly representable
    half_up = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                            one + 2.0 ** -12, 1.0 + 2.0 ** -12])
    got = tf32(half_up)
    # ties go away from zero; below half rounds down
    assert got.tolist() == [one, -one, one, 1.0]
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    for dt in (torch.bfloat16, torch.float16):
        exact = vals.to(dt).float()
        assert torch.equal(tf32(exact), exact)
    hi, lo = split(vals)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    # what the two terms leave out is within 2^-22 of the value
    assert float(((hi.double() + lo.double()) - vals.double()).abs().div(
        vals.double().abs()).max()) <= 2.0 ** -22


# ------------------------------------------------------------ mirrors

def _pad(t: torch.Tensor, q: int, chunk: int, value: float = 0.0):
    if q == chunk:
        return t
    shape = list(t.shape)
    shape[1] = chunk - q
    return torch.cat([t, torch.full(shape, value)], 1)


def ssd_mirror(x, logd, dt, bmat, cmat, chunk=ssd.CHUNK):
    """B12's tensor-core path in plain PyTorch: G = C B^T once per batch
    row and chunk (3xTF32, lower triangle); per head S = G exp(csum_i -
    csum_j) dt_j, C~ = C exp(csum), B~ = B dt exp(csum_end - csum); y = S x
    + C~ state^T, state = exp(csum_end) state + x^T B~."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    exact = x.dtype != torch.float32
    state = torch.zeros((b, h, p, n))
    y = torch.empty((b, s, h, p), dtype=x.dtype)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        sl = slice(s0, s0 + q)
        xc = _pad(x[:, sl].float(), q, chunk).permute(0, 2, 1, 3)   # [B,H,Q,P]
        lc = _pad(logd[:, sl].float(), q, chunk).transpose(1, 2)   # [B,H,Q]
        dc = _pad(dt[:, sl].float(), q, chunk).transpose(1, 2)
        bc, cc = (_pad(t[:, sl].float(), q, chunk) for t in (bmat, cmat))
        g = torch.where(tri, mm(cc, bc.transpose(1, 2)), 0.0)      # [B,Q,Q]
        csum = torch.cumsum(lc, -1)
        end = csum[..., -1:]
        diff = torch.where(tri, csum[..., :, None] - csum[..., None, :], 0.0)
        sc = torch.where(tri, g[:, None] * torch.exp(diff)
                         * dc[..., None, :], 0.0)
        ct = cc[:, None] * torch.exp(csum)[..., None]
        bt = bc[:, None] * (dc * torch.exp(end - csum))[..., None]
        yc = mm(sc, xc, b_exact=exact) + mm(ct, state.transpose(-1, -2))
        y[:, sl] = yc[:, :, :q].transpose(1, 2).to(x.dtype)
        state = state * torch.exp(end)[..., None] + mm(
            xc.transpose(-1, -2), bt, a_exact=exact)
    return y, state


def wkv6_mirror(r, k, v, w, u, chunk=wkv.CHUNK, sub=wkv.SUB_CHUNK):
    """B13's tensor-core path in plain PyTorch: per sub-chunk of ``sub``
    positions, running products of the clamped decays give r~ (to the
    position before the sub-chunk), k^ (to its last position) and W (its
    total); from W the tables d_IJ, P_I, Q_J and the chunk's T.  Diagonal
    blocks take per-pair products, off-diagonal ones (r~ d_IJ) k^^T in
    3xTF32; y = scores v + (r~ P) state, state = T state + (k^ Q)^T v."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    exact = r.dtype != torch.float32
    nsub = chunk // sub
    rf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (r, k, v))
    wf = torch.clamp(w.float(), min=1e-20).permute(0, 2, 1, 3)
    uf = u.float()[None, :, None, :]                        # [1, H, 1, K]
    state = torch.zeros((b, h, kk, vv))
    y = torch.empty((b, s, h, vv), dtype=r.dtype)
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        sl = slice(s0, s0 + q)

        def rows(t, value=0.0):
            return _pad(t[:, :, sl].transpose(1, 2), q, chunk,
                        value).transpose(1, 2)

        rq, kq, vq, wq = rows(rf), rows(kf), rows(vf), rows(wf, 1.0)
        rs, ks, ws = (t.reshape(b, h, nsub, sub, kk) for t in (rq, kq, wq))
        pre = [torch.ones((b, h, nsub, kk))]
        for m in range(sub):
            pre.append(pre[-1] * ws[..., m, :])
        wsub = pre[sub]                                     # [B,H,NSUB,K]
        suf = [torch.ones((b, h, nsub, kk))]
        for m in range(sub - 1, 0, -1):
            suf.append(suf[-1] * ws[..., m, :])
        rt = rs * torch.stack(pre[:sub], 3)
        kh = ks * torch.stack(suf[::-1], 3)
        scores = torch.zeros((b, h, chunk, chunk))
        for blk in range(nsub):
            i0 = blk * sub
            for mi in range(sub):
                ri = rs[:, :, blk, mi]
                scores[:, :, i0 + mi, i0 + mi] = (
                    ri * uf[:, :, 0] * ks[:, :, blk, mi]).sum(-1)
                f = torch.ones_like(ri)
                for mj in range(mi - 1, -1, -1):
                    scores[:, :, i0 + mi, i0 + mj] = (
                        ri * ks[:, :, blk, mj] * f).sum(-1)
                    f = f * ws[:, :, blk, mj]
        d, pt, qt = {}, [], []
        for big in range(nsub):
            dd = torch.ones((b, h, kk))
            for small in range(big - 1, -1, -1):
                d[big, small] = dd
                dd = dd * wsub[:, :, small]
            pt.append(dd)
            qq = torch.ones((b, h, kk))
            for m in range(nsub - 1, big, -1):
                qq = qq * wsub[:, :, m]
            qt.append(qq)
        total = qt[0] * wsub[:, :, 0]
        for big in range(nsub):
            for small in range(big):
                a = rt[:, :, big] * d[big, small][:, :, None]
                scores[:, :, big * sub:(big + 1) * sub,
                       small * sub:(small + 1) * sub] = mm(
                    a, kh[:, :, small].transpose(-1, -2))
        rhat = (rt * torch.stack(pt, 2)[:, :, :, None]).reshape(b, h, chunk,
                                                                 kk)
        kbar = (kh * torch.stack(qt, 2)[:, :, :, None]).reshape(b, h, chunk,
                                                                 kk)
        yc = mm(scores, vq, b_exact=exact) + mm(rhat, state)
        y[:, sl] = yc[:, :, :q].transpose(1, 2).to(r.dtype)
        state = state * total[..., None] + mm(kbar.transpose(-1, -2), vq,
                                              b_exact=exact)
    return y, state


def scan_close(got, want):
    """Phase 10's rule: 2e-5 of the largest |y|, plus one ulp of a 16-bit
    y."""
    g, w = got.float(), want.float()
    bound = SCAN_F32_SLACK * float(w.abs().max()) + \
        ULP.get(got.dtype, 0.0) * w.abs()
    assert torch.isfinite(g).all()
    assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ssd_inputs(shape, seed=0):
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(_rand(rng, (b, s, h))))
    a = -np.exp(_rand(rng, (h,)))
    return [_rand(rng, (b, s, h, p)), (dt * a).astype(np.float32),
            dt.astype(np.float32), _rand(rng, (b, s, n)), _rand(rng, (b, s, n))]


def _wkv_inputs(shape, lo=0.45, hi=0.95, seed=0):
    b, s, h, k, v = shape
    rng = np.random.default_rng(seed)
    return [_rand(rng, (b, s, h, k)), _rand(rng, (b, s, h, k)),
            _rand(rng, (b, s, h, v)),
            rng.uniform(lo, hi, (b, s, h, k)).astype(np.float32),
            (_rand(rng, (h, k)) * 0.1).astype(np.float32)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(2, 64, 2, 16, 8), (1, 100, 3, 8, 16),
                                   (1, 77, 2, 40, 24)])
def test_ssd_mirror_matches_plain_pallas_and_oracle(shape):
    arrays = _ssd_inputs(shape)
    got, state = ssd_mirror(*_t(arrays))
    want, wstate = ssd.ssd_scan_plain(*_t(arrays))
    scan_close(got, want)
    scan_close(state, wstate)
    kern = jops.ssd_scan(*_j(arrays), impl="interpret", chunk=32)
    oracle, ostate = jref.ref_ssd_scan(*_j(arrays))
    np.testing.assert_allclose(_np(got), _np(kern), **TOL)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL)
    np.testing.assert_allclose(_np(state), _np(ostate), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ssd_mirror_16_bit_x_takes_two_passes(dtype):
    """A 16-bit x is an exact TF32 operand: S x and x^T B~ in two passes
    stay within phase 10's rule of the plain version on the same x."""
    arrays = _t(_ssd_inputs((1, 100, 3, 8, 16), seed=1))
    arrays[0] = arrays[0].to(dtype)
    got, _ = ssd_mirror(*arrays)
    assert got.dtype == dtype
    scan_close(got, ssd.ssd_scan_plain(*arrays)[0])


@pytest.mark.parametrize("shape", [(2, 48, 2, 16, 16), (1, 70, 1, 32, 32),
                                   (1, 45, 2, 24, 40)])
def test_wkv6_mirror_matches_plain_pallas_and_oracle(shape):
    arrays = _wkv_inputs(shape)
    got, state = wkv6_mirror(*_t(arrays))
    want, wstate = wkv.wkv6_plain(*_t(arrays))
    scan_close(got, want)
    scan_close(state, wstate)
    kern = jops.wkv6(*_j(arrays), impl="interpret", chunk=16)
    oracle, ostate = jref.ref_wkv6(*_j(arrays))
    np.testing.assert_allclose(_np(got), _np(kern), **TOL)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL)
    np.testing.assert_allclose(_np(state), _np(ostate), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wkv6_mirror_16_bit_inputs(dtype):
    arrays = _t(_wkv_inputs((1, 70, 2, 16, 24), seed=2))
    for i in range(3):
        arrays[i] = arrays[i].to(dtype)
    got, _ = wkv6_mirror(*arrays)
    assert got.dtype == dtype
    scan_close(got, wkv.wkv6_plain(*arrays)[0])


def test_wkv6_mirror_is_finite_at_strong_decay():
    """w in [0.05, 0.2]: a chunk of 64 sums log-decays to about -190,
    where the Pallas kernel's k * exp(-cum) overflows.  The products of
    decays stay finite and follow the plain version and the oracle."""
    arrays = _wkv_inputs((1, 160, 2, 16, 16), lo=0.05, hi=0.2, seed=3)
    got, state = wkv6_mirror(*_t(arrays))
    assert torch.isfinite(got).all() and torch.isfinite(state).all()
    scan_close(got, wkv.wkv6_plain(*_t(arrays))[0])
    oracle, _ = jref.ref_wkv6(*_j(arrays))
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL)
    pallas = jops.wkv6(*_j(arrays), impl="interpret", chunk=64)
    assert not np.isfinite(_np(pallas)).all()


def test_f16_through_ops_matches_pallas_interpret():
    """f16, which B12 / B13 take since queue C3's lift: ``ops`` on CPU
    tensors (the plain versions) against the Pallas kernels in interpret
    mode on the same f16 values."""
    arrays = _ssd_inputs((2, 64, 2, 16, 8), seed=4)
    x16 = np.asarray(arrays[0], np.float16)
    got = ops.ssd_scan(torch.from_numpy(x16), *_t(arrays[1:]))
    kern = jops.ssd_scan(jnp.asarray(x16), *_j(arrays[1:]),
                         impl="interpret", chunk=32)
    assert got.dtype == torch.float16 and kern.dtype == jnp.float16
    np.testing.assert_allclose(_np(got), _np(kern), **F16_TOL)
    arrays = _wkv_inputs((2, 48, 2, 16, 16), seed=5)
    rkv = [np.asarray(a, np.float16) for a in arrays[:3]]
    got = ops.wkv6(*(torch.from_numpy(a) for a in rkv), *_t(arrays[3:]))
    kern = jops.wkv6(*(jnp.asarray(a) for a in rkv), *_j(arrays[3:]),
                     impl="interpret", chunk=16)
    assert got.dtype == torch.float16 and kern.dtype == jnp.float16
    np.testing.assert_allclose(_np(got), _np(kern), **F16_TOL)
