"""B9's Hopper launch geometry and the backward's summation order, on the
CPU.

``launch_geometry`` (``repro_torch/kernels/rmsnorm.py``) is what the
wrappers pass to ``csrc/rmsnorm.cu``: the path, threads a block and a
row, ring stages, vectors a thread, shared memory, grid and the
backward's finishers.  It
is checked at ``chip_smoke.py`` phase 9's shapes (the CPU tests' rows,
rows too wide for the ring, up to D = 40,968) and at the full widths
(qwen3-1.7b's hidden states and q-norm, d_model 16,384), in f32, bf16 and
f16, both directions: every row is taken by exactly one pipeline unit,
the units' shares differ by at most a row, shared memory stays within the
H100's 227 KB a block, narrow rows take the register path and wide rows
that fit in shared memory the staged kernels (the rest, direct).

The backward sums ds in a fixed order: each row group's rows in order, a
block's groups in order, then the blocks' partials in runs of blocks
summed by the finishers.  ``ds_kernel_order`` repeats that order in
plain f32 PyTorch from the geometry; it is held against
``rmsnorm_bwd_plain`` and the JAX package's ``_bwd_kernel`` (interpret
mode) within phase 9's rule for an f32 ds: 2e-5 of |ds| plus 2^-19 of
the column's sum of |g * xhat| (each order errs by a few units of 2^-24
of that sum per addition level).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

rn = importlib.import_module("repro_torch.kernels.rmsnorm")

torch.set_num_threads(1)

#: an H100's SMs and a block's shared memory
SMS = 132
SMEM_BLOCK = 232_448
#: chip_smoke.py phase 9's NORM_SMALL, then its full widths: the hidden
#: states [2, 1024, 2048], the q-norm [2, 1024, 16, 128], d_model 16,384
NORM_SMALL = [(64, 128), (33, 96), (257, 64), (31, 99), (5, 8192),
              (7, 2050), (3, 4099), (300, 8200), (5, 16392), (140, 40968)]
FULL = [(2048, 2048), (32768, 128), (2048, 16384)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}
#: phase 9's bound on an f32 ds, in units of the column's sum of |g xhat|
DS_ULPS_F32 = 2.0 ** -19


def _expected_path(d, dtype, backward, aligned=True) -> str:
    """Where a row goes: 16-byte vectors and at most 256 of them (8 a lane
    of a warp; 128 in the f32 backward), registers; wider, up to 32 f32 of the scale a thread of
    512 (D <= 16,384; backward at most 4 vectors a thread, so f32 D <=
    8,192) and one row of x (and g) beside the ring's 1 KB of barriers and
    sums within a block's shared memory, staged; else direct."""
    elt = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elt
    if not aligned or d % vec:
        return "direct"
    if d // vec <= (128 if backward and elt == 4 else 256):
        return "registers"
    row = d * elt * (2 if backward else 1)
    widest = 512 * 4 * vec if backward else 512 * 32
    if d <= widest and row + 1024 <= SMEM_BLOCK - 1024:
        return "staged"
    return "direct"


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rows,d", NORM_SMALL + FULL)
def test_geometry(rows, d, dt, backward):
    dtype = DTYPES[dt]
    elt = torch.empty((), dtype=dtype).element_size()
    geo = rn.launch_geometry(rows, d, dtype, backward=backward, sms=SMS)
    units = [geo.unit_rows(i) for i in range(geo.grid * geo.units)]
    assert [r for u in units for r in u] == list(range(rows))
    sizes = [len(u) for u in units]
    assert max(sizes) - min(sizes) <= 1
    assert geo.rows_per_block == -(-rows // geo.grid)
    assert 0 <= geo.smem <= SMEM_BLOCK
    assert 1 <= geo.grid <= geo.blocks_per_sm * SMS
    assert geo.path == _expected_path(d, dtype, backward)
    if geo.path == "registers":
        assert geo.vec * elt == 16 and geo.nv in (1, 2, 4, 8)
        assert geo.tpr <= 32 and geo.tpr * geo.nv * geo.vec >= d
        assert geo.units == geo.threads // 32
        assert geo.smem == rn.registers_smem(d, geo.tpr, backward)
    if geo.path == "staged":
        assert geo.vec * elt == 16 and geo.nv in (1, 2, 4, 8)
        assert geo.tpr == geo.threads and geo.units == 1
        assert geo.threads * geo.nv * geo.vec >= d
        assert geo.nv * geo.vec <= 32 and 1 <= geo.stages <= 4
        assert not backward or geo.nv <= 4
        # the slots' bulk copies: 16-byte multiples
        assert d * elt % 16 == 0
        assert geo.smem == rn.staged_smem(d, elt, geo.stages, backward)
    if backward:
        assert 1 <= geo.finishers <= min(geo.grid, d)
        assert geo.smem >= 16 * geo.threads


@pytest.mark.parametrize("dt", list(DTYPES))
def test_misaligned_and_odd_rows_take_the_direct_kernels(dt):
    """A pointer off 16 bytes or a row no multiple of 16 bytes: the
    direct kernels, scalar loads."""
    dtype = DTYPES[dt]
    for rows, d, aligned in ((64, 2048, False), (31, 99, True)):
        for backward in (False, True):
            geo = rn.launch_geometry(rows, d, dtype, backward=backward,
                                     sms=SMS, aligned=aligned)
            assert geo.path == "direct" and geo.vec == 1


def ds_kernel_order(x, scale, g, eps, geo) -> torch.Tensor:
    """ds (f32) summed in B9-bwd's order for ``geo``: g * xhat a row;
    each row group's rows in order (a warp's rows dealt to its row groups
    in turn on the register path), a block's groups in order, then each
    column's blocks in the finisher's runs (a slice of 4-column groups a
    finisher), the runs in order."""
    x2, g2 = x.float(), g.float()
    inv = torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + eps)
    prod = g2 * (x2 * inv)
    rows, d = prod.shape
    subs = geo.row_groups
    parts = []
    for b in range(geo.grid):
        part = torch.zeros(d)
        for u in range(geo.units):
            mine = geo.unit_rows(b * geo.units + u)
            for sub in range(subs):
                acc = torch.zeros(d)
                for r in mine[sub::subs]:
                    acc = acc + prod[r]
                part = part + acc
        parts.append(part)
    ds = torch.empty(d)
    fin, nblk = geo.finishers, geo.grid
    w = 4 if d % 4 == 0 else 1          # columns a group (a float4)
    ng = d // w
    for f in range(fin):
        g0, g1 = ng * f // fin, ng * (f + 1) // fin
        cols = min(g1 - g0, geo.threads)
        segs = geo.threads // cols
        c0, c1 = g0 * w, g1 * w
        tot = torch.zeros(c1 - c0)
        for seg in range(segs):
            run = torch.zeros(c1 - c0)
            for b in range(nblk * seg // segs, nblk * (seg + 1) // segs):
                run = run + parts[b][c0:c1]
            tot = tot + run
        ds[c0:c1] = tot
    return ds.to(scale.dtype)


@pytest.mark.parametrize("rows,d,sms", [
    (64, 128, SMS), (257, 64, 4), (33, 96, 2), (31, 99, SMS),
    (5, 8192, SMS), (300, 2048, 8), (300, 8200, SMS)])
def test_ds_in_kernel_order(rows, d, sms):
    """The mirror of the kernel's order against the plain version and the
    JAX package's ``_bwd_kernel`` (interpret mode): f32, phase 9's rule.
    Small ``sms`` values spread a few rows over several blocks."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (rng.standard_normal((d,)) * 0.1 + 1.0).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    tx, ts, tg = (torch.from_numpy(a) for a in (x, s, g))
    eps = 1e-5
    geo = rn.launch_geometry(rows, d, torch.float32, backward=True,
                             sms=sms)
    got = ds_kernel_order(tx, ts, tg, eps, geo)
    _, want = rn.rmsnorm_bwd_plain(tx, ts, tg, eps)
    _, vjp = jax.vjp(lambda a, b: jops.rmsnorm(
        a, b, eps=eps, impl="interpret", rows_block=32), jnp.asarray(x),
        jnp.asarray(s))
    jds = torch.from_numpy(np.array(vjp(jnp.asarray(g))[1]))
    xhat = tx * torch.rsqrt((tx * tx).mean(-1, keepdim=True) + eps)
    mass = (tg * xhat).abs().sum(0)
    for other in (want, jds):
        bound = 2e-5 * other.abs() + DS_ULPS_F32 * mass
        assert ((got - other).abs() <= bound).all(), \
            float((got - other).abs().max())
