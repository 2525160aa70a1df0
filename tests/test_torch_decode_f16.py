"""B1 (paged decode attention) and B11 (dense decode attention) in f16 on
the CPU, since queue C3's lift: the plain versions, which a CPU tensor
takes, against the JAX package's Pallas kernels in interpret mode (as
that package's own tests run them) and its ``ref`` oracles, on the same
numpy inputs; and a tiny ``dtype="float16"`` qwen3 served by the port's
``Engine`` against the JAX ``Engine``'s greedy tokens.  The CUDA kernels
are held against the plain versions in f16 on the GPU by
``chip_smoke.py`` (phase 9).

Tolerance: f16 4e-3 (one f16 rounding, 2^-11 of the value, on either
side; ``tests/test_torch_library_kernels.py``'s f16 bound).  Both
packages compute a model whose ``dtype`` is not ``"bfloat16"`` in f32
(``compute_dtype``, the reference's ``_dtype``), so the served model
runs in f32 on both sides and its tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny

from repro.kernels import ops as jops, ref as jref
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import _check_kv
from repro_torch.serve import Engine, Request

torch.set_num_threads(1)

TOL = dict(rtol=4e-3, atol=4e-3)
#: tests/test_torch_kernels.py's paged shapes: (B, NP, page, NQ, NK, H)
PAGED_SHAPES = [(2, 4, 64, 8, 2, 32), (3, 3, 32, 4, 4, 16),
                (1, 8, 16, 2, 1, 64)]
#: tests/test_torch_library_kernels.py's dense shapes: (B, T, NQ, NK, H)
DENSE_SHAPES = [(2, 256, 8, 2, 32), (3, 100, 4, 4, 16), (1, 513, 2, 1, 64)]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _pair(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.float16), \
        torch.from_numpy(a).to(torch.float16)


@pytest.mark.parametrize("b,np_,page,nq,nk,h", PAGED_SHAPES)
def test_paged_decode_attention_f16_matches_jax(b, np_, page, nq, nk, h):
    rng = np.random.default_rng(1)
    pool = 1 + b * np_
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, nq, h), (pool, nk, page, h), (pool, nk, page, h)))
    tables = rng.permutation(np.arange(1, pool)).reshape(b, np_).astype(
        np.int32)
    lengths = rng.integers(1, np_ * page + 1, size=(b,)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a) for a in (q, k, v))
    got = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(lengths))
    assert got.dtype == torch.float16 and got.shape == (b, nq, h)
    kern = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                       jnp.asarray(lengths),
                                       impl="interpret")
    oracle = jref.ref_paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                             jnp.asarray(lengths))
    assert kern.dtype == jnp.float16
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL)


@pytest.mark.parametrize("b,t,nq,nk,h", DENSE_SHAPES)
@pytest.mark.parametrize("head_major", [False, True])
def test_decode_attention_f16_matches_jax(b, t, nq, nk, h, head_major):
    """Both layouts against the Pallas kernel (every row; a length-0 row
    gives zeros on both sides) and the oracle (rows with keys)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, nq, h)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, t, nk, h)).astype(np.float32)
              for _ in range(2))
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    if b >= 3:
        lengths[1] = 0
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a) for a in (q, kc, vc))
    if head_major:
        tk, tv = (x.transpose(1, 2).contiguous() for x in (tk, tv))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                               head_major=head_major)
    assert got.dtype == torch.float16 and got.shape == (b, nq, h)
    kern = jops.decode_attention(jq, jk.transpose(0, 2, 1, 3),
                                 jv.transpose(0, 2, 1, 3),
                                 jnp.asarray(lengths), impl="interpret",
                                 kv_block=64, head_major=True)
    oracle = jref.ref_decode_attention(jq, jk, jv, jnp.asarray(lengths))
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL)
    live = lengths > 0
    np.testing.assert_allclose(_f32(got)[live], _f32(oracle)[live], **TOL)
    assert (_f32(got)[~live] == 0).all()


def test_the_kernels_take_f16_and_refuse_other_dtypes():
    """What the kernels' wrappers check before a launch: f16 passes
    (the refusal queue C3 lifted); f64 and mixed dtypes still raise."""
    q = torch.zeros((2, 4, 64), dtype=torch.float16)
    kv = torch.zeros((2, 32, 2, 64), dtype=torch.float16)
    _check_kv(q, kv, kv, "cache")
    with pytest.raises(TypeError, match="float16"):
        _check_kv(q.double(), kv.double(), kv.double(), "cache")
    with pytest.raises(TypeError, match="share dtype"):
        _check_kv(q, kv.bfloat16(), kv, "cache")


def test_f16_model_served_by_the_engine_matches_the_jax_engine():
    """A tiny ``dtype="float16"`` qwen3 through the port's paged
    ``Engine`` (its decode attention is B1's plain version on the CPU):
    the JAX ``Engine``'s greedy tokens, request for request."""
    jcfg = tiny("qwen3-1.7b", num_layers=2, dtype="float16")
    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               num_layers=2, dtype="float16")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, size=n).astype(np.int32)
               for n in (5, 17, 9, 30)]
    kw = dict(slots=2, max_len=48, page_size=8)
    want = JEngine(jcfg, jparams, **kw).generate(
        [JRequest(p, max_new_tokens=6, rid=i) for i, p in enumerate(prompts)])
    got = Engine(tcfg, tparams, device="cpu", **kw).generate(
        [Request(p, max_new_tokens=6, rid=i) for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].status == want[i].status == "ok"
        assert got[i].tokens == want[i].tokens, i
