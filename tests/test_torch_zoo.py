"""The hybrid Mamba2 stack (zamba2) and RWKV6 in the port, on the CPU,
held against the JAX package: the same numpy inputs and the same
weights (through ``from_jax_params``) go through each JAX function and
its counterpart in ``repro_torch``.

* ``ssd_chunked`` / ``wkv6_chunked`` against the JAX functions and the
  step-by-step oracles ``reference_ssd`` / ``reference_wkv6``, outputs
  and final state: 1e-4 (``tests/test_models.py``'s bound; f32 sums over
  chunks in another order);
* tiny zamba2 (12 layers: two periods of five mamba2 blocks and one tied
  shared-attention block) and tiny rwkv6 (2 layers), d_model 64, f32:
  full-sequence logits, prefill logits and caches, paged decode logits
  with an inactive slot, all within 1e-4 of the JAX model (recurrences
  over the sequence in f32 in another summation order);
* greedy tokens of the port's paged ``Engine`` equal to the JAX paged
  ``Engine``'s on ``tests/test_serve_paged.py``'s recurrent setup (slots
  2, max_len 32, page 8, 4 requests).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny

from repro.models import build_model as jbuild, layers as jlayers
from repro.models import rwkv as jrwkv, ssm as jssm
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import build_model, layers as tlayers
from repro_torch.models import rwkv as trwkv, ssm as tssm
from repro_torch.models.transformer import layer_kinds
from repro_torch.serve import Engine, Request

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)

CASES = {"zamba2": ("zamba2-1.2b", 12), "rwkv6": ("rwkv6-1.6b", 2)}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------- chunked scans
def test_ssd_chunked_matches_jax_and_sequential():
    b, s, h, p, n = 2, 50, 3, 8, 4
    xh = _rand(0, (b, s, h, p))
    dt = np.log1p(np.exp(_rand(1, (b, s, h))))
    a = -np.exp(_rand(2, (h,)))
    bm, cm = _rand(3, (b, s, n)), _rand(4, (b, s, n))
    st0 = _rand(5, (b, h, p, n)) * 0.1
    args = (xh, dt, a, bm, cm)
    for state0 in (None, st0):
        j0 = None if state0 is None else jnp.asarray(state0)
        t0 = None if state0 is None else torch.from_numpy(state0)
        y, st = tssm.ssd_chunked(*map(torch.from_numpy, args), 16,
                                 state0=t0)
        jy, jst = jssm.ssd_chunked(*map(jnp.asarray, args), 16, state0=j0)
        ry, rst = tssm.reference_ssd(*map(torch.from_numpy, args), t0)
        jry, jrst = jssm.reference_ssd(*map(jnp.asarray, args), j0)
        assert y.shape == (b, s, h, p) and st.dtype == torch.float32
        for got, want in ((y, jy), (st, jst), (y, jry), (st, jrst),
                          (ry, jry), (rst, jrst)):
            _close(got, want)


def test_wkv6_chunked_matches_jax_and_sequential():
    b, s, h, kk = 2, 45, 2, 8
    r, k, v = (_rand(i, (b, s, h, kk)) for i in range(3))
    w = (1 / (1 + np.exp(-_rand(3, (b, s, h, kk))))) * 0.5 + 0.45
    u = _rand(4, (h, kk)) * 0.1
    st0 = _rand(5, (b, h, kk, kk)) * 0.1
    args = (r, k, v, w.astype(np.float32), u)
    for state0 in (None, st0):
        j0 = None if state0 is None else jnp.asarray(state0)
        t0 = None if state0 is None else torch.from_numpy(state0)
        y, st = trwkv.wkv6_chunked(*map(torch.from_numpy, args), chunk=16,
                                   state0=t0)
        jy, jst = jrwkv.wkv6_chunked(*map(jnp.asarray, args), chunk=16,
                                     state0=j0)
        ry, rst = trwkv.reference_wkv6(*map(torch.from_numpy, args), t0)
        jry, jrst = jrwkv.reference_wkv6(*map(jnp.asarray, args), j0)
        for got, want in ((y, jy), (st, jst), (y, jry), (st, jrst),
                          (ry, jry), (rst, jrst)):
            _close(got, want)


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)"""
    arch, layers = CASES[request.param]
    jcfg = tiny(arch, num_layers=layers)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               num_layers=layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_forward_logits_match_jax(pair):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    toks = _tokens(jcfg, 2, 37, 0)
    jh, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    th, _, _ = tmodel.forward(tparams, {"tokens": toks})
    _close(th, jh)
    _close(tlayers.lm_head_apply(tparams["embed"], th, tcfg.vocab_size),
           jlayers.lm_head_apply(jparams["embed"], jh, jcfg.vocab_size))


def test_prefill_and_paged_decode_match_jax(pair):
    """Prefill one prompt per slot, then decode a token stream through
    the paged cache on both sides with slot 2 inactive: logits agree and
    the inactive slot's recurrent rows stay as they were."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    slots, max_len, page = 3, 32, 8
    n_pp = max_len // page
    num_pages = 1 + slots * n_pp
    tables = np.random.default_rng(9).permutation(
        np.arange(1, num_pages)).reshape(slots, n_pp).astype(np.int32)
    jcache = jmodel.init_paged_cache(slots, num_pages, page)
    tcache = tmodel.init_paged_cache(slots, num_pages, page)
    # the prefill's cache, checked leaf by leaf against the JAX one
    prompt = _tokens(jcfg, 1, 13, 1)
    jl, jc1 = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                             max_len)
    tl, tc1 = tmodel.prefill(tparams, {"tokens": prompt}, max_len)
    _close(tl, jl)
    kinds = layer_kinds(tcfg)
    period = len(tcfg.block_pattern)
    for layer, c in enumerate(tc1):
        p_, pos = divmod(layer, period)
        jc = jc1["stack"][str(pos)] if p_ < tcfg.num_layers // period \
            else jc1["rem"][str(pos)]
        for name, t in c.items():
            want = jc[name][p_] if p_ < tcfg.num_layers // period \
                else jc[name]
            _close(t, want)
        assert set(c) == set(jc)
    assert "mamba2" in kinds or "rwkv6" in kinds

    # every slot's recurrent rows start from the same random state
    rng = np.random.default_rng(11)
    jcache = jax.tree.map(np.array, jcache)
    for layer, c in enumerate(tcache):
        p_, pos = divmod(layer, period)
        for name, t in c.items():
            if name in ("k", "v"):
                continue
            vals = (rng.standard_normal(t.shape) * 0.5).astype(np.float32)
            t.copy_(torch.from_numpy(vals))
            if p_ < tcfg.num_layers // period:
                jcache["stack"][str(pos)][name][p_] = vals
            else:
                jcache["rem"][str(pos)][name] = vals
    jcache = jax.tree.map(jnp.asarray, jcache)

    active = np.array([True, True, False])
    stream = _tokens(jcfg, slots, 10, 2)
    start = [{k: t.clone() for k, t in c.items() if k not in ("k", "v")}
             for c in tcache]
    for step in range(stream.shape[1]):
        tok = stream[:, step]
        pos = np.full((slots,), step, np.int32)
        jl, jcache = jmodel.decode_step_paged(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(tables), jnp.asarray(active), max_len=max_len)
        tl, tcache = tmodel.decode_step_paged(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(tables), torch.from_numpy(active),
            max_len=max_len)
        _close(tl[:2], _np(jl)[:2])
    for c, c0 in zip(tcache, start):
        for name, t0 in c0.items():
            assert torch.equal(c[name][2], t0[2]), name      # frozen
            assert not torch.equal(c[name][:2], t0[:2]), name  # advanced


def test_engine_tokens_match_jax_engine(pair):
    """Greedy tokens of the port's paged Engine equal the JAX paged
    Engine's: recurrent rows are written at admit and frozen for the
    inactive slot while another request decodes."""
    jcfg, _, jparams, tcfg, _, tparams = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250, size=rng.integers(4, 12)).astype(
        np.int32) for _ in range(4)]
    kw = dict(slots=2, max_len=32, page_size=8)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = Engine(tcfg, tparams, device="cpu", **kw)
    assert not teng.bucket_prompts and not teng._chunkable
    want = jeng.generate([JRequest(p, max_new_tokens=6, rid=i)
                          for i, p in enumerate(prompts)])
    got = teng.generate([Request(p, max_new_tokens=6, rid=i)
                         for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[i].status == want[i].status == "ok"
        assert got[i].tokens == want[i].tokens, i
        assert len(got[i].tokens) == 6
    assert teng.pool.used_pages == 0


def test_tied_shared_attention_is_one_dict():
    jcfg = tiny("zamba2-1.2b", num_layers=12)
    tcfg = dataclasses.replace(reduced(get_config("zamba2-1.2b")),
                               dtype="float32", num_layers=12)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu", dtype=torch.bfloat16)
    kinds = layer_kinds(tcfg)
    shared = [i for i, k in enumerate(kinds) if k == "shared_attention"]
    assert shared == [5, 11]
    first = tparams["layers"][5]
    assert all(tparams["layers"][i] is first for i in shared)
    np.testing.assert_array_equal(
        _np(first["attn"]["wq"]),
        _np(jnp.asarray(jparams["decoder"]["shared_attn"]["attn"]["wq"],
                        jnp.bfloat16)))
    own = build_model(tcfg, device="cpu").init(0)["layers"]
    assert own[5] is own[11] and own[4] is not own[5]
    # each shared position keeps its own KV pool
    cache = build_model(tcfg, device="cpu").init_paged_cache(2, 5, 8)
    assert cache[5]["k"] is not cache[11]["k"]
    # the f32 leaves of the recurrent blocks stay f32 in a bf16 copy
    mamba = tparams["layers"][0]["mamba"]
    assert mamba["in_proj"].dtype == torch.bfloat16
    assert mamba["A_log"].dtype == mamba["dt_bias"].dtype == torch.float32

