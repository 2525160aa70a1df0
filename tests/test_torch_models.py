"""Port models on the CPU, held against the JAX package: the same numpy
inputs and the same weights (through ``from_jax_params``) go through
each JAX function and its counterpart in ``repro_torch``.

Small size: 2 layers, d_model 64, head_dim 16, vocab 256, float32.
Tolerance 2e-5 (rtol and atol) on f32 outputs: the two frameworks sum in
different orders.  Paged decode (the kernel's plain version here) vs
dense decode inside the port is held to the same 2e-5: one gathers and
sums whole rows, the other runs chunked online softmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny

from repro.models import attention as jattn, build_model as jbuild, layers as jlayers
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as tattn, build_model, layers as tlayers
from repro_torch.models.transformer import check_supported

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = {
    "qwen3": ("qwen3-1.7b", {}),                       # GQA 4/2, qk_norm
    "deepseek": ("deepseek-7b", {}),                   # MHA (G = 1)
    "swa": ("qwen3-1.7b", {"sliding_window": 8}),      # rolling window
    "bias": ("deepseek-7b", {"qkv_bias": True, "num_layers": 3}),
}


def _cfgs(case):
    arch, over = CASES[case]
    over = {"num_layers": 2, **over}
    jcfg = tiny(arch, **over)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)"""
    jcfg, tcfg = _cfgs(request.param)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:   # zero-initialised: give the biases real values
        rng = np.random.default_rng(5)
        blk = jparams["decoder"]["stack"]["0"]["attn"]
        for name in ("bq", "bk", "bv"):
            blk[name] = jnp.asarray(
                rng.standard_normal(blk[name].shape).astype(np.float32) * 0.1)
    tmodel = build_model(tcfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ----------------------------------------------------------------- layers
def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    _close(tlayers.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                                 torch.from_numpy(x), 1e-5),
           jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x), 1e-5))
    for theta in (1e4, 1e6):
        _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  theta),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    assert tlayers.round_up(151936, 256) == jlayers.round_up(151936, 256)


def test_project_qkv_and_mlp_match(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7)).copy()
    jblk = jax.tree.map(lambda a: a[1], jparams["decoder"]["stack"]["0"])
    tblk = tparams["layers"][1]
    want = jattn.project_qkv(jblk["attn"], jcfg, jnp.asarray(x),
                             jnp.asarray(pos))
    got = tattn.project_qkv(tblk["attn"], tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)
    _close(tlayers.mlp_apply(tblk["ffn"], torch.from_numpy(x), tcfg.act),
           jlayers.mlp_apply(jblk["ffn"], jnp.asarray(x), jcfg.act))


@pytest.mark.parametrize("causal,window,q_offset,s,t", [
    (True, 0, 0, 37, 37),
    (True, 8, 0, 37, 37),
    (True, 0, 20, 12, 40),     # prefill continuation over a longer cache
    (False, 0, 0, 9, 21),
])
def test_blockwise_attention_matches_reference_and_jax(causal, window,
                                                       q_offset, s, t):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.blockwise_attention(tq, tk, tv, q_block=8, kv_block=16, **kw)
    _close(got, tattn.reference_attention(tq, tk, tv, **kw))
    _close(got, jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=8,
        kv_block=16, **kw))
    _close(tattn.reference_attention(tq, tk, tv, **kw),
           jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw))


def test_write_kv_page_entries_axis_order():
    """Two advanced indices split by a slice: [R, NK, H] rows must land
    at pages[page_ids[r], :, offsets[r]] (checked with R != NK)."""
    rng = np.random.default_rng(3)
    pages = rng.standard_normal((6, 2, 4, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 8)).astype(np.float32)
    ids = np.array([5, 1, 3], np.int32)
    offs = np.array([0, 3, 2], np.int32)
    want = jattn.write_kv_page_entries(jnp.asarray(pages), jnp.asarray(new),
                                       jnp.asarray(ids), jnp.asarray(offs))
    tp = torch.from_numpy(pages.copy())
    got = tattn.write_kv_page_entries(tp, torch.from_numpy(new),
                                      torch.from_numpy(ids),
                                      torch.from_numpy(offs))
    assert got is tp                                   # in place
    np.testing.assert_array_equal(_np(got), _np(want))
    tables = np.array([[5, 1], [3, 0]], np.int32)
    np.testing.assert_array_equal(
        _np(tattn.gather_kv_pages(tp, torch.from_numpy(tables))),
        _np(jattn.gather_kv_pages(want, jnp.asarray(tables))))


# ------------------------------------------------------------------ model
def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_prefill_and_dense_decode_match(pair):
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    toks = _tokens(jcfg, 2, 11, 0)
    max_len = 24
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                max_len)
    tl, tcache = tmodel.prefill(tparams, {"tokens": toks}, max_len)
    _close(tl, jl)
    for layer, c in enumerate(tcache):
        _close(c["k"], jcache["stack"]["0"]["k"][layer])
        _close(c["v"], jcache["stack"]["0"]["v"][layer])
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    for step in range(4):
        pos = np.full((2,), 11 + step, np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos))
        tl, tcache = tmodel.decode_step(tparams, tcache,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(tl, jl)
        tok = np.argmax(_np(jl), -1).astype(np.int32)


def test_bucketed_prefill_reads_the_real_last_token(pair):
    """Right-padded prompt + ``length``: same logits as the JAX package
    (SWA rolling capture arranges by the real length)."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = _tokens(jcfg, 1, 11, 1)[0]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32,
                                jnp.asarray(11, jnp.int32))
    tl, tcache = tmodel.prefill(tparams, {"tokens": toks}, 32, 11)
    _close(tl, jl)
    _close(tcache[1]["k"], jcache["stack"]["0"]["k"][1])


def _paged_setup(model, cfg, slots, max_len, page):
    cap = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    n_pp = -(-cap // page)
    num_pages = 1 + slots * n_pp
    # slot s owns pages in a permuted order, as the pool hands them out
    perm = np.random.default_rng(9).permutation(np.arange(1, num_pages))
    tables = perm.reshape(slots, n_pp).astype(np.int32)
    return model.init_paged_cache(slots, num_pages, page), tables


def test_paged_decode_matches_jax_and_dense(pair):
    """Feed the same token stream through paged decode on both sides
    (slot 2 inactive), and through the port's dense decode."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    slots, max_len, page = 3, 32, 4
    jcache, tables = _paged_setup(jmodel, jcfg, slots, max_len, page)
    tcache, _ = _paged_setup(tmodel, tcfg, slots, max_len, page)
    dense = tmodel.init_cache(slots, max_len)
    active = np.array([True, True, False])
    stream = _tokens(jcfg, slots, 14, 2)
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
        dl, dense = tmodel.decode_step(tparams, dense, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        _close(tl[:2], _np(jl)[:2])
        _close(tl[:2], dl[:2])
    # the inactive row wrote nothing but the scratch page
    own = tables[2]
    assert all(float(c["k"][own.tolist()].abs().max()) == 0 for c in tcache)


def test_prefill_chunk_matches_jax_and_whole_prefill(pair):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    if jcfg.sliding_window:      # chunked prefill is dense-only
        with pytest.raises(AssertionError):
            tmodel.prefill_chunk(tparams, [], np.zeros((1, 4), np.int32),
                                 torch.zeros(4, dtype=torch.int32), 0, 4)
        return
    max_len, page, c = 32, 4, 8
    jcache, tables = _paged_setup(jmodel, jcfg, 1, max_len, page)
    tcache, _ = _paged_setup(tmodel, tcfg, 1, max_len, page)
    prompt = _tokens(jcfg, 1, 19, 3)[0]
    row = tables[0]
    for ctx in range(0, 19, c):
        n_valid = min(c, 19 - ctx)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :n_valid] = prompt[ctx:ctx + n_valid]
        jl, jcache = jmodel.prefill_chunk(
            jparams, jcache, jnp.asarray(chunk), jnp.asarray(row),
            jnp.asarray(ctx, jnp.int32), jnp.asarray(n_valid, jnp.int32))
        tl, tcache = tmodel.prefill_chunk(
            tparams, tcache, chunk, torch.from_numpy(row), ctx, n_valid)
        _close(tl, jl)
    whole, _ = tmodel.prefill(tparams, {"tokens": prompt[None]}, max_len)
    _close(tl, whole)


# -------------------------------------------------------------- converter
def test_converter_uses_every_leaf(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    jleaves = jax.tree.leaves(jparams)

    def leaves(t):
        if isinstance(t, dict):
            t = list(t.values())
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

    assert sum(a.size for a in jleaves) == \
        sum(t.numel() for t in leaves(tparams))
    assert len(tparams["layers"]) == jcfg.num_layers
    np.testing.assert_array_equal(
        _np(tparams["layers"][1]["attn"]["wq"]),
        np.asarray(jparams["decoder"]["stack"]["0"]["attn"]["wq"][1]))
    assert tparams["embed"]["table"].shape[0] % 256 == 0     # padded vocab
    extra = jax.tree.map(np.asarray, jparams)
    extra["decoder"]["rem"]["0"] = {"surprise": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="surprise"):
        from_jax_params(extra, tcfg, device="cpu")


def test_converter_casts_once_keeping_norm_scales_f32(pair):
    _, _, jparams, tcfg, _, _ = pair
    bf = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                         device="cpu", dtype=torch.bfloat16)
    blk = bf["layers"][0]
    assert blk["attn"]["wq"].dtype == torch.bfloat16
    assert bf["embed"]["table"].dtype == torch.bfloat16
    assert blk["ln1"]["scale"].dtype == torch.float32
    assert bf["final_ln"]["scale"].dtype == torch.float32


def test_own_init_has_the_reference_shapes_and_scales(pair):
    _, _, jparams, _, tmodel, tparams = pair
    own = tmodel.init(0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(own) == shapes(tparams)
    wq = own["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - wq.shape[0] ** -0.5) < 0.02
    assert abs(float(own["embed"]["table"].std()) - 0.02) < 0.005
    assert not torch.equal(tmodel.init(1)["layers"][0]["attn"]["wq"], wq)
    assert torch.equal(tmodel.init(0)["layers"][0]["attn"]["wq"], wq)


def test_unported_kinds_raise_naming_the_later_slice():
    base = reduced(get_config("qwen3-1.7b"))
    check_supported(dataclasses.replace(      # ported since the SSM slice
        base, block_pattern=("mamba2", "attention")))
    with pytest.raises(NotImplementedError, match="model-zoo"):
        check_supported(reduced(get_config("qwen3-1.7b"), moe=MoEConfig(
            num_experts=4, top_k=2)))
    with pytest.raises(NotImplementedError, match="model-zoo"):
        build_model(dataclasses.replace(base, frontend="vision"),
                    device="cpu")
