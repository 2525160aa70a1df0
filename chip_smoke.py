#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch``'s main path — serving full-width qwen3-1.7b
(random weights from a seed) through the paged ``Engine`` — and holds
every hand-written kernel against its plain PyTorch version:

1. environment: torch / CUDA / nvcc versions, the card and its power limit;
2. build every CUDA source under ``src/repro_torch/kernels/csrc`` into
   ``build/`` (one ``nvcc`` per source, started together);
3. ``paged_decode_attention`` vs its plain version on the card: small
   shapes in f32 (2e-5) and bf16 (2e-2, and within one bf16 rounding of
   the plain version run in f32) with permuted tables, ragged lengths
   and an empty row, with and without split-KV; every head
   tile, strided pools and the widest rows; stale-table-tail invariance
   (bit-equal); and the main-path shape, timed (CUDA-graph replay)
   beside the plain version, a ``scaled_dot_product_attention``
   yardstick and the card's bound;
4. the engine at full width: 12 greedy requests, then a shorter pass
   with chunked prefill; every request completes, no page leaks, and
   the kernel's launch count equals decode steps x layers;
5. a decode step mid-flight: its time by the host clock, its device
   kernels under ``torch.profiler``, and the same step taken through
   the kernel and through the plain version — logits agree;
6. the offload compiler at full width, bf16 and f32: plan the decode
   step, build the plans' kernels (one ``nvcc`` per plan, started
   together, and the Triton kernels), hold every distinct segment's
   kernel — ``fused_segment_grid`` (Triton) and ``fused_matmul_segment``
   (CUDA) — against its plain version on seeded inputs, time the bf16
   ones (CUDA-graph replay) beside the bound, the plain version and a
   library yardstick; serve the same 12 requests through
   ``Engine(offload=True)`` (launch counts = decode steps x layers for
   the attention and x segments of the plan for the fused kernels,
   ``plan_misses == 1``); profile an offloaded decode step; and take one
   decode step on the same state offloaded and eager, in bf16 and in
   f32 — logits agree;
7. a ``kernels`` JSON line, then the card line, then the result line.

Exits non-zero (printing no result line) without a CUDA device, when a
kernel fails to build or launch, or when any check fails.  Float32
matrix products run in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fused_elementwise as fe
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels.decode_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request

# datasheet figures of one H100 SXM (NVIDIA): the bound is computed
# against these whatever the card's power limit, which is printed beside
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SMALL_SHAPES = [   # (B, NP, page, NQ, NK, H)
    (2, 4, 64, 8, 2, 32),
    (3, 3, 32, 4, 4, 16),
    (1, 8, 16, 2, 1, 64),
]
EDGE_SHAPES = [    # head tiles of 1 (G=3) and 8, a full-warp row, H=256
    (2, 3, 16, 6, 2, 32),
    (2, 2, 32, 16, 2, 64),
    (2, 4, 16, 4, 4, 128),
    (1, 2, 8, 8, 1, 256),
]
MAIN_SHAPE = (8, 32, 64, 16, 8, 128)      # qwen3-1.7b, 8 slots, max_len 2048
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: a bf16 output is also held to what rounding explains: against the plain
#: version run in f32 on the same bf16 values, one rounding of the result
#: to bf16 (half an ulp, at most 2^-8 of the value) plus the f32 slack
BF16_RTOL, BF16_ATOL = 2.0 ** -8, 2e-5
#: full-width logits, kernel vs plain version: both round each layer's
#: attention output to bf16, and a one-ulp difference there grows over 28
#: layers.  The largest difference may be four bf16 ulps of a logit of
#: magnitude 4..8 (2^-5 each; 0.078 was measured), the mean difference
#: 2^-6 (0.0083 was measured at a mean |logit| of 0.8)
LOGIT_TOL = 0.125
LOGIT_MEAN_TOL = 2.0 ** -6
#: full-width bf16 logits, offloaded vs eager: every fused GEMM sums in
#: another order (WMMA, K split) than cuBLAS, so a bf16 rounding of a
#: product can flip by one ulp in any of the GEMMs of the 28 layers; held
#: to phase 5's bounds (0.0781 max and 0.0128 mean were measured, mean
#: |logit| 0.8)
OFFLOAD_LOGIT_TOL = LOGIT_TOL
OFFLOAD_LOGIT_MEAN_TOL = LOGIT_MEAN_TOL
#: full-width f32 logits, offloaded vs eager: only the summation order
#: differs (the fused GEMM's K split and FMA order against cuBLAS, the
#: segments' lane reductions), about 1e-6 of a value per op (1e-5 max and
#: 1e-6 mean were measured); a dropped term or a wrong scale in one layer
#: moves logits by far more than these bounds
LOGIT_TOL_F32 = 1e-4
LOGIT_MEAN_TOL_F32 = 1e-5
#: fused segment kernel vs its plain version on the card.  f32 grid
#: segments: 2e-5 (reduction order).  f32 anchored segments: sums of up
#: to K = 6144 products in another order (K split, FMA) than cuBLAS,
#: about sqrt(K) * 2^-24 of the row norm — held to 1e-4.  bf16: 2e-2,
#: and, since both sides round every op to bf16 the same way, within one
#: bf16 ulp (2^-7 relative) of the plain version plus 2^-7 of the
#: output's rms (a rounding flip upstream of a reduction)
SEG_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, n_iter: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn(i)`` over ``n_iter`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def graph_ms(fn, n_calls: int, replays: int = 20) -> float:
    """Mean device milliseconds of ``fn(i)``: ``n_calls`` calls captured
    into one CUDA graph and replayed, so that the host's time to enqueue
    a launch (Python wrapper included) is not in the number."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    return time_ms(lambda _: graph.replay(), replays) / n_calls


def make_case(shape, dtype, seed, *, empty_row=False, full_row=False):
    b, np_, page, nq, nk, h = shape
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pool = 1 + b * np_
    q = torch.randn((b, nq, h), generator=gen, device="cuda").to(dtype)
    k = torch.randn((pool, nk, page, h), generator=gen, device="cuda").to(dtype)
    v = torch.randn((pool, nk, page, h), generator=gen, device="cuda").to(dtype)
    perm = rng.permutation(np.arange(1, pool)).reshape(b, np_)
    lengths = rng.integers(1, np_ * page + 1, size=(b,))
    if empty_row:
        lengths[-1] = 0
    if full_row:
        lengths[0] = np_ * page
    tables = torch.as_tensor(perm.astype(np.int32), device="cuda")
    lengths = torch.as_tensor(lengths.astype(np.int32), device="cuda")
    return q, k, v, tables, lengths


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close_to_plain(got: torch.Tensor, want: torch.Tensor, args) -> bool:
    """``got`` against the plain version's ``want`` at the stated
    tolerance of the dtype; a bf16 result must besides lie within one
    rounding of the plain version computed in f32 on the same values."""
    dtype = got.dtype
    ok = torch.allclose(got.float(), want.float(), rtol=TOL[dtype],
                        atol=TOL[dtype])
    if dtype == torch.bfloat16:
        q, k, v, tables, lengths = args
        exact = paged_decode_attention_plain(q.float(), k.float(), v.float(),
                                             tables, lengths)
        ok = ok and torch.allclose(got.float(), exact, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    return ok


def phase_environment() -> str:
    print(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print("[1] " + next(ln for ln in run(
        [_build.find_nvcc(), "--version"]).splitlines() if "release" in ln))
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[1] allow_tf32 = False (float32 products in full float32)")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    for name, log in logs.items():
        usage = [ln for ln in log.splitlines() if "registers" in ln]
        regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in usage})
        spills = sum("spill" in ln and "0 bytes spill stores" not in ln
                     for ln in log.splitlines())
        print(f"[2] built {name}.cu in {_build.BUILD_SECONDS[name]:.1f} s "
              f"(registers per thread by instantiation: {regs}; "
              f"{spills} with spills)")
    print(f"[2] build total {time.perf_counter() - t0:.1f} s -> "
          f"{_build.build_dir()}")


def phase_kernel(card: str) -> dict:
    # small shapes, both dtypes, with and without the split-KV path
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(SMALL_SHAPES):
            args = make_case(shape, dtype, seed=i, empty_row=shape[0] > 1)
            want = paged_decode_attention_plain(*args)
            for splits in (None, 1, 3):
                got = paged_decode_attention(*args, num_splits=splits)
                torch.cuda.synchronize()
                err = max_err(got, want)
                ok = close_to_plain(got, want, args)
                print(f"[3] {shape} {str(dtype)[6:]} splits={splits}: "
                      f"max_abs_err {err:.3e}")
                check(ok, f"kernel vs plain at {shape} {dtype}")
                if shape[0] > 1:
                    check(bool((got[-1] == 0).all()),
                          "a row with length 0 must come out as zeros")

    # the kernel's other instantiations and its stride arithmetic: pools
    # that are every second token of a larger allocation
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(EDGE_SHAPES):
            q, k, v, tables, lengths = make_case(shape, dtype, seed=20 + i)
            if shape[5] * q.element_size() > 512:
                try:
                    paged_decode_attention(q, k, v, tables, lengths)
                except ValueError:
                    print(f"[3] {shape} {str(dtype)[6:]}: refused by the "
                          "wrapper (row wider than 32 16-byte vectors)")
                    continue
                check(False, f"{shape} {dtype} should have been refused")
            wide_k = torch.stack([k, torch.zeros_like(k)], 3).flatten(2, 3)
            wide_v = torch.stack([v, torch.zeros_like(v)], 3).flatten(2, 3)
            ks, vs = wide_k[:, :, ::2], wide_v[:, :, ::2]
            check(not ks.is_contiguous() and torch.equal(ks, k), "strided view")
            want = paged_decode_attention_plain(q, k, v, tables, lengths)
            for kk, vv, label in ((k, v, "contiguous"), (ks, vs, "strided")):
                got = paged_decode_attention(q, kk, vv, tables, lengths)
                torch.cuda.synchronize()
                check(close_to_plain(got, want, (q, k, v, tables, lengths)),
                      f"kernel vs plain at {shape} {dtype} {label} pools")
            print(f"[3] {shape} {str(dtype)[6:]} contiguous + strided "
                  f"pools: max_abs_err {max_err(got, want):.3e}")

    # stale table tails must not matter, bit for bit
    shape = (2, 4, 16, 4, 2, 32)
    q, k, v, _, _ = make_case(shape, torch.float32, seed=7)
    tables = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(2, 4)
    lengths = torch.tensor([16 + 3, 32], dtype=torch.int32, device="cuda")
    scrambled = tables.clone()
    scrambled[0, 2:] = 0
    scrambled[1, 2:] = torch.tensor([8, 1], dtype=torch.int32, device="cuda")
    for splits in (None, 1):
        base = paged_decode_attention(q, k, v, tables, lengths,
                                      num_splits=splits)
        out = paged_decode_attention(q, k, v, scrambled, lengths,
                                     num_splits=splits)
        check(torch.equal(base, out), "stale table tail changed the output")
    print("[3] stale-tail invariance: bit-equal")

    # the main-path shape: compare, then time against cold pools (the
    # model has one pool pair per layer, so no layer finds its pages in L2)
    dtype = torch.bfloat16
    b, np_, page, nq, nk, h = MAIN_SHAPE
    n_pools = 8
    cases = [make_case(MAIN_SHAPE, dtype, seed=100, full_row=True)]
    q, k0, v0, tables, lengths = cases[0]
    for j in range(1, n_pools):
        cases.append((q, torch.roll(k0, j, 0), torch.roll(v0, j, 0),
                      tables, lengths))
    want = paged_decode_attention_plain(*cases[0])
    got = paged_decode_attention(*cases[0])
    torch.cuda.synchronize()
    err = max_err(got, want)
    for splits in (None, 1, 2, 8):
        out = paged_decode_attention(*cases[0], num_splits=splits)
        check(close_to_plain(out, want, cases[0]),
              f"kernel vs plain, main-path shape, num_splits={splits}")

    def kernel(i):
        return paged_decode_attention(*cases[i % n_pools])

    n_iter = 10 * n_pools
    eager_ms = time_ms(kernel, n_iter)      # what a Python caller pays
    ms = graph_ms(kernel, n_pools)          # the kernel's time on the card
    ms_split = {n: graph_ms(lambda i: paged_decode_attention(
        *cases[i % n_pools], num_splits=n), n_pools) for n in (1, 2, 8)}
    plain_ms = time_ms(
        lambda i: paged_decode_attention_plain(*cases[i % n_pools]), n_pools)

    # yardstick: one PyTorch call over the already gathered cache
    t = np_ * page
    gathered = []
    for (_, kk, vv, _, _) in cases:
        kc = kk[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, nk, t, h)
        vc = vv[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, nk, t, h)
        gathered.append((kc.contiguous(), vc.contiguous()))
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa(i):
        kc, vc = gathered[i % n_pools]
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                              enable_gqa=True)
    lib = sdpa(0)[:, :, 0]
    check(torch.allclose(lib.float(), want.float(), rtol=TOL[dtype],
                         atol=TOL[dtype]), "yardstick disagrees with plain")
    library_ms = graph_ms(sdpa, n_pools)

    # the bound, from this run's lengths: every live K/V row, q, the live
    # table entries and lengths read once, out written once
    live = int(lengths.sum())
    live_pages = int(((lengths + page - 1) // page).sum())
    elt = q.element_size()
    n_bytes = (2 * live * nk * h * elt + 2 * q.numel() * elt
               + 4 * live_pages + 4 * b)
    flops = 4 * live * nq * h
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[3] main-path shape {MAIN_SHAPE} bf16, lengths "
          f"{lengths.tolist()}: max_abs_err {err:.3e}")
    print(f"[3]   kernel {ms:.4f} ms on the card (CUDA-graph replay, auto "
          f"splits; by num_splits: "
          f"{ {n: round(t, 4) for n, t in ms_split.items()} }), "
          f"{eager_ms:.4f} ms per eager call; plain {plain_ms:.4f} ms, "
          f"sdpa yardstick {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({n_bytes} bytes, {flops} flops; bound / kernel = "
          f"{bound_ms / ms:.1%}) on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def make_requests(cfg, lens, new_tokens, seed):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(1, cfg.vocab_size, size=int(n)).astype(
        np.int32), max_new_tokens=new_tokens, rid=i)
        for i, n in enumerate(lens)]


def serve(engine, reqs, label: str) -> int:
    """Run ``reqs`` to completion with the launch counts zeroed just
    before; returns the kernel's launches, read just after."""
    layers = engine.cfg.num_layers
    ops.reset_launch_counts()
    steps0 = engine.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["paged_decode_attention"]
    steps = engine.decode_steps - steps0
    tokens = sum(len(c.tokens) for c in done.values())
    print(f"[4] {label}: {len(reqs)} requests, {tokens} tokens, {steps} "
          f"decode steps, {wall:.2f} s wall, {tokens / wall:.1f} tokens/s, "
          f"{launches} kernel launches (each one wrapper call: the "
          f"attention kernel plus, when split, its combine kernel), "
          f"serve_counters "
          f"{ {k: v for k, v in engine.serve_counters.items() if v} }")
    for r in reqs:
        c = done[r.rid]
        check(c.status == "ok" and len(c.tokens) == r.max_new_tokens,
              f"request {r.rid}: status {c.status}/{c.reason}, "
              f"{len(c.tokens)} tokens")
        check(all(0 <= t < engine.cfg.vocab_size for t in c.tokens),
              f"request {r.rid}: token outside the vocabulary")
    check(engine.pool.used_pages == 0, "pages leaked")
    check(steps > 0 and launches == steps * layers,
          f"{launches} launches != {steps} decode steps x {layers} layers")
    return launches


def phase_engine():
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[4] qwen3-1.7b full width: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.2f} B parameters in {model.dtype}, "
          f"init {time.perf_counter() - t0:.1f} s")
    engine = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                    page_size=64)
    lens = np.random.default_rng(0).integers(16, 701, size=12)
    lens[0], lens[1] = 16, 700
    launches = serve(engine, make_requests(cfg, lens, 64, seed=1),
                     "whole-prompt prefill")

    chunked = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                     page_size=64, prefill_chunk=256)
    serve(chunked, make_requests(cfg, [300, 700, 520, 40], 16, seed=2),
          "prefill_chunk=256")
    del chunked
    print(f"[4] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return engine, launches


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def profile_decode(engine, steps: int = 5, tag: str = "[5]") -> None:
    """Where a decode step's time goes: ``steps`` steps by the host
    clock, then as many under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    layers = engine.cfg.num_layers
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side rows only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(e) > 0 and "Memcpy" not in e.key]
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / steps
    n_launch = sum(e.count for e in rows) / steps
    if not rows:
        print(f"{tag} decode step {step_ms:.2f} ms by the host clock; "
              "device time by kernel: not measured (profiler saw none)")
        return
    print(f"{tag} decode step, 8 active slots: {step_ms:.2f} ms by the host "
          f"clock; under the profiler {n_launch:.0f} device kernels a step "
          f"({n_launch / layers:.0f} a layer) busy for {busy_ms:.2f} ms "
          f"= {busy_ms / step_ms:.1%} of the step, the device idle for the "
          f"rest")
    for e in sorted(rows, key=dev_us, reverse=True)[:6]:
        print(f"{tag}   {dev_us(e) / 1e3 / steps:8.3f} ms/step  "
              f"{e.count / steps:6.0f} calls/step  {e.key[:90]}")


def phase_full_width_check(engine) -> None:
    """Stop the engine mid-flight and take one decode step twice on the
    same state: through the kernel, and through the plain version."""
    cfg = engine.cfg
    lens = [33, 700, 64, 129, 511, 250, 17, 400]
    for r in make_requests(cfg, lens, 32, seed=3):
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._pump()
    torch.cuda.synchronize()
    print(f"[5] admitted {len(lens)} prompts (lengths {lens}) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    profile_decode(engine)
    st = engine._state
    tables = torch.as_tensor(engine.pool.tables, device="cuda")
    active = st["active"]
    check(int(active.sum()) == len(lens), "not every slot is decoding")
    out = {}
    for impl in ("cuda", "ref"):
        # the step writes the same K/V entry either way, so repeating it
        # on the same state is harmless
        logits, _ = engine.model.decode_step_paged(
            engine.params, engine.cache, st["tok"], st["pos"], tables,
            active, max_len=engine.max_len, impl=impl)
        out[impl] = logits
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out["cuda"]).all()), "non-finite logits")
    check(out["cuda"].shape == (engine.slots, cfg.vocab_size), "logits shape")
    err = max_err(out["cuda"], out["ref"])
    live = out["ref"].float()
    mean_err = float((out["cuda"].float() - live).abs().mean())
    tok_c, tok_r = out["cuda"].argmax(-1), out["ref"].argmax(-1)
    same = int((tok_c == tok_r).sum())
    # a differing greedy token is accepted only as a tie within tolerance
    gap = (out["ref"].max(-1).values
           - out["ref"].gather(1, tok_c[:, None])[:, 0]).max()
    print(f"[5] full-width decode step, kernel vs plain version: max abs "
          f"logit difference {err:.4f} (tolerance {LOGIT_TOL}), mean "
          f"{mean_err:.5f} (tolerance {LOGIT_MEAN_TOL}, mean |logit| "
          f"{float(live.abs().mean()):.3f}; logits span "
          f"{float(out['ref'].min()):.2f}..{float(out['ref'].max()):.2f}), "
          f"same greedy token in {same}/{len(lens)} rows, largest gap "
          f"{float(gap):.4f}")
    check(err <= LOGIT_TOL, "full-width logits differ")
    check(mean_err <= LOGIT_MEAN_TOL, "full-width logits differ in the mean")
    check(float(gap) <= 2 * err, "greedy tokens differ beyond a tie")
    while engine._host_active.any():
        engine.step()
    engine.pop_finished()
    check(engine.pool.used_pages == 0, "pages leaked")


# ------------------------------------------------------------ offload (6)

def distinct_segments(plan) -> dict:
    """symbol -> (call spec, launches per decode step) over the plan."""
    from repro_torch.core.offload import kernel_symbol, segment_call

    out: dict = {}
    for seg in plan.segments:
        call = segment_call(plan.eqns, seg)
        sym = kernel_symbol(call)
        out[sym] = (call, out.get(sym, (call, 0))[1] + 1)
    return out


def seg_inputs(call: dict, seed: int, device: str = "cuda") -> list:
    """Seeded operands of one segment call at its real shapes: unit
    normals, weights scaled by 1/sqrt(K), norm scales near 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vals = []
    for i, (spec, dt) in enumerate(zip(call["specs"], call["dtypes"])):
        shape = (spec[1], spec[2])
        if dt.is_floating_point:
            v = torch.randn(shape, generator=gen, device=device)
            if spec[0] == "bulk_w":
                v = v / call["k"] ** 0.5
            elif spec[0] == "param" and dt == torch.float32:
                v = 1.0 + 0.1 * v
            vals.append(v.to(dt))
        else:
            vals.append(torch.randint(0, 7, shape, generator=gen,
                                      device=device).to(dt))
    return vals


def run_seg(call: dict, vals, impl: str):
    from repro_torch.core.offload import GRID_ROWS_BLOCK, MATMUL_ROWS_BLOCK

    progs = call["progs"]
    if call["kind"] == "grid":
        return ops.fused_segment_grid(
            progs.body, vals, call["specs"], rows=call["rows"],
            out_cols=call["out_cols"], out_dtypes=call["out_dtypes"],
            rows_block=GRID_ROWS_BLOCK, impl=impl)
    nl, nr = call["n_lhs"], call["n_rhs"]
    sp = call["specs"]
    return ops.fused_matmul_segment(
        progs.lhs, progs.rhs, progs.body, vals[:nl], sp[:nl],
        vals[nl:nl + nr], sp[nl:nl + nr], vals[nl + nr:], sp[nl + nr:],
        rows=call["rows"], k_dim=call["k"], n_dim=call["n"],
        acc_dtype=call["acc_dtype"], out_cols=call["out_cols"],
        out_dtypes=call["out_dtypes"], rows_block=MATMUL_ROWS_BLOCK,
        vmem_bytes=call["vmem_bytes"], sms=call["sms"], impl=impl)


def seg_close(got, want, dtype) -> tuple[bool, float]:
    rtol, atol = SEG_TOL[dtype]
    ok, err = True, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = max(err, max_err(g, w))
        ok = ok and torch.allclose(g, w, rtol=rtol, atol=atol)
        if dtype == torch.bfloat16:
            rms = float(w.pow(2).mean().sqrt())
            ok = ok and bool(((g - w).abs() <= 2.0 ** -7 * w.abs()
                              + 2.0 ** -7 * rms).all())
    return ok, err


def seg_bound(call: dict, vals, outs) -> tuple[float, str, int, int]:
    n_bytes = sum(v.numel() * v.element_size() for v in vals) + \
        sum(o.numel() * o.element_size() for o in outs)
    flops = 2 * call["rows"] * call["k"] * call["n"]
    dt = torch.bfloat16 if call["kind"] == "matmul" and \
        call["dtypes"][call["n_lhs"]] == torch.bfloat16 else torch.float32
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def yardstick(call: dict, vals):
    """One PyTorch call computing the segment's function, or None."""
    if call["kind"] == "matmul":
        nl = call["n_lhs"]
        lhs, rhs = vals[0], vals[nl]
        if call["progs"].lhs is not None or call["progs"].rhs is not None:
            return None
        return lambda: torch.matmul(lhs, rhs)
    prog = call["progs"].body
    if len(prog.inputs) == 2 and [i.role for i in prog.inputs] == \
            ["bulk", "param"] and len(prog.reductions) == 1:
        x, w = vals[0], vals[1].to(vals[0].dtype).reshape(-1)
        return lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-6)
    return None


def phase_offload_kernels(plans: dict, card: str) -> dict:
    """Build and check every distinct segment kernel of the plans; time
    the bf16 ones.  Returns the timing rows by symbol."""
    t0 = time.perf_counter()
    started = [(label, fm.start_library(plan.library, verbose=True))
               for label, plan in plans.items() if plan.library]
    rows = {}
    for label, plan in plans.items():
        dtype = torch.bfloat16 if label == "bf16" else torch.float32
        segs = distinct_segments(plan)
        n_grid = sum(c for call, c in segs.values() if call["kind"] == "grid")
        print(f"[6] {label} plan: {len(plan.segments)} fused segments a "
              f"decode step ({n_grid} grid, {len(plan.segments) - n_grid} "
              f"anchored), {len(segs)} distinct kernels, "
              f"{sum(not d.fused for d in plan.decisions)} declined; "
              f"traffic {plan.traffic_reduction:.2f}x")
        for sym, (call, count) in segs.items():
            if call["kind"] != "grid":
                continue
            vals = seg_inputs(call, seed=zlib.crc32(sym.encode()) % 1000)
            tc = time.perf_counter()
            got = run_seg(call, vals, "cuda")
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - tc
            want = run_seg(call, vals, "ref")
            ok, err = seg_close(got, want, dtype)
            regs, spills = fe.COMPILED.get(sym, (None, None))
            print(f"[6]   grid {sym} rows {call['rows']} cols "
                  f"{call['out_cols']} roles "
                  f"{[s[0] for s in call['specs']]} x{count}/step: "
                  f"max_abs_err {err:.3e}; first launch (Triton build) "
                  f"{compile_s:.2f} s, {regs} registers, {spills} spills")
            check(ok, f"{label} grid segment {sym} vs plain")
            rows[(label, sym)] = (call, count, vals)
    for label, handle in started:
        _, log = fm.finish_library(handle)
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in log.splitlines() if "registers" in ln})
        spills = sum("spill" in ln and "0 bytes spill stores" not in ln
                     for ln in log.splitlines())
        print(f"[6] {label} plan's CUDA translation unit: "
              f"{len(plans[label].library)} segments, registers per thread "
              f"{regs}, {spills} with spills")
    for label, plan in plans.items():
        dtype = torch.bfloat16 if label == "bf16" else torch.float32
        for sym, (call, count) in distinct_segments(plan).items():
            if call["kind"] != "matmul":
                continue
            vals = seg_inputs(call, seed=zlib.crc32(sym.encode()) % 1000)
            got = run_seg(call, vals, "cuda")
            torch.cuda.synchronize()
            want = run_seg(call, vals, "ref")
            ok, err = seg_close(got, want, dtype)
            print(f"[6]   anchored {sym} [{call['rows']}x{call['k']}]@"
                  f"[{call['k']}x{call['n']}] outs {call['out_cols']} "
                  f"x{count}/step: max_abs_err {err:.3e}")
            check(ok, f"{label} anchored segment {sym} vs plain")
            rows[(label, sym)] = (call, count, vals)
    print(f"[6] kernels built and checked in {time.perf_counter() - t0:.1f} s")

    timed = {}
    for (label, sym), (call, count, vals) in rows.items():
        if label != "bf16":
            continue
        copies = [vals] + [[v.clone() for v in vals] for _ in range(3)]
        outs = run_seg(call, vals, "cuda")
        ms = graph_ms(lambda i: run_seg(call, copies[i % 4], "cuda"), 4)
        plain_ms = time_ms(lambda i: run_seg(call, copies[i % 4], "ref"), 4)
        lib = yardstick(call, vals)
        library_ms = graph_ms(lambda i: lib(), 4) if lib else None
        bound_ms, bound_by, n_bytes, flops = seg_bound(call, vals, outs)
        timed[sym] = dict(kind=call["kind"], count=count, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=seg_close(outs, run_seg(call, vals, "ref"),
                                                torch.bfloat16)[1])
        print(f"[6]   {call['kind']} {sym} x{count}/step: {ms:.4f} ms on "
              f"the card (CUDA-graph replay), plain {plain_ms:.4f} ms, "
              f"library {'-' if library_ms is None else f'{library_ms:.4f}'} "
              f"ms, bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes, "
              f"{flops} flops; bound / kernel = {bound_ms / ms:.1%}) on {card}")
    return timed


def _roles_chain(x, p, r, t):
    return (x * p + r) * t - 1.0


def _bcast_chain(x, o):
    return torch.tanh(x) * o + 0.5


def _wide_chain(x, y, p):
    h = F.silu(x) * y
    return h * torch.rsqrt(torch.mean(h.float() * h.float(), -1,
                                      keepdim=True) + 1e-6).to(h.dtype) * p


def _padded_chain(x, p):
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
            * p).to(x.dtype), torch.softmax(xf, -1)


def phase_offload_roles() -> None:
    """Grid segments the decode plan does not hold, on the card: the
    ``tile`` and ``bcast`` roles, a padded row count, a 6144-lane
    reduction, two outputs — each kernel against its plain version."""
    from repro_torch.core import OffloadPolicy
    from repro_torch.core.offload import offload_report, segment_call

    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(11)

        def t(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        cases = [("bulk/param/rep/tile", _roles_chain,
                  (t(8, 25, 2048), t(2048), t(8, 1, 2048), t(1, 25, 2048))),
                 ("bcast", _bcast_chain, (t(8, 4, 16, 2, 128),
                                          t(8, 1, 16, 1, 128))),
                 ("6144 lanes, lane reduce", _wide_chain,
                  (t(8, 1, 6144), t(8, 1, 6144), t(6144))),
                 ("padded rows, two outputs", _padded_chain,
                  (t(8, 13, 2048), t(2048)))]
        for label, fn, args in cases:
            plan = offload_report(fn, *args,
                                  policy=OffloadPolicy(bulk_threshold=1024))
            check(len(plan.segments) == 1 and
                  plan.segments[0].matmul is None, f"{label}: one segment")
            call = segment_call(plan.eqns, plan.segments[0])
            vals = seg_inputs(call, seed=5)
            got = run_seg(call, vals, "cuda")
            torch.cuda.synchronize()
            want = run_seg(call, vals, "ref")
            ok, err = seg_close(got, want, dtype)
            rb, pad, _ = fe.segment_row_block(call["rows"], call["specs"], 16)
            print(f"[6]   grid {label} {str(dtype)[6:]}: rows {call['rows']} "
                  f"(block {rb}, pad {pad}), roles "
                  f"{[s[0] for s in call['specs']]}, cols {call['out_cols']}: "
                  f"max_abs_err {err:.3e}")
            check(ok, f"grid segment '{label}' {dtype} vs plain")


def serve_offload(engine, cfg, plan) -> dict:
    layers = cfg.num_layers
    n_grid = sum(s.matmul is None for s in plan.segments)
    n_mm = len(plan.segments) - n_grid
    lens = np.random.default_rng(0).integers(16, 701, size=12)
    lens[0], lens[1] = 16, 700
    reqs = make_requests(cfg, lens, 64, seed=1)
    ops.reset_launch_counts()
    steps0 = engine.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = engine.decode_steps - steps0
    tokens = sum(len(c.tokens) for c in done.values())
    print(f"[6] Engine(offload=True): {len(reqs)} requests, {tokens} tokens, "
          f"{steps} decode steps, {wall:.2f} s wall, {tokens / wall:.1f} "
          f"tokens/s, launches {counts}, offload_stats "
          f"{engine.offload_stats}")
    for r in reqs:
        c = done[r.rid]
        check(c.status == "ok" and len(c.tokens) == r.max_new_tokens,
              f"offloaded request {r.rid}: {c.status}/{c.reason}")
    check(engine.pool.used_pages == 0, "offloaded engine leaked pages")
    check(engine.offload_stats["plan_misses"] == 1, "plan_misses != 1")
    check(counts["paged_decode_attention"] == steps * layers,
          "attention launches != steps x layers")
    check(counts["fused_segment_grid"] == steps * n_grid,
          f"grid launches != steps x {n_grid}")
    check(counts["fused_matmul_segment"] == steps * n_mm,
          f"anchored launches != steps x {n_mm}")
    return counts


def offload_vs_eager(engine, label: str, tol: float, mean_tol: float, *,
                     profile: bool = False) -> None:
    """One decode step on the same state, offloaded and eager (after
    profiling offloaded steps when asked)."""
    cfg = engine.cfg
    lens = [33, 700, 64, 129, 511, 250, 17, 400]
    for r in make_requests(cfg, lens, 32, seed=3):
        engine.submit(r)
    engine._pump()
    if profile:
        profile_decode(engine, tag="[6]")
    st = engine._state
    tables = torch.as_tensor(engine.pool.tables, device="cuda")
    check(int(st["active"].sum()) == len(lens), "not every slot decodes")
    args = (engine.params, engine.cache, st["tok"], st["pos"], tables,
            st["active"])
    off, _ = engine._decode_offload(*args)
    eager, _ = engine.model.decode_step_paged(*args, max_len=engine.max_len)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(off).all()), f"{label}: non-finite logits")
    err = max_err(off, eager)
    mean_err = float((off.float() - eager.float()).abs().mean())
    tok_o = off.argmax(-1)
    same = int((tok_o == eager.argmax(-1)).sum())
    gap = float((eager.max(-1).values
                 - eager.gather(1, tok_o[:, None])[:, 0]).max())
    print(f"[6] {label} decode step, offloaded vs eager: max abs logit "
          f"difference {err:.3e} (tolerance {tol}), mean {mean_err:.3e} "
          f"(tolerance {mean_tol}, mean |logit| "
          f"{float(eager.float().abs().mean()):.3f}), same greedy token in "
          f"{same}/{len(lens)} rows, largest gap {gap:.4f}")
    check(err <= tol and mean_err <= mean_tol, f"{label} logits differ")
    check(gap <= 2 * err, f"{label} greedy tokens differ beyond a tie")
    while engine._host_active.any():
        engine.step()
    engine.pop_finished()
    check(engine.pool.used_pages == 0, "pages leaked")


def phase_offload(params, card: str):
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    off = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                 page_size=64, offload=True)
    plan16 = off.prepare_decode()
    t_plan = time.perf_counter() - t0
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = build_model(cfg32, device="cuda").init(0)
    off32 = Engine(cfg32, params32, device="cuda", slots=8, max_len=2048,
                   page_size=64, offload=True)
    plan32 = off32.prepare_decode()
    print(f"[6] captured and planned the full-width decode step in "
          f"{t_plan:.1f} s (bf16); decisions:")
    for line in str(plan16.report()).splitlines()[:1]:
        print(f"[6]   {line}")
    timed = phase_offload_kernels({"bf16": plan16, "f32": plan32}, card)
    phase_offload_roles()
    counts = serve_offload(off, cfg, plan16)
    offload_vs_eager(off, "bf16", OFFLOAD_LOGIT_TOL, OFFLOAD_LOGIT_MEAN_TOL,
                     profile=True)
    offload_vs_eager(off32, "f32", LOGIT_TOL_F32, LOGIT_MEAN_TOL_F32)
    del off32, params32
    return timed, counts


def kernel_entry(timed: dict, kind: str) -> dict:
    """The JSON fields of one fused kernel: its most-launched distinct
    segment that has a library yardstick (ties: the larger bound)."""
    rows = [r for r in timed.values() if r["kind"] == kind]
    best = max(rows, key=lambda r: (r["library_ms"] is not None,
                                    r["count"], r["bound_ms"]))
    return {k: best[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = phase_environment()
    phase_build()
    kernel = phase_kernel(card)
    engine, launches = phase_engine()
    phase_full_width_check(engine)
    params = engine.params
    del engine
    timed, counts = phase_offload(params, card)
    print(f"[7] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:219",
        "launches": launches, **kernel}, {
        "name": "fused_segment_grid", "route": "triton",
        "source": "src/repro_torch/kernels/fused_elementwise.py",
        "replaces": "src/repro/kernels/fused_elementwise.py:278",
        "launches": counts["fused_segment_grid"],
        **kernel_entry(timed, "grid")}, {
        "name": "fused_matmul_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul.cuh",
        "replaces": "src/repro/kernels/fused_matmul.py:240",
        "launches": counts["fused_matmul_segment"],
        **kernel_entry(timed, "matmul")}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
