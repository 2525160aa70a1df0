#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch``'s main paths — serving full-width qwen3-1.7b
(random weights from a seed) through the paged ``Engine``, and training
it through the offload compiler — and holds every hand-written kernel
against its plain PyTorch version:

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
7. training full-width qwen3-1.7b (f32 master parameters, bf16 compute,
   2 x 1024 tokens a step) through ``make_train_step(offload=True)``:
   plan the loss, every fused segment's backward and the update, build
   all their translation units together, take three steps (launch counts
   a step, the host clock, the device-busy time under the profiler, peak
   memory, then one more step split into forward, backward and update
   peaks); the offloaded step against the plain eager step in bf16 and,
   at two layers, in f32; AdamW through ``apply_updates(use_kernel=True)``
   against ``use_kernel=False`` and B8 against its plain version; every
   distinct fused segment of the training plans — grid (B2), fwd (B3,
   with the GEMM path each takes), dlhs (B4), drhs (B6) — at its own
   shapes and strides, and B4 / B6 with ``batch`` = 2, against their
   plain versions, the bf16 anchored ones and the most launched grid
   ones timed beside the bound, the plain version and a library
   yardstick;
8. a ``kernels`` JSON line, then the card line, then the result line.

Exits non-zero (printing no result line) without a CUDA device, when a
kernel fails to build or launch, or when any check fails.  Float32
matrix products run in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
import math
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
from repro_torch.models.layers import cast_params
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
    # the serving copy, cast once (the engines then share it uncopied)
    params = cast_params(model.init(0), model.dtype)
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


def finite_parts(g: torch.Tensor, w: torch.Tensor):
    """Whether ``g`` has the non-finite values where the plain ``w`` has
    them (a seeded operand outside an op's domain: both sides agree), and
    both with those values zeroed."""
    g, w = g.float(), w.float()
    fin = torch.isfinite(w)
    inf = torch.isinf(w)
    same = bool(torch.equal(torch.isnan(g), torch.isnan(w))) and \
        bool((g[inf] == w[inf]).all())
    return same, torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)


def n_outside(got, want, dtype) -> list[int]:
    """Elements of each output outside the bound of ``close_f32`` (f32)
    or ``seg_close`` (bf16)."""
    rtol, atol = SEG_TOL[dtype]
    out = []
    for g, w in zip(got, want):
        _, g, w = finite_parts(g, w)
        if dtype == torch.float32:
            bad = (g - w).abs() > TRAIN_F32_TOL * w.abs().max()
        else:
            rms = w.pow(2).mean().sqrt()
            bad = ~torch.isclose(g, w, rtol=rtol, atol=atol) | (
                (g - w).abs() > 2.0 ** -7 * w.abs() + 2.0 ** -7 * rms)
        out.append(int(bad.sum()))
    return out


def seg_close(got, want, dtype) -> tuple[bool, float]:
    rtol, atol = SEG_TOL[dtype]
    ok, err = True, 0.0
    for g, w in zip(got, want):
        same, g, w = finite_parts(g, w)
        ok = ok and same
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


# ------------------------------------------------------------ training (7)

#: the device the training phase runs on
DEVICE = "cuda"
#: sequence length and sequences of one training step at full width
TRAIN_SHAPE = (1024, 2)
#: the offloaded bf16 step against the port's plain eager step, same
#: weights and batch: every fused GEMM (forward, recomputed forward,
#: dlhs, drhs) sums in another order than cuBLAS and rounds its product
#: to bf16 once, so activations and gradients move by bf16 ulps through
#: 28 layers — loss within 2e-2 absolute, global gradient norm within
#: 5e-2 relative
TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL = 2e-2, 5e-2
#: a 2-layer full-width build in f32: only the summation order differs —
#: loss within 1e-4, every gradient leaf within 1e-3 of its own max-abs
F32_LOSS_TOL, F32_GRAD_TOL = 1e-4, 1e-3
#: B8 is held bit-equal to its plain version.  apply_updates with the
#: kernel against apply_updates without it: the kernel takes 1 - b1 in f32
#: from f32(b1) where the plain path takes f32(1 - b1) from Python floats
#: (as the JAX package's two paths do), a few ulps of the coefficient —
#: within 2^-20 of each leaf's max-abs (2.6e-7 measured on the CPU)
ADAMW_PATH_TOL = 2.0 ** -20
#: a segment of the f32 training plans against its plain version: 1e-4
#: of the output's max-abs (sums in another order: up to K = 6144
#: products, and lane reductions over up to 151,936 lanes, whose values
#: can cancel to near zero).  Every segment of the bf16 plans as in
#: phase 6 (SEG_TOL: one bf16 ulp of the value plus one of the output's
#: rms)
TRAIN_F32_TOL = 1e-4
#: the grid segments of the training plans that are timed: the most
#: launched ones
TIMED_GRID = 3


def train_segments(plans) -> dict:
    """symbol -> (eqns, segment, count) of every distinct fused segment
    of the plans — grid (B2), fwd (B3), dlhs (B4), drhs (B6) — with the
    times the plans hold it."""
    from repro_torch.core.offload import kernel_symbol, segment_call

    out: dict = {}
    for plan in plans:
        eqns = plan.eqns
        for seg in plan.segments:
            sym = kernel_symbol(segment_call(eqns, seg))
            e, s, n = out.get(sym, (eqns, seg, 0))
            out[sym] = (e, s, n + 1)
    return out


def _span(t: torch.Tensor) -> int:
    """Elements of the storage a strided view reaches."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def seg_operands(seg, seed: int) -> list:
    """Seeded operands of a planned segment at the graph's own shapes
    and strides (a transposed or broadcast view stays one): unit normals
    over the storage, integers 0..3.  The operands of an anchored
    segment's contraction lie on a coarse grid — multiples of 1/2 on the
    activation side, of 2^-3 times a power of two near 1/sqrt(K) on the
    weight side (multiples of 2^-3 for the cotangent of a drhs) — exact
    in bf16, so that every product and partial sum is exact in f32: the
    accumulator is the same in any summation order, and the kernel and
    its plain version round the same value."""
    from repro_torch.core.offload import _segment_arg_vars, node_val

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mm = seg.matmul
    lhs = {s.var for s in mm.lhs_specs} if mm else set()
    rhs = {s.var for s in mm.rhs_specs} if mm else set()
    scale = 2.0 ** round(-0.5 * math.log2(mm.k)) \
        if mm and mm.form != "drhs" else 1.0
    out = []
    for v in _segment_arg_vars(seg):
        val = node_val(v)
        t = torch.randn(_span(val), generator=gen, device=DEVICE)
        if v in lhs:
            t = torch.round(2 * t) / 2
        elif v in rhs:
            t = torch.round(8 * t) / 8 * scale
        if not val.dtype.is_floating_point:
            t = t.abs().floor()
        out.append(t.to(val.dtype).as_strided(tuple(val.shape),
                                              tuple(val.stride())))
    return out


def plan_training(step, state, batch, label: str):
    """Capture and plan the loss (forward), the backward of every fused
    segment and the update, then build all their CUDA translation units
    together.  Returns every plan of the step: the forward, the
    backward ones and the update."""
    from repro_torch.core.offload import bwd_plan_stats, clear_bwd_plans
    from repro_torch.train.step import device_batch

    clear_bwd_plans()
    dbatch = device_batch(batch, DEVICE)
    fplan = step.loss_fn.warm(state.params, dbatch)
    bplans = step.loss_fn.warm_backward(state.params, dbatch)
    uplan = step.update_fn.warm(state.params, state.params, state.opt)
    fst, bst = step.stats, bwd_plan_stats()
    t0 = time.perf_counter()
    units = sorted({tuple(p.library) for p in [fplan, uplan, *bplans]
                    if p.library})
    logs = [fm.finish_library(h)[1]
            for h in [fm.start_library(u, verbose=True) for u in units]]
    build_s = time.perf_counter() - t0
    regs = sorted({int(ln.split("Used ")[1].split()[0]) for log in logs
                   for ln in log.splitlines() if "registers" in ln})
    spills = sum("spill" in ln and "0 bytes spill stores" not in ln
                 for log in logs for ln in log.splitlines())

    def forms(plans, fused):
        n: dict = {}
        for p in plans:
            for d in p.decisions:
                if d.fused == fused:
                    k = d.form or "grid"
                    n[k] = n.get(k, 0) + 1
        return n

    print(f"[7] {label}: forward plan {len(fplan.segments)} fused "
          f"{forms([fplan], True)} / {sum(not d.fused for d in fplan.decisions)}"
          f" declined, traffic {fplan.traffic_reduction:.2f}x; update plan "
          f"{len(uplan.segments)} fused / "
          f"{sum(not d.fused for d in uplan.decisions)} declined")
    print(f"[7] {label}: {len(bplans)} backward plans: fused "
          f"{forms(bplans, True)}, declined {forms(bplans, False)}")
    why: dict = {}
    for p in [fplan, *bplans]:
        for d in p.decisions:
            if d.form and not d.fused:
                why.setdefault(d.form, d.reason)
    for form, reason in why.items():
        print(f"[7] {label}: a declined {form} anchor, for example: {reason}")
    print(f"[7] {label}: capture {fst.capture_s + bst.capture_s:.1f} s "
          f"(forward {fst.capture_s:.1f}, backward {bst.capture_s:.1f}), plan "
          f"{fst.plan_s + bst.plan_s:.1f} s (forward {fst.plan_s:.1f}, "
          f"backward {bst.plan_s:.1f}); {len(units)} CUDA translation units "
          f"for {sum(len(u) for u in units)} anchored segments built together "
          f"in {build_s:.1f} s (registers per thread {regs}, {spills} with "
          f"spills)")
    return [fplan, *bplans, uplan]


def global_norm_of(grads) -> float:
    from repro_torch.optim import global_norm
    return float(global_norm(grads))


def train_steps(step, held: list, data, tokens: int):
    """Three steps: the first cold (Triton builds), the second and third
    under the profiler.  ``held`` is a one-element list holding the
    state, emptied here so that no caller keeps the first state alive
    (a step's peak memory is the old state beside the new one).  Returns
    the state, the launches of every kernel over the three steps and the
    step-3 reading."""
    from torch.profiler import ProfilerActivity, profile

    state = held.pop()
    ops.reset_launch_counts()
    times, per_step, losses, peaks = [], [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(3):
        before = ops.launch_counts()
        if i == 1:
            prof.__enter__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, data.batch(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        after = ops.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after
                         if after[k] - before[k]})
        losses.append(float(metrics["loss"]))
        check(np.isfinite(losses[-1]) and
              np.isfinite(float(metrics["grad_norm"])), "non-finite step")
    prof.__exit__(None, None, None)
    counts = ops.launch_counts()
    peak = max(peaks)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(e) > 0 and "Memcpy" not in e.key]
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / 2
    host_ms = (times[1] + times[2]) / 2 * 1e3
    print(f"[7] 3 steps of {tokens} tokens: {[round(t, 3) for t in times]} s "
          f"by the host clock (step 1 builds the Triton kernels; steps 2-3 "
          f"run under the profiler), losses {[round(x, 4) for x in losses]}")
    print(f"[7] steps 2-3: {host_ms:.1f} ms a step, {tokens / host_ms * 1e3:.0f}"
          f" tokens/s; device busy {busy_ms:.1f} ms a step "
          f"({busy_ms / host_ms:.1%}), "
          f"{sum(e.count for e in rows) / 2:.0f} device kernels a step; peak "
          f"device memory {peak:.2f} GiB (steps 1-3: "
          f"{[round(p, 2) for p in peaks]})")
    for e in sorted(rows, key=dev_us, reverse=True)[:8]:
        print(f"[7]   {dev_us(e) / 2e3:9.3f} ms/step {e.count / 2:7.0f} "
              f"calls/step  {e.key[:80]}")
    print(f"[7] launches a step (step 3): {per_step[2]}")
    return state, counts, dict(step_ms=host_ms, busy_ms=busy_ms, peak=peak)


def memory_split(step, state, batch, plans) -> dict:
    """Device memory over one more offloaded step taken in its three
    parts — the forward, the backward and the update — each with its own
    peak; and the f32 workspace the anchored segments of the plans ask
    for (the largest call's, and the LM head's)."""
    import torch.utils._pytree as pytree
    from repro_torch.core.offload import _matmul_gen, segment_call

    gib = 2.0 ** 30
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves, spec = pytree.tree_flatten(state.params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = step.loss_fn(pytree.tree_unflatten(leaves, spec), batch)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated()
    saved = torch.cuda.memory_allocated() - resident
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(loss, leaves)
    del loss
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated()
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = step.update_fn(state.params, pytree.tree_unflatten(
            list(grads), spec), state.opt)
    torch.cuda.synchronize()
    upd_peak = torch.cuda.max_memory_allocated()
    del out, grads, leaves
    ws = []
    for plan in plans:
        for seg in plan.segments:
            if seg.matmul is not None and seg.matmul.form != "drhs":
                gen = _matmul_gen(segment_call(plan.eqns, seg))
                ws.append((4 * seg.rows * seg.matmul.n * gen["ks"],
                           seg.matmul.n))
    big = max(ws) if ws else (0, 0)
    head = max((w for w in ws if w[1] == max(n for _, n in ws)),
               default=(0, 0))
    print(f"[7] memory of one step, split (GiB): resident before it "
          f"{resident / gib:.2f} (f32 parameters and both moments); "
          f"forward peak {fwd_peak / gib:.2f}, activations saved for the "
          f"backward {saved / gib:.2f}; backward peak {bwd_peak / gib:.2f} "
          f"(the f32 gradients {grad_bytes / gib:.2f}); update peak "
          f"{upd_peak / gib:.2f}; the largest K-split workspace of one "
          f"anchored call {big[0] / gib:.2f} (N = {big[1]}), the LM head's "
          f"{head[0] / gib:.2f} (N = {head[1]})")
    return dict(resident=resident / gib, fwd_peak=fwd_peak / gib,
                saved=saved / gib, bwd_peak=bwd_peak / gib,
                upd_peak=upd_peak / gib)


def train_numerics(model, step, state, batch, tcfg, label: str, *,
                   f32: bool):
    """The offloaded and the plain eager step's loss and gradients on
    the same weights and batch.  Returns the offloaded gradients."""
    from repro_torch.train import make_train_step

    plain = make_train_step(model, dataclasses.replace(tcfg, offload=False))
    loss_o, _, grads_o = step.compute_grads(state.params, batch)
    loss_p, _, grads_p = plain.compute_grads(state.params, batch)
    gn_o, gn_p = global_norm_of(grads_o), global_norm_of(grads_p)
    dl = abs(float(loss_o) - float(loss_p))
    if f32:
        worst = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(_leaves(grads_o), _leaves(grads_p)))
        print(f"[7] {label}: loss offloaded {float(loss_o):.6f} vs plain "
              f"{float(loss_p):.6f} (|diff| {dl:.2e}, tolerance "
              f"{F32_LOSS_TOL}); worst gradient leaf {worst:.2e} of its "
              f"max-abs (tolerance {F32_GRAD_TOL}); grad norm {gn_o:.4f} "
              f"vs {gn_p:.4f}")
        check(dl <= F32_LOSS_TOL and worst <= F32_GRAD_TOL,
              f"{label}: offloaded and plain gradients differ")
    else:
        rel = abs(gn_o - gn_p) / gn_p
        print(f"[7] {label}: loss offloaded {float(loss_o):.5f} vs plain "
              f"{float(loss_p):.5f} (|diff| {dl:.2e}, tolerance "
              f"{TRAIN_LOSS_TOL}); global grad norm {gn_o:.4f} vs "
              f"{gn_p:.4f} (relative {rel:.2e}, tolerance "
              f"{TRAIN_GNORM_RTOL})")
        check(dl <= TRAIN_LOSS_TOL and rel <= TRAIN_GNORM_RTOL,
              f"{label}: offloaded and plain step differ")
    del grads_p
    return grads_o


def close_f32(got, want) -> tuple[bool, float]:
    ok, err = True, 0.0
    for g, w in zip(got, want):
        same, g, w = finite_parts(g, w)
        e = max_err(g, w)
        err = max(err, e)
        ok = ok and same and e <= TRAIN_F32_TOL * float(w.abs().max())
    return ok, err


def describe_segment(eqns, seg, count: int) -> str:
    """One line: the segment's form and shapes; for an anchored one the
    GEMM path the generated kernel takes (WMMA on bf16 tiles, f32 FMA
    otherwise), its prologues, K split and where the epilogue runs."""
    from repro_torch.core.offload import _matmul_gen, node_val, segment_call

    mm = seg.matmul
    if mm is None:
        roles: dict = {}
        for s in seg.operand_specs:
            roles[s.role] = roles.get(s.role, 0) + 1
        return (f"grid rows {seg.rows}, {len(seg.out_cols)} outputs of "
                f"{sorted(set(seg.out_cols))} lanes, operand roles {roles} "
                f"x{count}")
    gen = _matmul_gen(segment_call(eqns, seg))
    if mm.form == "drhs":
        shape = f"[{mm.k}x{seg.rows}]^T@[{mm.k}x{mm.n}]"
    else:
        shape = f"[{seg.rows}x{mm.k}]@[{mm.k}x{mm.n}]"
    w = [str(node_val(s.var).dtype)[6:] for s in mm.rhs_specs]
    pro = "+".join(p for p, on in (("lhs", mm.pro_eqns),
                                   ("weight", mm.rhs_pro_eqns)) if on)
    where = "in the tile" if gen["ks"] == 0 else \
        f"in a second kernel over {gen['ks']} K split(s)"
    return (f"{mm.form} {shape} weight-side {w} prologue {pro or 'none'} "
            f"{'WMMA' if gen['wmma'] else 'FMA'} row block {gen['rb']}, "
            f"epilogue {where} x{count}")


def check_train_segments(plans, dtype, card: str, *, timed: bool) -> dict:
    """Every distinct fused segment of the training plans — grid (B2),
    fwd (B3), dlhs (B4), drhs (B6) — against its plain version at its own
    shapes and strides.  With ``timed``, every anchored one and the
    ``TIMED_GRID`` most launched grid ones are timed beside the bound,
    the plain version and a library yardstick.  Returns the timing rows
    by symbol."""
    from repro_torch.core.offload import (
        _segment_kernel,
        segment_call,
        segment_programs,
    )

    t0 = time.perf_counter()
    segs = train_segments(plans)
    grids = sorted((sym for sym, (_, s, _) in segs.items()
                    if s.matmul is None), key=lambda sym: -segs[sym][2])
    rows, summary, failed = {}, {}, []
    for sym, (eqns, seg, count) in segs.items():
        mm = seg.matmul
        form = mm.form if mm is not None else "grid"
        progs = segment_programs(eqns, seg)
        call = _segment_kernel(seg, progs, impl="cuda")
        ref = _segment_kernel(seg, progs, impl="ref")
        vals = seg_operands(seg, zlib.crc32(sym.encode()) % 1000)
        got = call(*vals)
        torch.cuda.synchronize()
        want = ref(*vals)
        if dtype == torch.float32:
            ok, err = close_f32(got, want)
        else:
            ok, err = seg_close(got, want, dtype)
        n, n_launch, worst = summary.get(form, (0, 0, 0.0))
        summary[form] = (n + 1, n_launch + count, max(worst, err))
        bits = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"[7]   {describe_segment(eqns, seg, count)} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e}"
              f"{', bit-equal' if bits else ''}")
        if not ok:
            print(f"[7]     FAILED: elements outside the bound "
                  f"{n_outside(got, want, dtype)} of "
                  f"{[w.numel() for w in want]}")
            failed.append(f"{form} {sym}")
            continue
        if not timed or (mm is None and sym not in grids[:TIMED_GRID]):
            continue
        lib, lib_name = None, None
        if mm is not None:
            # g @ w^T (dlhs), x^T @ g (drhs), x @ w (fwd; a weight-side
            # cast comes first): the operands are the graph's views
            a, b = vals[0], vals[len(mm.lhs_specs)]
            if mm.form == "fwd" and (mm.pro_eqns or b.dtype != a.dtype):
                lib_name = "cast + torch.matmul"

                def lib():
                    return torch.matmul(a, b.to(a.dtype))
            else:
                lib_name = "torch.matmul"

                def lib():
                    return torch.matmul(a, b)
        else:
            fn = yardstick(segment_call(eqns, seg), vals)
            if fn is not None:
                lib, lib_name = (lambda: fn()), "F.rms_norm"
        ms = graph_ms(lambda i: call(*vals), 2, replays=5)
        plain_ms = time_ms(lambda i: ref(*vals), 2, warmup=1)
        library_ms = graph_ms(lambda i: lib(), 2, replays=5) if lib else None
        n_bytes = sum(_span(v) * v.element_size() for v in vals) + \
            sum(o.numel() * o.element_size() for o in got)
        flops = 2 * seg.rows * mm.k * mm.n if mm is not None else 0
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        bound_ms = max(t_bytes, t_ops)
        rows[sym] = dict(kind=form, count=count, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", max_abs_err=err)
        print(f"[7]     {ms:.4f} ms on the card (CUDA-graph replay), plain "
              f"{plain_ms:.4f} ms, {lib_name or 'library'} "
              f"{'-' if library_ms is None else f'{library_ms:.4f}'} ms, "
              f"bound {bound_ms:.4f} ms by {rows[sym]['bound_by']} "
              f"({n_bytes} bytes, {flops} flops; bound / kernel = "
              f"{bound_ms / ms:.1%}) on {card}")
    for form, (n, n_launch, worst) in summary.items():
        print(f"[7] {str(dtype)[6:]} {form}: {n} distinct segments checked "
              f"({n_launch} in the plans), worst max_abs_err {worst:.3e}")
    print(f"[7] {len(segs)} distinct segments checked in "
          f"{time.perf_counter() - t0:.1f} s")
    check(not failed, f"segments differ from their plain versions: {failed}")
    return rows


def check_batched_bwd() -> None:
    """B4 and B6 with ``batch`` = 2 (no plan forms them yet: ``bmm`` is
    declined) against their plain versions, in f32 and bf16: each batch
    slice of rows against its own slice of the weight (dlhs) or of both
    operands (drhs)."""
    from repro_torch.core import OffloadPolicy
    from repro_torch.core.offload import offload_report, segment_call

    nb, per, k, n = 2, 96, 320, 200
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=DEVICE).manual_seed(12)

        def t(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen,
                                        device=DEVICE)).to(dtype)
        g, y = t(nb * per, k), t(nb * per, n)
        plan = offload_report(lambda g, w, y: torch.tanh(g @ w.t()) + y, g,
                              t(n, k), y,
                              policy=OffloadPolicy(bulk_threshold=64))
        dl = segment_call(plan.eqns, plan.segments[0])
        w = t(nb, n, k, scale=k ** -0.5)            # a weight per slice
        gg, wd = t(nb * per, n), t(k, n)
        plan = offload_report(lambda x, g, w: x.t() @ g + 0.01 * w,
                              t(nb * per, k), gg, wd,
                              policy=OffloadPolicy(bulk_threshold=64))
        dr = segment_call(plan.eqns, plan.segments[0])
        x = t(nb * per, k // nb)           # x[m, rows] of each slice
        check(dl["form"] == "dlhs" and dr["form"] == "drhs",
              "batched check: plan forms")
        for form, call, run in (
                ("dlhs", dl, lambda impl: ops.fused_matmul_dlhs_segment(
                    None, dl["progs"].body, [g], dl["specs"][:1], w, [y],
                    dl["specs"][2:], rows=dl["rows"], k_dim=dl["k"],
                    n_dim=dl["n"], acc_dtype=dl["acc_dtype"],
                    out_cols=dl["out_cols"], out_dtypes=dl["out_dtypes"],
                    vmem_bytes=dl["vmem_bytes"], sms=dl["sms"], batch=nb,
                    impl=impl)),
                ("drhs", dr, lambda impl: ops.fused_matmul_drhs_segment(
                    dr["progs"].body, x, gg, [wd], dr["specs"][2:],
                    m_dim=per, rows=dr["rows"], n_dim=dr["n"],
                    acc_dtype=dr["acc_dtype"], out_cols=dr["out_cols"],
                    out_dtypes=dr["out_dtypes"],
                    vmem_bytes=dr["vmem_bytes"], batch=nb, impl=impl))):
            got = run("cuda")
            torch.cuda.synchronize()
            want = run("ref")
            if dtype == torch.bfloat16:
                ok, err = seg_close(got, want, dtype)
            else:
                err = max_err(got[0], want[0])
                ok = err <= TRAIN_F32_TOL * float(want[0].abs().max())
            print(f"[7]   batched {form} (batch {nb}) {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e}")
            check(ok, f"batched {form} {dtype} vs plain")


def phase_adamw(state, grads, tcfg, card: str) -> dict:
    """B8 through apply_updates(use_kernel=True) over the full-width tree
    (the launches counted), held leaf by leaf against use_kernel=False;
    the kernel bit-equal to its plain version and timed at the largest
    leaf."""
    from repro_torch.kernels.adamw_update import adamw_update_plain
    from repro_torch.optim import AdamWState, apply_updates, warmup_cosine
    from repro_torch.optim.adamw import adamw_hyper

    lr = warmup_cosine(tcfg, state.opt.step)
    leaves = list(_leaves(state.params))
    ops.reset_launch_counts()
    new_p, new_opt = apply_updates(state.params, grads, state.opt, tcfg, lr,
                                   use_kernel=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["adamw_update"]
    check(launches == len(leaves), f"{launches} B8 launches for "
          f"{len(leaves)} leaves")
    worst = 0.0
    for i, (p, g, m, v, pk, mk, vk) in enumerate(zip(
            leaves, _leaves(grads), _leaves(state.opt.m),
            _leaves(state.opt.v), _leaves(new_p), _leaves(new_opt.m),
            _leaves(new_opt.v))):
        pp, po = apply_updates({"x": p}, {"x": g}, AdamWState(
            state.opt.step, {"x": m}, {"x": v}), tcfg, lr, use_kernel=False)
        for a, b in ((pk, pp["x"]), (mk, po.m["x"]), (vk, po.v["x"])):
            worst = max(worst, max_err(a, b) / max(float(b.abs().max()),
                                                    1e-30))
    del new_p, new_opt
    step = state.opt.step + 1
    bc1 = 1.0 - tcfg.beta1 ** step.float()
    bc2 = 1.0 - tcfg.beta2 ** step.float()
    hyper = adamw_hyper(tcfg, lr, bc1, bc2)
    big = max(range(len(leaves)), key=lambda j: leaves[j].numel())
    args = (leaves[big], list(_leaves(grads))[big],
            list(_leaves(state.opt.m))[big], list(_leaves(state.opt.v))[big],
            hyper)
    got = ops.adamw_update(*args, impl="cuda")
    want = adamw_update_plain(*args)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(max_err(a, b) for a, b in zip(got, want))
    print(f"[7] B8 through apply_updates(use_kernel=True): {launches} "
          f"launches (one a leaf); against use_kernel=False the worst leaf "
          f"differs by {worst:.2e} of its max-abs (tolerance "
          f"{ADAMW_PATH_TOL:.2e}); kernel vs its plain version at the "
          f"largest leaf {tuple(leaves[big].shape)}: bit-equal {equal}")
    check(worst <= ADAMW_PATH_TOL, "apply_updates with and without B8 differ")
    check(equal, "B8 differs from its plain version")
    del got, want
    ms = graph_ms(lambda i: ops.adamw_update(*args, impl="cuda"), 2,
                  replays=5)
    plain_ms = time_ms(lambda i: adamw_update_plain(*args), 2, warmup=1)
    n = leaves[big].numel()
    n_bytes = n * (3 * leaves[big].element_size() + 4 * 4)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, \
        15 * n / PEAK_FLOPS[torch.float32] * 1e3
    library_ms = None
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is not None:
        lib = [t.clone() for t in args[:4]]
        steps = [torch.ones((), device=DEVICE)]

        def adamw_lib(i):
            fused([lib[0]], [lib[1]], [lib[2]], [lib[3]], [], steps,
                  lr=float(lr), beta1=tcfg.beta1, beta2=tcfg.beta2,
                  weight_decay=tcfg.weight_decay, eps=tcfg.eps,
                  amsgrad=False, maximize=False)
        library_ms = time_ms(adamw_lib, 4, warmup=1)
        del lib
    print(f"[7] B8 at {tuple(leaves[big].shape)} f32: {ms:.4f} ms on the "
          f"card (CUDA-graph replay), plain {plain_ms:.4f} ms, library "
          f"{'-' if library_ms is None else f'{library_ms:.4f}'} ms "
          f"(torch._fused_adamw_), bound {max(t_bytes, t_ops):.4f} ms by "
          f"bytes ({n_bytes} bytes; bound / kernel = "
          f"{max(t_bytes, t_ops) / ms:.1%}) on {card}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def phase_train(card: str):
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import device_batch

    cfg = get_config("qwen3-1.7b")
    tcfg = TrainConfig(remat=False, offload=True)
    model = build_model(cfg, device=DEVICE)
    state = init_train_state(model, 0)
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip",
                                                         *TRAIN_SHAPE)))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    print(f"[7] training qwen3-1.7b at full width and depth: f32 master "
          f"parameters and AdamW moments, bf16 compute, "
          f"{TRAIN_SHAPE[1]} x {TRAIN_SHAPE[0]} tokens a step, remat off, "
          f"offload on")
    step = make_train_step(model, tcfg)
    plans = plan_training(step, state, data.batch(0), "bf16")
    held = [state]
    del state
    state, counts, reading = train_steps(step, held, data, tokens)
    reading.update(memory_split(step, state,
                                device_batch(data.batch(3), DEVICE), plans))
    batch = device_batch(data.batch(0), DEVICE)
    grads = train_numerics(model, step, state, batch, tcfg,
                           "bf16 offloaded vs plain step", f32=False)
    b8 = phase_adamw(state, grads, tcfg, card)
    del grads
    rows = check_train_segments(plans, torch.bfloat16, card, timed=True)
    check_batched_bwd()
    del state, step, plans
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    model32 = build_model(cfg32, device=DEVICE)
    state32 = init_train_state(model32, 0)
    step32 = make_train_step(model32, tcfg)
    batch32 = SyntheticLM(make_data_config(cfg32, ShapeConfig(
        "chip", *TRAIN_SHAPE))).batch(0)
    plans32 = plan_training(step32, state32, batch32,
                            "f32 2-layer full width")
    train_numerics(model32, step32, state32, device_batch(batch32, DEVICE),
                   tcfg, "f32 2-layer offloaded vs plain", f32=True)
    check_train_segments(plans32, torch.float32, card, timed=False)
    check(counts["fused_matmul_dlhs_segment"] > 0 and
          counts["fused_matmul_drhs_segment"] > 0,
          "the training steps launched no B4 / B6")
    return rows, counts, b8, reading


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
    del params
    torch.cuda.empty_cache()
    train_rows, train_counts, b8, _ = phase_train(card)
    print(f"[8] total {time.perf_counter() - t0:.1f} s")
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
        **kernel_entry(timed, "matmul")}, {
        "name": "fused_matmul_dlhs_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul.cuh",
        "replaces": "src/repro/kernels/fused_matmul_bwd.py:178",
        "launches": train_counts["fused_matmul_dlhs_segment"],
        **kernel_entry(train_rows, "dlhs")}, {
        "name": "fused_matmul_drhs_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul.cuh",
        "replaces": "src/repro/kernels/fused_matmul_bwd.py:343",
        "launches": train_counts["fused_matmul_drhs_segment"],
        **kernel_entry(train_rows, "drhs")}, {
        "name": "adamw_update", "route": "triton",
        "source": "src/repro_torch/kernels/adamw_update.py",
        "replaces": "src/repro/kernels/adamw_update.py:55",
        **b8}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
