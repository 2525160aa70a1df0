#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch``'s main paths — serving full-width qwen3-1.7b,
zamba2-1.2b and rwkv6-1.6b (random weights from a seed) through the
paged ``Engine``, and training qwen3-1.7b through the offload compiler —
and holds every hand-written kernel against its plain PyTorch version:

1. environment: torch / CUDA / nvcc versions, the card and its power limit;
2. build every CUDA source under ``src/repro_torch/kernels/csrc`` into
   ``build/`` (one ``nvcc`` per source, started together), naming each
   instantiation whose registers spill (none of B5's, B7's or B8's may);
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
   (CUDA; each bf16 one must take the weight stream, no instantiation of
   it may spill, and each is relaunched, bit-equal) — against its plain
   version on seeded inputs (each grid kernel with its registers,
   spills and global loads by vector width), the plans' counts pinned,
   time the bf16
   ones (CUDA-graph replay) beside the bound, the plain version and a
   library yardstick; serve the same 12 requests through
   ``Engine(offload=True)`` (launch counts = decode steps x layers for
   the attention and x segments of the plan for the fused kernels,
   ``plan_misses == 1``); profile an offloaded decode step (B2's device
   time a step, summed over its ``seg_`` kernels); and take one
   decode step on the same state offloaded and eager, in bf16 and in
   f32 — logits agree;
7. training full-width qwen3-1.7b (f32 master parameters, bf16 compute,
   2 x 1024 tokens a step) through ``make_train_step(offload=True)``:
   plan the loss, every fused segment's backward and the update (their
   plan counts pinned), build
   all their translation units together, take three steps (launch counts
   a step, the operands B2 copies a step, the host clock, the device-busy
   time under the profiler, B2's device time a step by ``seg_`` symbol, peak
   memory, then one more step split into forward, backward and update
   peaks); the offloaded step against the plain eager step in bf16 and,
   at two layers, in f32; AdamW through ``apply_updates(use_kernel=True)``
   against ``use_kernel=False`` and B8 against its plain version, bit for
   bit, timed beside
   ``torch._fused_adamw_`` and beside the update's B2 segment on the same
   [152,064 x 2,048] leaf; every
   distinct fused segment of the training plans — grid (B2), fwd (B3),
   dlhs (B4), drhs (B6), each anchored one with the GEMM path it takes
   (``sm90 TMA`` / ``sm90 register-staged`` / ``stream cp.async`` /
   ``stream register-staged`` / FMA; every bf16 fwd of 64 rows a slice
   or more and every bf16 dlhs / drhs must take the sm90 mainloop, no
   instantiation of it or of the weight stream may spill, and each bf16
   drhs is launched twice, bit-equal) — at its own
   shapes and strides against its plain version, the bf16 anchored ones,
   the most launched grid ones and those with the most device time a
   step timed beside the bound, the plain version and a library
   yardstick (``F.rms_norm``, ``torch.softmax``, ``torch.log_softmax``,
   the softmax backward: matched by the op sequence and taken only where
   its output agrees with the plain version; else "none" with the
   reason), the grid ones tabled with their shape,
   roles, bytes, share of the bound, copies and geometry; B3 / B4 / B6's
   device time a step
   by form; every variant of the sm90 mainloop (B3, B4, B6) and of the
   weight stream (B3) at the CPU tests' shapes and at full width, on
   misaligned operands, with K splits, an lhs prologue, an f32 weight
   cast and batch slices; the forward plan unchanged by batched
   anchors, its attention ``bmm`` declined;
8. flash and batched anchors at the attention width of qwen3-1.7b (16
   query / 8 kv heads, head_dim 128, 2 x 2048 tokens, bf16):
   ``mpu_offload`` of the GQA attention chain plans one flash segment
   over batch axes (2, 16), launches ``flash_attention`` (B5) and agrees
   with the unwrapped chain, and its gradients through the planned
   backward (batched dlhs / drhs / fwd segments) with autograd of the
   chain; B5 on the segment's operands against its plain version and
   relaunched, bit-equal; ``ops.flash_attention`` causal, windowed,
   unmasked and with the log-sum-exp (bf16, f16, f32), and
   ``flash_attention_diff`` forward and backward (B7: ``dkv``, ``dq``;
   bf16, f16) against the plain versions, and both at the CPU tests'
   shapes in f32, bf16 and f16 and at head dims 24 / 96 / 256 in bf16
   and f16, each launch made twice, bit-equal, every bf16 / f16 launch
   on the sm90 kernels and every f32 one on the FMA kernels (launches by
   path printed); every distinct segment of the
   ``BATCHED_GEMM_BWD`` chain (f32, bf16) and of the backward plans
   against its plain version (the batched B4 / B6 timed beside
   ``torch.bmm``); B5 (on the flash segment, unmasked, and causal at
   the GQA width) and each B7 kernel (unmasked and causal) timed beside
   the bound over the pairs the mask keeps, the plain version and
   ``scaled_dot_product_attention`` (its backward); and a chain whose
   flash pair B5 refuses (head_dim 96, f32: queue C1) declined with
   B5's reason and run on the card against the unwrapped chain;
9. the kernel library's rmsnorm (B9, forward and backward), rotary (B10)
   and dense decode attention (B11, token-major and head-major) through
   ``ops``: each against its plain version at the CPU tests' shapes in f32
   (2e-5) and bf16 (2e-2), plus rows too wide for B9's registers (the
   wide kernels, any D) and a misaligned x, and decode with ragged, full
   and empty rows in one split and in several (by T); at the width of qwen3-1.7b (hidden states
   [2, 1024, 2048], the q-norm [2, 1024, 16, 128], q / k [2048, 16 | 8,
   128] at theta 1e6, phase 3's cache gathered into dense caches), bf16
   and f32, one counted run of the path (every call a kernel launch, the
   plain versions only where asked for by ``impl="ref"``), B9's gradient
   through ``RMSNormFn`` against autograd of the plain version with a
   bit-equal ``ds`` over three launches, B10 at positions to 32,767, B11
   against B1 on the same cache and bit-equal across layouts; each timed
   (CUDA-graph replay, inputs rotated past the L2) beside the bound, the
   plain version and ``F.rms_norm`` / its fused backward / SDPA; and
   B9 at d_model 16,384, the backward on its wide kernel, checked and
   timed beside the same; B5 / B7 in bf16 and f16 at head dim 96 (taken
   since queue C2's lift) against their plain versions; and the inputs
   B1, B5, B7 and B11 refuse (queue C2: B5 / B7 at head dims 12 and 264,
   G = 128, f32 head dim 96, B7's f32 head dim 128), each raising before
   anything launches;
10. the kernel library's ssd_scan (B12) and wkv6 (B13) through ``ops``:
    each against its plain version at the CPU tests' shapes, at S = 999
    and odd widths, f32 and bf16, B13 at strong decay (w in [0.05, 0.2],
    finite); at full width (B = 2, S = 2,048; B12 at zamba2-1.2b's H = 64,
    P = N = 64, B13 at rwkv6-1.6b's H = 32, K = V = 64; bf16 and f32), one
    counted run of the path, each timed (CUDA-graph replay) beside the
    bound and the plain version;
11. zamba2-1.2b and rwkv6-1.6b at full width and depth (random bf16
    weights from seed 0) through ``Engine(slots=8, max_len=2048,
    page_size=64)``: 12 greedy requests x 64 tokens (every request
    completes, B1 launched 6 times a decode step for zamba2's shared
    attention, 0 for rwkv6), a decode step profiled with 8 active slots
    (zamba2: the step through B1 against its plain version), peak memory,
    and the engine's prefill and decode logits of 3 requests against a
    full-sequence forward of the same tokens (bf16 at full depth; f32 at
    12 / 4 layers);
12. a ``kernels`` JSON line, then the card line, then the result line.

    python3 chip_smoke.py --decode-segments [--src DIR]

takes phase 1 and phase 6's decode segment timings alone, on the package
under ``DIR`` where given (another checkout's ``src``), and prints no
result line: two checkouts' kernels timed by one script.

Exits non-zero (printing no result line) without a CUDA device, when a
kernel fails to build or launch, or when any check fails.  Float32
matrix products run in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import zlib



def _src_root() -> str:
    """The package root: ``src`` beside this script, or ``--src DIR`` (to
    take this script's readings on another checkout's package)."""
    if "--src" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


sys.path.insert(0, _src_root())

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels.decode_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.kernels.guard import kernel_guard
from repro_torch.models import build_model
from repro_torch.models.layers import cast_params, lm_head_apply
from repro_torch.models.transformer import ATTENTION_KINDS, layer_kinds
from repro_torch.serve import Engine, Request
# the module, not the entry point of the same name the package exports
fe = importlib.import_module("repro_torch.kernels.fused_elementwise")

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


def spilling_entries(log: str) -> list[str]:
    """The kernels (demangled where ``c++filt`` is at hand) whose
    ``ptxas -v`` report shows spill stores."""
    names, entry = [], ""
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln and "0 bytes spill stores" not in ln:
            names.append(entry)
    if names and shutil.which("c++filt"):
        names = run(["c++filt", *names]).splitlines()
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in names]


#: sources none of whose instantiations may spill (B5 / B7: their f32
#: FMA kernels and their bf16 / f16 wgmma kernels; B8)
NO_SPILL = ("flash_attention", "flash_attention_bwd", "adamw_update")


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    spilling = []
    for name, log in logs.items():
        usage = [ln for ln in log.splitlines() if "registers" in ln]
        regs = sorted({int(ln.split("Used ")[1].split()[0]) for ln in usage})
        spills = spilling_entries(log)
        print(f"[2] built {name}.cu in {_build.BUILD_SECONDS[name]:.1f} s "
              f"(registers per thread by instantiation: {regs}; "
              f"{len(spills)} with spills{': ' if spills else ''}"
              f"{', '.join(spills)})")
        if name in NO_SPILL:
            check(bool(regs), f"no ptxas report for {name}.cu")
            spilling += spills
    print(f"[2] build total {time.perf_counter() - t0:.1f} s -> "
          f"{_build.build_dir()}")
    check(not spilling, f"B5 / B7 / B8 instantiations spill: {spilling}")


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


def attention_layers(cfg) -> int:
    """Layers whose decode launches B1 (attention and shared attention)."""
    return sum(k in ATTENTION_KINDS for k in layer_kinds(cfg))


def serve(engine, reqs, label: str, tag: str = "[4]") -> int:
    """Run ``reqs`` to completion with the launch counts zeroed just
    before; returns the kernel's launches, read just after."""
    layers = attention_layers(engine.cfg)
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
    print(f"{tag} {label}: {len(reqs)} requests, {tokens} tokens, {steps} "
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
          f"{launches} launches != {steps} decode steps x {layers} "
          "attention layers")
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
    grid = grid_device_ms(rows, dev_us, steps)
    if grid:
        print(f"{tag} B2 (fused_segment_grid, {len(grid)} seg_ kernels): "
              f"{sum(ms for ms, _ in grid.values()):.4f} ms of device time "
              f"a step over {sum(n for _, n in grid.values()):.0f} launches: "
              + ", ".join(f"{sym} {ms * 1e3 / n:.2f} us x{n:.0f}"
                          for sym, (ms, n) in sorted(grid.items())))


#: the generated B2 kernel's name: ``seg_<program hash>_<rows>_<block>``
SEG_SYMBOL = re.compile(r"seg_[0-9a-f]{16}_\d+_\d+")


def grid_device_ms(rows, dev_us, steps: int) -> dict:
    """symbol -> (device ms a step, launches a step) of every B2 kernel
    among the profiler's device rows (``steps`` steps profiled)."""
    out: dict = {}
    for e in rows:
        m = SEG_SYMBOL.search(e.key)
        if m:
            ms, n = out.get(m.group(0), (0.0, 0.0))
            out[m.group(0)] = (ms + dev_us(e) / 1e3 / steps,
                               n + e.count / steps)
    return out


def phase_full_width_check(engine, tag: str = "[5]") -> None:
    """Stop the engine mid-flight and take one decode step twice on the
    same state: through the kernel, and through the plain version (the
    recurrent layers' state rows restored after each step)."""
    cfg = engine.cfg
    lens = [33, 700, 64, 129, 511, 250, 17, 400]
    for r in make_requests(cfg, lens, 32, seed=3):
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._pump()
    torch.cuda.synchronize()
    print(f"{tag} admitted {len(lens)} prompts (lengths {lens}) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    profile_decode(engine, tag=tag)
    st = engine._state
    tables = torch.as_tensor(engine.pool.tables, device="cuda")
    active = st["active"]
    check(int(active.sum()) == len(lens), "not every slot is decoding")
    state = [{n: t.clone() for n, t in c.items() if n not in ("k", "v")}
             for c in engine.cache]
    out = {}
    for impl in ("cuda", "ref"):
        # the step writes the same K/V entry either way, so repeating it
        # on the same state is harmless; a recurrent row is put back
        logits, _ = engine.model.decode_step_paged(
            engine.params, engine.cache, st["tok"], st["pos"], tables,
            active, max_len=engine.max_len, impl=impl)
        out[impl] = logits
        for c, saved in zip(engine.cache, state):
            for n, t in saved.items():
                c[n].copy_(t)
    del state
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
    print(f"{tag} full-width decode step, kernel vs plain version: max abs "
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


#: the grid programs a library call computes: input roles and ops in
#: program order (casts, copies and broadcasts left out) -> the call
YARDSTICK_OPS = {
    (("bulk", "param"), ("mul", "sum", "div", "add", "rsqrt", "mul",
                         "mul")): "F.rms_norm",
    (("bulk",), ("max", "sub", "exp", "sum", "div")): "torch.softmax",
    (("bulk",), ("max", "sub", "exp", "sum", "log", "sub")):
        "torch.log_softmax",
    (("bulk", "bulk"), ("mul", "sum", "mul", "sub")):
        "torch._softmax_backward_data",
}
#: a yardstick is taken only where its output is the plain version's
#: within this share of the output's max-abs: rounding moves a value by
#: bf16 ulps (2^-8), another function by the order of the values
YARDSTICK_AGREE = 2.0 ** -6


def yardstick(call: dict, vals, want) -> tuple:
    """``(fn, name)``: one PyTorch call computing the segment's function,
    or ``(None, reason)`` where none does.  A grid segment is matched by
    its input roles and op sequence (``YARDSTICK_OPS``), has one output,
    and the call's output agrees with the plain version's ``want``
    (``YARDSTICK_AGREE``); the softmax backward's two operands are tried
    in both orders."""
    if call["kind"] == "matmul":
        nl = call["n_lhs"]
        lhs, rhs = vals[0], vals[nl]
        if call["progs"].lhs is not None or call["progs"].rhs is not None:
            return None, "none: a prologue (no one call)"
        return (lambda: torch.matmul(lhs, rhs)), "torch.matmul"
    prog = call["progs"].body
    roles = tuple(i.role for i in prog.inputs)
    seq = tuple(op.code for op in prog.ops if op.kind in ("ew", "reduce")
                and op.code not in ("cast", "copy"))
    name = YARDSTICK_OPS.get((roles, seq))
    if name is None or len(prog.outputs) != 1:
        red = [prog.ops[r].code for r in prog.reductions]
        return None, (f"none: {len(seq) - len(red)} elementwise ops"
                      f"{', lane ' + '/'.join(red) if red else ''} over "
                      f"roles {'/'.join(sorted(set(roles)))}, "
                      f"{len(prog.outputs)} output(s) (no one call)")
    out_dt = call["out_dtypes"][0]
    x = vals[0]
    if name == "F.rms_norm":
        add = next(op for op in prog.ops if op.code == "add")
        eps = next((a[1] for a in add.args if a[0] == "c"), 1e-6)
        w = vals[1].to(x.dtype).reshape(-1)
        fns = [lambda: F.rms_norm(x, (x.shape[-1],), w, eps)]
    elif name == "torch.softmax":
        fns = [lambda: torch.softmax(x, -1, dtype=out_dt)]
    elif name == "torch.log_softmax":
        fns = [lambda: torch.log_softmax(x, -1, dtype=out_dt)]
    else:
        a, b = vals
        fns = [lambda: torch._softmax_backward_data(a, b, -1, out_dt),
               lambda: torch._softmax_backward_data(b, a, -1, out_dt)]
    w0 = want[0].float()
    err = math.inf
    for fn in fns:
        got = fn().float()
        if got.numel() == w0.numel():
            err = min(err, float((got.reshape(w0.shape) - w0).abs().max()))
            if err <= YARDSTICK_AGREE * float(w0.abs().max()):
                return fn, name
    return None, (f"none: {name}'s op sequence, but its output is "
                  f"{err:.2e} from the plain version's")


#: the full-width decode plans (fused segments, of them grid, declined):
#: B2's geometry must not move the planner
DECODE_PLAN = {"bf16": (198, 113, 112), "f32": (197, 113, 113)}


def phase_offload_kernels(plans: dict, card: str) -> dict:
    """Build and check every distinct segment kernel of the plans (an
    anchored one also relaunched, bit-equal; every bf16 one on the weight
    stream); time the bf16 ones.  Returns the timing rows by symbol."""
    from repro_torch.core.offload import _matmul_gen

    t0 = time.perf_counter()
    started = [(label, fm.start_library(plan.library, verbose=True))
               for label, plan in plans.items() if plan.library]
    rows = {}
    for label, plan in plans.items():
        dtype = torch.bfloat16 if label == "bf16" else torch.float32
        segs = distinct_segments(plan)
        n_grid = sum(c for call, c in segs.values() if call["kind"] == "grid")
        n_declined = sum(not d.fused for d in plan.decisions)
        print(f"[6] {label} plan: {len(plan.segments)} fused segments a "
              f"decode step ({n_grid} grid, {len(plan.segments) - n_grid} "
              f"anchored), {len(segs)} distinct kernels, "
              f"{n_declined} declined; "
              f"traffic {plan.traffic_reduction:.2f}x")
        check((len(plan.segments), n_grid, n_declined) == DECODE_PLAN[label],
              f"{label} decode plan moved from {DECODE_PLAN[label]}")
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
            print(f"[6]   grid {sym} rows {call['rows']} cols "
                  f"{call['out_cols']} roles "
                  f"{[s[0] for s in call['specs']]} x{count}/step: "
                  f"max_abs_err {err:.3e}; first launch (Triton build) "
                  f"{compile_s:.2f} s; registers, spills, global loads by "
                  f"width: {compiled_variants(sym)}")
            check(ok, f"{label} grid segment {sym} vs plain")
            rows[(label, sym)] = (call, count, vals)
    for label, handle in started:
        _, log = fm.finish_library(handle)
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in log.splitlines() if "registers" in ln})
        spills = sum("spill" in ln and "0 bytes spill stores" not in ln
                     for ln in log.splitlines())
        _, gemm_spilling = sm90_resources([log])
        print(f"[6] {label} plan's CUDA translation unit: "
              f"{len(plans[label].library)} segments, registers per thread "
              f"{regs}, {spills} with spills")
        check(not gemm_spilling, f"weight-stream instantiations spill: "
              f"{gemm_spilling}")
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
            again = run_seg(call, vals, "cuda")
            torch.cuda.synchronize()
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            path = gemm_path(_matmul_gen(call))
            print(f"[6]   anchored {sym} [{call['rows']}x{call['k']}]@"
                  f"[{call['k']}x{call['n']}] outs {call['out_cols']} "
                  f"x{count}/step, {path}: max_abs_err {err:.3e}, "
                  f"relaunch bit-equal {same}")
            check(ok, f"{label} anchored segment {sym} vs plain")
            check(same, f"{label} anchored segment {sym}: a relaunch differs")
            if label == "bf16":
                check(path.startswith("stream"), f"bf16 decode segment {sym} "
                      f"off the weight stream: {path}")
            rows[(label, sym)] = (call, count, vals)
    print(f"[6] kernels built and checked in {time.perf_counter() - t0:.1f} s")
    return time_decode_segments(
        {sym: r for (label, sym), r in rows.items() if label == "bf16"},
        card)


#: launches a CUDA graph holds where a decode segment, or its library
#: yardstick, is timed: a decode segment runs for microseconds, and with
#: fewer the replay's own launch shows in the time
DECODE_GRAPH_CALLS = 16


def time_decode_segments(rows: dict, card: str, tag: str = "[6]") -> dict:
    """Time each decode segment (``rows``: symbol -> (call, launches a
    step, operands)) and its library yardstick with ``DECODE_GRAPH_CALLS``
    launches a graph each, beside the bound and the plain version.
    Returns the timing rows by symbol."""
    timed = {}
    for sym, (call, count, vals) in rows.items():
        copies = [vals] + [[v.clone() for v in vals] for _ in range(3)]
        outs = run_seg(call, vals, "cuda")
        want = run_seg(call, vals, "ref")
        ms = graph_ms(lambda i: run_seg(call, copies[i % 4], "cuda"),
                      DECODE_GRAPH_CALLS)
        plain_ms = time_ms(lambda i: run_seg(call, copies[i % 4], "ref"), 4)
        lib, lib_name = yardstick(call, vals, want)
        library_ms = graph_ms(lambda i: lib(), DECODE_GRAPH_CALLS) \
            if lib else None
        bound_ms, bound_by, n_bytes, flops = seg_bound(call, vals, outs)
        timed[sym] = dict(kind=call["kind"], count=count, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=seg_close(outs, want,
                                                torch.bfloat16)[1])
        print(f"{tag}   {call['kind']} {sym} x{count}/step: {ms:.5f} ms on "
              f"the card (CUDA-graph replay, {DECODE_GRAPH_CALLS} launches "
              f"a graph), plain {plain_ms:.4f} ms, "
              f"{lib_name if lib else 'library'} "
              f"{'-' if library_ms is None else f'{library_ms:.5f}'} ms"
              f"{'' if lib else f' ({lib_name})'}, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({n_bytes} bytes, {flops} flops; bound / "
              f"kernel = {bound_ms / ms:.1%}) on {card}")
    return timed


def phase_decode_segments(card: str) -> None:
    """Phase 6's decode segment timings alone (``--decode-segments``):
    every segment of the full-width bf16 decode plan built, held against
    its plain version and timed as phase 6 times it.  With ``--src`` it
    runs on another checkout's package, so that two checkouts' kernels
    are timed by one script in one run."""
    import repro_torch

    cfg = get_config("qwen3-1.7b")
    params = build_model(cfg, device="cuda").init(0)
    plan = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                  page_size=64, offload=True).prepare_decode()
    print(f"[6] decode segments of {os.path.dirname(repro_torch.__file__)}")
    if plan.library:
        fm.finish_library(fm.start_library(plan.library))
    rows = {}
    for sym, (call, count) in distinct_segments(plan).items():
        vals = seg_inputs(call, seed=zlib.crc32(sym.encode()) % 1000)
        ok, _ = seg_close(run_seg(call, vals, "cuda"),
                          run_seg(call, vals, "ref"), torch.bfloat16)
        check(ok, f"decode segment {sym} vs plain")
        rows[sym] = (call, count, vals)
    time_decode_segments(rows, card)


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
#: and the grid segments with the most device time a step
TOP_GRID = 5
#: the full-width bf16 training forward plan (fused, fused by form,
#: declined) as measured before batched contractions were planned; they
#: must not move it (the attention bmm stay declined)
TRAIN_FORWARD_PLAN = (719, {"grid": 557, "fwd": 162}, 1019)
#: the full-width bf16 backward plans (plans, fused by form, declined by
#: form) and update plan (fused, declined), as planned before B2's
#: redesign; its geometry must not move them
TRAIN_BACKWARD_PLAN = (719, {"grid": 889, "drhs": 162, "dlhs": 162,
                             "fwd": 84}, {"grid": 448})
TRAIN_UPDATE_PLAN = (85, 284)
#: B4 / B6 launches a bf16 step as planned before the sm90 cost model: a
#: difference is a backward decision the new modeled bytes flip
EARLIER_BWD_LAUNCHES = (162, 162)


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


#: the mangled names of the sm90 mainloop's and the weight stream's
#: instantiations
GEMM_ENTRIES = ("fm90_gemm", "fms_gemm")


def sm90_resources(logs) -> tuple[list, list]:
    """The registers per thread of every sm90 mainloop and weight-stream
    instantiation in ``-Xptxas -v`` output, and the instantiations that
    spill."""
    regs, spilling, entry = [], [], ""
    for ln in (ln for log in logs for ln in log.splitlines()):
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif any(e in entry for e in GEMM_ENTRIES) and "spill" in ln and \
                "0 bytes spill stores, 0 bytes spill loads" not in ln:
            spilling.append(entry)
        elif any(e in entry for e in GEMM_ENTRIES) and "Used " in ln:
            regs.append(int(ln.split("Used ")[1].split()[0]))
    return sorted(set(regs)), spilling


def build_units(plans) -> tuple[list, float, list, int]:
    """Build the CUDA translation units of the plans, one ``nvcc`` each,
    all started together.  Returns the units, the seconds, the registers
    per thread by instantiation and the number with spills; fails if an
    instantiation of the sm90 mainloop spills."""
    t0 = time.perf_counter()
    units = sorted({tuple(p.library) for p in plans if p.library})
    logs = [fm.finish_library(h)[1]
            for h in [fm.start_library(u, verbose=True) for u in units]]
    regs = sorted({int(ln.split("Used ")[1].split()[0]) for log in logs
                   for ln in log.splitlines() if "registers" in ln})
    spills = sum("spill" in ln and "0 bytes spill stores" not in ln
                 for log in logs for ln in log.splitlines())
    sm90_regs, sm90_spilling = sm90_resources(logs)
    if sm90_regs or sm90_spilling:
        print(f"[7] sm90 mainloop / weight-stream instantiations: registers "
              f"per thread {sm90_regs}, {len(sm90_spilling)} spilling")
    check(not sm90_spilling, f"sm90 / stream instantiations spill: "
          f"{sm90_spilling}")
    return units, time.perf_counter() - t0, regs, spills


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
    units, build_s, regs, spills = build_units([fplan, uplan, *bplans])

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
    bmm = [d for d in fplan.decisions if d.form == "bmm"]
    print(f"[7] {label}: {len(bmm)} attention bmm in the forward, "
          f"{sum(not d.fused and 'batch axes not leading' in d.reason for d in bmm)}"
          f" declined for batch axes that a copy moved")
    check(all(not d.fused and "batch axes not leading" in d.reason
              for d in bmm), f"{label}: an attention bmm was anchored")
    if label == "bf16":
        check((len(fplan.segments), forms([fplan], True),
               sum(not d.fused for d in fplan.decisions)) ==
              TRAIN_FORWARD_PLAN, f"{label}: the forward plan moved from "
              f"{TRAIN_FORWARD_PLAN}")
        check((len(bplans), forms(bplans, True), forms(bplans, False)) ==
              TRAIN_BACKWARD_PLAN, f"{label}: the backward plans moved from "
              f"{TRAIN_BACKWARD_PLAN}")
        check((len(uplan.segments),
               sum(not d.fused for d in uplan.decisions)) ==
              TRAIN_UPDATE_PLAN, f"{label}: the update plan moved from "
              f"{TRAIN_UPDATE_PLAN}")
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


#: the kernel of each anchored form, as the profiler's symbols name it
FORM_KERNEL = {"fwd": "B3", "dlhs": "B4", "drhs": "B6"}


def form_device_ms(rows, plans, dev_us) -> dict:
    """Device milliseconds a step of B3 / B4 / B6 (profiler rows of two
    steps), summed by form: every kernel whose name holds a generated
    segment symbol of the plans (its GEMM, and its epilogue kernel)."""
    from repro_torch.core.offload import kernel_symbol, segment_call

    form_of = {}
    for plan in plans:
        for seg in plan.segments:
            if seg.matmul is not None and seg.matmul.flash is None:
                sym = kernel_symbol(segment_call(plan.eqns, seg))
                form_of[sym] = seg.matmul.form
    out = {k: 0.0 for k in FORM_KERNEL.values()}
    for e in rows:
        for sym in re.findall(r"fm_[0-9a-f]{16}", e.key)[:1]:
            if sym in form_of:
                out[FORM_KERNEL[form_of[sym]]] += dev_us(e) / 2e3
    return out


def train_steps(step, held: list, data, tokens: int, plans):
    """Three steps: the first cold (Triton builds), the second and third
    under the profiler.  ``held`` is a one-element list holding the
    state, emptied here so that no caller keeps the first state alive
    (a step's peak memory is the old state beside the new one).  Returns
    the state, the launches of every kernel over the three steps and the
    step-3 reading (with the device time a step of B3 / B4 / B6, by the
    plans' segment symbols)."""
    from torch.profiler import ProfilerActivity, profile

    state = held.pop()
    ops.reset_launch_counts()
    times, per_step, losses, peaks = [], [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(3):
        before = ops.launch_counts()
        copies = sum(fe.COPIES.values())
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
        per_step[-1]["grid operand copies"] = sum(fe.COPIES.values()) - copies
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
    by_form = form_device_ms(rows, plans, dev_us)
    print(f"[7] device time a step of the anchored GEMMs by form (their "
          f"epilogue kernels included): "
          f"{', '.join(f'{k} {v:.1f} ms' for k, v in by_form.items())}")
    grid = grid_device_ms(rows, dev_us, 2)
    b2_ms = sum(ms for ms, _ in grid.values())
    print(f"[7] B2 (fused_segment_grid): {b2_ms:.2f} ms of device time a "
          f"step over {sum(n for _, n in grid.values()):.0f} launches of "
          f"{len(grid)} seg_ kernels; {per_step[2]['grid operand copies']} "
          f"operands copied to a contiguous block a step (step 3) by "
          f"{sorted(k for k, n in fe.COPIES.items() if n)}; the most "
          f"device time a step: " + ", ".join(
              f"{sym[:20]} {ms:.3f} ms x{n:.0f}" for sym, (ms, n) in
              sorted(grid.items(), key=lambda x: -x[1][0])[:15]))
    print(f"[7] launches a step (step 3): {per_step[2]}; B4 / B6 "
          f"{per_step[2].get('fused_matmul_dlhs_segment', 0)} / "
          f"{per_step[2].get('fused_matmul_drhs_segment', 0)} (before the "
          f"sm90 cost model: {EARLIER_BWD_LAUNCHES[0]} / "
          f"{EARLIER_BWD_LAUNCHES[1]})")
    return state, counts, dict(step_ms=host_ms, busy_ms=busy_ms, peak=peak,
                               B2=b2_ms, grid=grid, **by_form)


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


def gemm_path(gen: dict) -> str:
    """The GEMM path of a generated anchored segment: the variant of the
    sm90 mainloop or of the weight stream its last launch took (``sm90
    TMA`` / ``sm90 register-staged`` / ``stream cp.async`` / ``stream
    register-staged``), else ``FMA``."""
    if gen["path"] in ("sm90", "stream"):
        return kernel_guard().last_variant.get(
            gen["name"], f"{gen['path']} (not launched)")
    return gen["path"].upper()


def describe_segment(eqns, seg, count: int) -> str:
    """One line: the segment's form and shapes; for an anchored one the
    GEMM path the generated kernel takes (``gemm_path``), its prologues,
    tile, K split and where the epilogue runs."""
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
    tile = {"sm90": f"tile [128x{gen.get('tn')}]",
            "stream": f"tile [8x{gen.get('tn')}]"}.get(
        gen["path"], f"row block {gen['rb']}")
    return (f"{mm.form} {shape} weight-side {w} prologue {pro or 'none'} "
            f"{gemm_path(gen)} {tile}, epilogue {where} x{count}")


def compiled_variants(sym: str) -> dict:
    """Layout digest ("contiguous" where no operand is strided) ->
    (registers, spills, global loads by vector width) of every compiled
    kernel of the planner's grid symbol ``sym``."""
    return {name[len(sym) + 1:] or "contiguous": v
            for name, v in fe.COMPILED.items()
            if name == sym or name.startswith(sym + "_s")}


def grid_row(seg, progs, vals, outs) -> dict:
    """What a B2 training row shows besides its time: shape, roles,
    whether it reduces lanes, bytes (each operand's storage read once,
    each output written once), the operands the wrapper copies to a
    contiguous block, and the kernel's geometry."""
    from repro_torch.core.offload import GRID_ROWS_BLOCK

    specs = [sp.meta for sp in seg.operand_specs]
    roles: dict = {}
    for sp in specs:
        roles[sp[0]] = roles.get(sp[0], 0) + 1
    n_bytes = sum(_span(v) * v.element_size() for v in vals) + \
        sum(o.numel() * o.element_size() for o in outs)
    layouts = [fe.operand_layout(v, sp[1], sp[2])
               for v, sp in zip(vals, specs)]
    copies = sum(lay is False for lay in layouts)
    strided = {k: (str(v.dtype)[6:], lay) for k, (v, lay) in
               enumerate(zip(vals, layouts)) if lay}
    geo = fe.grid_geometry(progs.body, seg.rows, specs, GRID_ROWS_BLOCK)
    sym = fe.triton_source(progs.body, rows=seg.rows, specs=specs,
                           rows_block=GRID_ROWS_BLOCK)[0]
    geo = dict(geo, compiled=compiled_variants(sym))
    return dict(shape=f"[{seg.rows}x{max(seg.out_cols)}]", roles=roles,
                reduce=bool(progs.body.reductions), bytes=n_bytes,
                copies=copies, strided=strided, geometry=geo)


def check_train_segments(plans, dtype, card: str, *, timed: bool,
                         tag: str = "[7]", grid_ms: dict | None = None
                         ) -> dict:
    """Every distinct fused segment of the training plans — grid (B2),
    fwd (B3), dlhs (B4), drhs (B6) — against its plain version at its own
    shapes and strides.  With ``timed``, every anchored one, the
    ``TIMED_GRID`` most launched grid ones and the ``TOP_GRID`` grid ones
    with the most device time a step (``grid_ms``: symbol -> (ms,
    launches) a step, from the profiler) are timed beside the bound, the
    plain version and a library yardstick, and the grid ones tabled by
    device time.  Returns the timing rows by symbol."""
    from repro_torch.core.offload import (
        _matmul_gen,
        _segment_kernel,
        segment_call,
        segment_programs,
    )

    t0 = time.perf_counter()
    segs = train_segments(plans)
    grids = sorted((sym for sym, (_, s, _) in segs.items()
                    if s.matmul is None), key=lambda sym: -segs[sym][2])
    grid_ms = grid_ms or {}
    timed_grid = set(grids[:TIMED_GRID]) | set(sorted(
        grid_ms, key=lambda sym: -grid_ms[sym][0])[:TOP_GRID])
    rows, summary, failed, off_sm90 = {}, {}, [], []
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
        repeat = ""
        if mm is not None and dtype == torch.bfloat16:
            # bf16 dlhs / drhs and fwd of 64 rows a slice or more on the
            # sm90 mainloop, a shorter fwd on the weight stream
            gen = _matmul_gen(segment_call(eqns, seg))
            want = "stream" if form == "fwd" and \
                seg.rows // mm.batch < 64 else "sm90"
            if gen["path"] != want or not gemm_path(gen).startswith(want):
                off_sm90.append(f"{form} {sym} [{seg.rows}x{mm.k}]: "
                                f"{gemm_path(gen)}")
            if form == "drhs":
                # no K split, no atomics: a second launch is bit-equal
                again = call(*vals)
                torch.cuda.synchronize()
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                repeat = f", relaunch bit-equal {same}"
                if not same:
                    failed.append(f"drhs relaunch {sym}")
                del again
        print(f"{tag}   {describe_segment(eqns, seg, count)} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e}"
              f"{', bit-equal' if bits else ''}{repeat}")
        if not ok:
            print(f"{tag}     FAILED: elements outside the bound "
                  f"{n_outside(got, want, dtype)} of "
                  f"{[w.numel() for w in want]}")
            failed.append(f"{form} {sym}")
            continue
        if not timed or (mm is None and sym not in timed_grid):
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
                lib_name = "torch.bmm" if a.dim() == 3 else "torch.matmul"

                def lib():
                    return torch.matmul(a, b)
        else:
            lib, lib_name = yardstick(segment_call(eqns, seg), vals, want)
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
        if mm is None:
            rows[sym].update(grid_row(seg, progs, vals, got),
                             library=lib_name)
        print(f"{tag}     {ms:.4f} ms on the card (CUDA-graph replay), plain "
              f"{plain_ms:.4f} ms, {lib_name or 'library'} "
              f"{'-' if library_ms is None else f'{library_ms:.4f}'} ms, "
              f"bound {bound_ms:.4f} ms by {rows[sym]['bound_by']} "
              f"({n_bytes} bytes, {flops} flops; bound / kernel = "
              f"{bound_ms / ms:.1%}) on {card}")
    if timed:
        print_grid_table(rows, grid_ms, tag)
    for form, (n, n_launch, worst) in summary.items():
        print(f"{tag} {str(dtype)[6:]} {form}: {n} distinct segments checked "
              f"({n_launch} in the plans), worst max_abs_err {worst:.3e}")
    variants = {f"{k} / {v}": n
                for (k, v), n in kernel_guard().variants.items()}
    print(f"{tag} {len(segs)} distinct segments checked in "
          f"{time.perf_counter() - t0:.1f} s; sm90 launches by variant "
          f"since the last count reset {variants}")
    check(not failed, f"segments differ from their plain versions: {failed}")
    check(not off_sm90, f"bf16 B3 / B4 / B6 segments off the sm90 mainloop "
          f"(fwd below 64 rows: the weight stream): {off_sm90}")
    return rows


def print_grid_table(rows: dict, grid_ms: dict, tag: str) -> None:
    """The timed B2 training segments, most device time a step first:
    the profiler's ms and launches a step, the segment's shape, roles,
    lane reduction, bytes, bound, CUDA-graph ms, share of the bound,
    operand copies, yardstick and geometry."""
    grid = sorted(((sym, r) for sym, r in rows.items() if r["kind"] == "grid"),
                  key=lambda x: -grid_ms.get(x[0], (0.0, 0))[0])
    if not grid:
        return
    print(f"{tag} B2 training segments timed (most device time a step "
          f"first; the {TOP_GRID} most time-consuming and the {TIMED_GRID} "
          f"most launched):")
    for sym, r in grid:
        step_ms, n = grid_ms.get(sym, (0.0, 0))
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{tag}   {sym[:24]} {step_ms:8.3f} ms/step {n:4.0f}x/step "
              f"{r['shape']} roles {r['roles']} reduce {r['reduce']} "
              f"{r['bytes']} B bound {r['bound_ms']:.4f} ms kernel "
              f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}) copies "
              f"{r['copies']} strided in place {r['strided']} yardstick "
              f"{r['library']} {lib} ms geometry {r['geometry']}")


def sm90_chains():
    """(label, fn, shapes, f32 args) of bf16 chains that reach every
    variant of the sm90 mainloop (B3 fwd, B4 dlhs, B6 drhs) and of the
    weight stream (B3 fwd below 64 rows): the CPU tests' shapes
    (tests/test_torch_sm90_gemm.py, tests/test_torch_sm90_fwd.py; an lhs
    prologue or an f32 weight cast is register-staged), rows and a width
    TMA refuses (no multiple of 16 bytes), a long contraction on one tile
    (a K split), batch slices, and the full-width shapes of qwen3-1.7b's
    training forward and decode step.  ``f32`` names the arguments that
    are f32 (a master weight the chain casts)."""
    B, S, K, N = 2, 12, 40, 24
    yield ("dlhs param/rep/tile",
           lambda g, w, p, r, q: (torch.tanh(g @ w.t()) * p + r) * q,
           [(B, S, K), (N, K), (N,), (B, 1, N), (1, S, N)], ())
    yield ("dlhs lhs prologue, lane reduce",
           lambda g, s, w: (lambda h: h * torch.rsqrt(torch.mean(
               h * h, -1, keepdim=True) + 1e-5))((g * s) @ w.t()),
           [(B * S, K), (K,), (N, K)], ())
    yield ("dlhs batch 2",
           lambda g, w, y: torch.tanh(torch.bmm(g, w.transpose(1, 2))) + y,
           [(B, S, K), (B, N, K), (B, S, N)], ())
    yield ("drhs bulk/param",
           lambda x, g, w, b: ((x.t() @ g) * 0.5 + 0.01 * w) * b,
           [(B * S, K), (B * S, N), (K, N), (N,)], ())
    yield ("drhs batch 2",
           lambda x, g, w: torch.bmm(x.transpose(1, 2), g) + 0.01 * w,
           [(B, S, K), (B, S, N), (B, K, N)], ())
    yield ("drhs rows 70, width 36", lambda x, g: (x.t() @ g) * 2.0,
           [(100, 70), (100, 36)], ())
    yield ("dlhs K split", lambda g, w, y: g @ w.t() + y,
           [(128, 8192), (128, 8192), (128, 128)], ())
    # B3: the stream below 64 rows a slice, the sm90 mainloop from 64
    for rows in (B * S, 128):
        yield (f"fwd gelu, {rows} rows",
               lambda x, w: F.gelu(x @ w, approximate="tanh"),
               [(rows, K), (K, N)], ())
        yield (f"fwd lane reduce, {rows} rows",
               lambda x, w, y: (lambda h: h * torch.rsqrt(torch.mean(
                   h * h, -1, keepdim=True) + 1e-5))(x @ w + y),
               [(rows, K), (K, N), (rows, N)], ())
        yield (f"fwd lhs prologue, {rows} rows",
               lambda x, s, w: torch.tanh((x * s) @ w),
               [(rows, K), (K,), (K, N)], ())
        yield (f"fwd f32 weight cast, {rows} rows",
               lambda x, w: torch.tanh(x @ w.to(torch.bfloat16)),
               [(rows, K), (K, N)], (1,))
        yield (f"fwd width 36, {rows} rows", lambda x, w: (x @ w) * 2.0,
               [(rows, 100), (100, 36)], ())
        yield (f"fwd K split, {rows} rows", lambda x, w, y: x @ w + y,
               [(rows, 8192), (8192, 128), (rows, 128)], ())
    for per in (S, 64):
        yield (f"fwd batch 2 x {per} rows",
               lambda x, w, y: torch.tanh(torch.bmm(x, w)) + y,
               [(B, per, K), (B, K, N), (B, per, N)], ())
    # the full-width shapes: MLP up, a K split (k / v projection), the
    # f32 master weight cast, an lhs prologue; decode's gate
    D, FF = 2048, 6144
    yield ("fwd full width MLP up", lambda x, w: F.silu(x @ w),
           [(2048, D), (D, FF)], ())
    yield ("fwd full width K split", lambda x, w: (x @ w) * 0.5,
           [(2048, D), (D, 1024)], ())
    yield ("fwd full width f32 weight cast",
           lambda x, w: F.silu(x @ w.to(torch.bfloat16)),
           [(2048, FF), (FF, D)], (1,))
    yield ("fwd full width lhs prologue",
           lambda x, s, w: torch.tanh((x * s) @ w), [(2048, D), (D,),
                                                     (D, D)], ())
    yield ("fwd decode gate", lambda x, w: F.silu(x @ w),
           [(8, D), (D, FF)], ())
    yield ("fwd decode f32 weight cast",
           lambda x, w: F.silu(x @ w.to(torch.bfloat16)),
           [(8, D), (D, FF)], (1,))


def misaligned(v: torch.Tensor) -> torch.Tensor:
    """A copy of ``v`` (same shape and strides) one element past a
    16-byte boundary: a base TMA refuses."""
    base = torch.empty(_span(v) + 8, dtype=v.dtype, device=v.device)
    return base.as_strided(v.shape, v.stride(), storage_offset=1).copy_(v)


#: every variant of the sm90 mainloop and the weight stream, by kernel
GEMM_VARIANTS = {
    "fused_matmul_segment": (fm.SM90_TMA, fm.SM90_STAGED, fm.STREAM_ASYNC,
                             fm.STREAM_STAGED),
    "fused_matmul_dlhs_segment": (fm.SM90_TMA, fm.SM90_STAGED),
    "fused_matmul_drhs_segment": (fm.SM90_TMA, fm.SM90_STAGED),
}


def sm90_variants() -> None:
    """Every variant of the sm90 mainloop (``sm90 TMA``, ``sm90
    register-staged``) of B3, B4 and B6 and of B3's weight stream
    (``stream cp.async``, ``stream register-staged``) against its plain
    version: the chains of ``sm90_chains`` planned on the card, each
    anchored segment on its seeded exact-sum operands as given and on
    misaligned copies of them; every output bit-equal or within phase 6's
    rule, every kernel's every variant launched, every anchored segment
    of the chains planned."""
    from repro_torch.core import OffloadPolicy
    from repro_torch.core.offload import (
        _matmul_gen,
        _register_library,
        _segment_kernel,
        offload_report,
        segment_call,
        segment_programs,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    before = dict(kernel_guard().variants)
    failed, lines, plans = [], [], []
    for label, fn, shapes, f32 in sm90_chains():
        args = [seeded(gen, sh, torch.float32 if i in f32 else
                       torch.bfloat16) for i, sh in enumerate(shapes)]
        plan = offload_report(fn, *args,
                              policy=OffloadPolicy(bulk_threshold=16))
        plan.library = _register_library(plan.eqns, plan)
        plans.append((label, plan))
        del args
    _, build_s, _, _ = build_units([plan for _, plan in plans])
    print(f"[7] the chains' {len(plans)} translation units built together "
          f"in {build_s:.1f} s")
    for label, plan in plans:
        anchored = [seg for seg in plan.segments if seg.matmul is not None]
        if not anchored:
            failed.append(f"{label}: no anchored segment")
        for seg in anchored:
            progs = segment_programs(plan.eqns, seg)
            call = _segment_kernel(seg, progs, impl="cuda")
            ref = _segment_kernel(seg, progs, impl="ref")
            name = _matmul_gen(segment_call(plan.eqns, seg))["name"]
            vals = seg_operands(seg, 17)
            for how, vs in (("as given", vals),
                            ("misaligned", [misaligned(v) for v in vals])):
                got = call(*vs)
                torch.cuda.synchronize()
                want = ref(*vs)
                ok, err = seg_close(got, want, torch.bfloat16)
                bits = all(torch.equal(g, w) for g, w in zip(got, want))
                lines.append(f"{label} {how}: "
                             f"{kernel_guard().last_variant[name]}, "
                             f"max_abs_err {err:.1e}"
                             f"{' bit-equal' if bits else ''}")
                if not ok:
                    failed.append(f"{label} {how}")
                del got, want
            del vals
    ran = {k: n - before.get(k, 0)
           for k, n in kernel_guard().variants.items()}
    print(f"[7] sm90 / stream variants at the CPU tests' shapes, rows TMA "
          f"refuses, K splits, batch slices and full width: "
          f"{'; '.join(lines)}; launches {ran}")
    check(not failed, f"sm90 / stream variants differ from the plain "
          f"versions: {failed}")
    check(all(ran.get((k, v), 0) > 0 for k, vs in GEMM_VARIANTS.items()
              for v in vs), f"a GEMM variant was not launched: {ran}")


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
    # every dtype of p and g the kernel takes, at a ragged size (packs and
    # a scalar tail) and one element off 16 bytes (every element scalar)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for off in (0, 1):
            def t(dtype):
                x = torch.randn(3007 + off, generator=gen, device=DEVICE)
                return x.to(dtype)[off:]
            small = (t(dt), t(dt), t(torch.float32), t(torch.float32).abs(),
                     hyper)
            check(all(torch.equal(a, b) for a, b in zip(
                ops.adamw_update(*small, impl="cuda"),
                adamw_update_plain(*small))),
                f"B8 differs from its plain version: p {dt}, offset {off}")
    print("[7] B8 bit-equal to its plain version for p / g in f32, bf16 and "
          "f16 at 3,007 elements, aligned and one element off 16 bytes")
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


def update_leaf_segment(uplan, b8: dict, card: str) -> None:
    """The offloaded update's B2 segment on the largest leaf (the
    [152,064 x 2,048] embedding), timed beside B8 on the same leaf: both
    compute AdamW over it (the segment also scales the gradient by the
    clip factor)."""
    from repro_torch.core.offload import _segment_kernel, segment_programs

    seg = max(uplan.segments, key=lambda sg: sg.rows)
    progs = segment_programs(uplan.eqns, seg)
    call = _segment_kernel(seg, progs, impl="cuda")
    vals = seg_operands(seg, 7)
    outs = call(*vals)
    ms = graph_ms(lambda i: call(*vals), 2, replays=5)
    r = grid_row(seg, progs, vals, outs)
    bound = r["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"[7] the update's B2 segment on the largest leaf {r['shape']}: "
          f"roles {r['roles']}, {len(outs)} outputs, {r['bytes']} bytes, "
          f"{ms:.4f} ms on the card (CUDA-graph replay), bound {bound:.4f} "
          f"ms by bytes ({bound / ms:.1%}), copies {r['copies']}, geometry "
          f"{r['geometry']}; B8 on the same leaf {b8['ms']:.4f} ms "
          f"({b8['bound_ms'] / b8['ms']:.1%} of its bound) on {card}")


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
    state, counts, reading = train_steps(step, held, data, tokens, plans)
    reading.update(memory_split(step, state,
                                device_batch(data.batch(3), DEVICE), plans))
    batch = device_batch(data.batch(0), DEVICE)
    grads = train_numerics(model, step, state, batch, tcfg,
                           "bf16 offloaded vs plain step", f32=False)
    b8 = phase_adamw(state, grads, tcfg, card)
    del grads
    rows = check_train_segments(plans, torch.bfloat16, card, timed=True,
                                grid_ms=reading["grid"])
    update_leaf_segment(plans[-1], b8, card)
    sm90_variants()
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


# --------------------------------------------- flash and batched anchors (8)

#: the attention width of qwen3-1.7b: 16 query heads over 8 kv heads,
#: head_dim 128; 2 sequences of 2,048 tokens
FLASH_SHAPE = (2, 2048, 16, 8, 128)
#: the CPU tests' shapes (tests/test_torch_flash.py): B, S, NQ, NK, H,
#: causal, window
FLASH_SMALL = [(1, 64, 4, 4, 16, True, 0), (2, 128, 8, 2, 32, True, 0),
               (1, 96, 4, 1, 64, False, 0), (2, 160, 4, 2, 16, True, 24),
               (1, 70, 2, 2, 16, True, 0)]
#: head dims the 16-bit kernels take since queue C2's lift, each on the
#: instantiation of the next width (64 / 128 / 256): B, S, NQ, NK, H,
#: causal, window
FLASH_WIDE = [(2, 130, 4, 2, 24, True, 0), (1, 200, 6, 2, 96, False, 0),
              (2, 100, 4, 4, 256, True, 0), (1, 150, 6, 3, 96, True, 40)]
#: B5 / B7 against their plain versions: f32 2e-5 (tests/test_kernels.py);
#: bf16 forward 2e-2 (P is rounded to bf16 for the tensor cores, the plain
#: version keeps it f32); bf16 gradients 5e-2 (tests/test_offload_
#: attention.py), and besides within 5e-2 of the gradient's max-abs; f16
#: forward 4e-3 and gradients 1e-2 (and 1e-2 of the max-abs): P and dS
#: are rounded to f16, 2^-11 relative, eight times finer than bf16, and an
#: O(1) output's own f16 ulp is up to 2^-9 — no looser than bf16's; the
#: log-sum-exp (f32 statistics from products summed in another order) 1e-4
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2, torch.float16: 1e-2}
LSE_TOL = 1e-4
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
#: a backward segment on the path's operands, where phase 6's bf16 rule
#: fails: at most twice the spread of the eager ops around the plain
#: version (``check_path_segments``; chosen after a run in which 2 of the
#: flash backward's 5 segments missed phase 6's rule on 1 to 880 elements,
#: each by exactly the eager ops' own spread)
PATH_SPREAD = 2.0


def attention_chain(q, k, v):
    """The reference test's GQA chain (tests/test_offload_attention.py):
    kv heads repeated per group, QK^T / sqrt(d), softmax, PV."""
    g = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    scale = torch.tensor(math.sqrt(q.shape[-1])).to(q.dtype)
    s = torch.einsum("bhsd,bhtd->bhst", q, k) / scale
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), v)


def batched_gemm_bwd(g, x, w):
    """benchmarks/offload_bench.py's BATCHED_GEMM_BWD chain, in torch."""
    dx = torch.tanh(g @ w.transpose(1, 2)) * 0.5 + x * 0.1
    dw = x.transpose(1, 2) @ g + 0.01 * w
    return dx, dw


def within(got, want, tol: float, rel_max: float | None = None
           ) -> tuple[bool, float]:
    """``got`` against ``want``: allclose at ``tol`` (rtol = atol), and,
    with ``rel_max``, every difference within that share of the
    reference's max-abs.  Returns (ok, max_abs_err)."""
    g, w = got.detach().float(), want.detach().float()
    err = max_err(g, w)
    ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=tol,
                                                          atol=tol)
    if rel_max is not None:
        ok = ok and err <= rel_max * float(w.abs().max())
    return ok, err


def seeded(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def flash_paths() -> dict:
    """Launches of B5 / B7 since the last count reset by the path each
    took: ``sm90`` (the bf16 / f16 wgmma kernels) or ``fma`` (f32)."""
    return {f"{name} / {path}": n
            for (name, path), n in sorted(kernel_guard().variants.items())
            if name in FLASH_KERNELS}


def check_paths(dtype, what: str) -> dict:
    """Every B5 / B7 launch since the last count reset took the path of
    ``dtype``: sm90 for bf16 and f16, the FMA kernels for f32."""
    paths = flash_paths()
    want = "fma" if dtype == torch.float32 else "sm90"
    check(paths and all(key.endswith(want) for key in paths),
          f"{what}: B5 / B7 launches off the {want} path: {paths}")
    return paths


def flash_case(gen, shape, dtype):
    b, s, nq, nk, h, causal, window = shape
    q, k, v, do = (seeded(gen, sh, dtype) for sh in (
        (b, s, nq, h), (b, s, nk, h), (b, s, nk, h), (b, s, nq, h)))
    return q, k, v, do, dict(causal=causal, window=window)


def flash_small_shapes() -> None:
    """B5 (with lse) and both B7 kernels against their plain versions at
    the CPU tests' shapes in f32, bf16 and f16, and the 16-bit kernels at
    head dims 24 / 96 / 256 (``FLASH_WIDE``); every launch made twice,
    bit-equal; every 16-bit launch on the sm90 kernels, every f32 one on
    the FMA kernels."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    worst: dict = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        shapes = FLASH_SMALL + ([] if dtype == torch.float32 else FLASH_WIDE)
        ops.reset_launch_counts()
        for i, shape in enumerate(shapes):
            gen = torch.Generator(device=DEVICE).manual_seed(100 + i)
            q, k, v, do, kw = flash_case(gen, shape, dtype)
            runs = []
            for _ in range(2):
                o, lse = ops.flash_attention(q, k, v, return_lse=True,
                                             impl="cuda", **kw)
                runs.append((o, lse, *flash_attention_bwd(q, k, v, o, lse,
                                                          do, **kw)))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"B5 / B7 relaunch at {shape} {dtype} not bit-equal")
            o, lse, *grads = runs[0]
            wo, wl = flash_attention_plain(q, k, v, return_lse=True, **kw)
            wgrads = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            res = [("fwd", *within(o, wo, FLASH_TOL[dtype])),
                   ("lse", *within(lse, wl, LSE_TOL))]
            res += [(n, *within(a, w, GRAD_TOL[dtype]))
                    for n, a, w in zip(("dq", "dk", "dv"), grads, wgrads)]
            for name, ok, err in res:
                key = (str(dtype)[6:], name)
                worst[key] = max(worst.get(key, 0.0), err)
                check(ok, f"B5/B7 {name} at {shape} {dtype}: "
                      f"max_abs_err {err:.3e}")
        paths = check_paths(dtype, f"{dtype} small shapes")
        print(f"[8] B5 / B7 at {len(shapes)} shapes {str(dtype)[6:]} "
              f"(the CPU tests' {len(FLASH_SMALL)}"
              f"{'' if dtype == torch.float32 else ', head dims 24 / 96 / 256'}"
              f"), each launched twice: bit-equal; launches by path {paths}")
    print(f"[8] B5 / B7 against the plain versions: worst max_abs_err "
          f"{ {f'{d} {n}': f'{e:.2e}' for (d, n), e in worst.items()} }")


def flash_library(card: str) -> tuple[dict, dict]:
    """The kernel library at full width: ``ops.flash_attention`` causal,
    windowed, unmasked and with the log-sum-exp in bf16, f16 and f32,
    ``flash_attention_diff`` forward and backward against autograd of the
    plain version and B7 windowed and unmasked in bf16 and f16; B5 causal
    and B7's kernels unmasked and causal timed (bf16).  Returns the
    unmasked B7 rows of the kernels line and the launches of the bf16
    diff call."""
    from repro_torch.kernels import flash_attention_diff
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        row_dot,
    )

    b, s, nq, nk, h = FLASH_SHAPE
    diff_counts = None
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        name = str(dt)[6:]
        gen = torch.Generator(device=DEVICE).manual_seed(8)
        q, k, v, do = (seeded(gen, shape, dt) for shape in (
            (b, s, nq, h), (b, s, nk, h), (b, s, nk, h), (b, s, nq, h)))
        ops.reset_launch_counts()
        for causal, window in ((True, 0), (True, 512), (False, 0)):
            o, lse = ops.flash_attention(q, k, v, causal=causal,
                                         window=window, return_lse=True,
                                         impl="cuda")
            torch.cuda.synchronize()
            wo, wl = flash_attention_plain(q, k, v, causal=causal,
                                           window=window, return_lse=True)
            ok_o, err_o = within(o, wo, FLASH_TOL[dt])
            ok_l, err_l = within(lse, wl, LSE_TOL)
            print(f"[8] ops.flash_attention {tuple(q.shape)} x "
                  f"{tuple(k.shape)} {name} causal={causal} window={window}"
                  f": out max_abs_err {err_o:.3e}, lse {err_l:.3e}")
            check(ok_o and ok_l, f"B5 full width {name} causal={causal} "
                  f"window={window} vs plain")
        del o, lse, wo, wl
        if dt == torch.float32:    # B7 takes f32 only up to head dim 64
            check_paths(dt, "f32 full width")
            continue

        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launch_counts()
        out = flash_attention_diff(*leaves, True, 0)
        got = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        diff_counts = diff_counts or counts
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        pout = flash_attention_plain(*plain, causal=True)
        want = torch.autograd.grad(pout, plain, do)
        ok, err = within(out, pout, FLASH_TOL[dt])
        msgs = [f"out {err:.3e}"]
        for gname, a, w in zip(("dq", "dk", "dv"), got, want):
            ok_g, err_g = within(a, w, GRAD_TOL[dt], rel_max=GRAD_TOL[dt])
            ok = ok and ok_g
            msgs.append(f"{gname} {err_g:.3e} (max-abs "
                        f"{float(w.abs().max()):.3f})")
        print(f"[8] flash_attention_diff {name} causal, forward and "
              f"backward against autograd of the plain version: "
              f"max_abs_err {', '.join(msgs)}; launches "
              f"{({k_: n for k_, n in counts.items() if n})}")
        check(ok, f"flash_attention_diff {name} vs autograd of the plain "
              f"version")
        check(counts["flash_attention"] == 1 and
              counts["flash_attention_bwd_dkv"] == 1 and
              counts["flash_attention_bwd_dq"] == 1,
              f"flash_attention_diff launches {counts}")
        del leaves, out, got, plain, pout, want

        # B7 alone at the full width, windowed and unmasked
        for causal, window in ((True, 512), (False, 0)):
            o, lse = ops.flash_attention(q, k, v, causal=causal,
                                         window=window, return_lse=True,
                                         impl="cuda")
            dvec = row_dot(do, o)
            kw = dict(causal=causal, window=window)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dvec, **kw)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, dvec, **kw)
            torch.cuda.synchronize()
            wq, wk, wv = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            errs = {"dkv": max(within(dk, wk, GRAD_TOL[dt])[1],
                               within(dv, wv, GRAD_TOL[dt])[1]),
                    "dq": within(dq, wq, GRAD_TOL[dt])[1]}
            print(f"[8] B7 {name} causal={causal} window={window} against "
                  f"its plain version: max_abs_err dkv {errs['dkv']:.3e}, "
                  f"dq {errs['dq']:.3e}")
            check(all(within(a, w, GRAD_TOL[dt], rel_max=GRAD_TOL[dt])[0]
                      for a, w in ((dk, wk), (dv, wv), (dq, wq))),
                  f"B7 {name} causal={causal} window={window} full width "
                  f"vs plain")
            del wq, wk, wv
        print(f"[8] full width {name}: launches by path "
              f"{check_paths(dt, f'{name} full width')}")
        if dt == torch.bfloat16:
            timed = (q, k, v, do, o, lse, dvec, errs)
    q, k, v, do, o, lse, dvec, errs = timed
    dt = torch.bfloat16
    rows = {}
    for causal in (False, True):
        if causal:
            o, lse = ops.flash_attention(q, k, v, causal=True,
                                         return_lse=True, impl="cuda")
            dvec = row_dot(do, o)
        kw = dict(causal=causal, window=0)
        plain_ms = time_ms(lambda i: flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), 2, warmup=1)
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                              enable_gqa=True)
        ldo = do.transpose(1, 2)
        library_ms = time_ms(lambda i: torch.autograd.grad(
            lout, (lq, lk, lv), ldo, retain_graph=True), 4)
        # products of the reference's backward (2 * S * T * H each, per
        # batch and query head, over the pairs the mask keeps): dkv
        # recomputes S and dP and forms dV and dK (4), dq recomputes S and
        # dP and forms dQ (3) — 7 in all
        pairs = s * (s + 1) // 2 if causal else s * s
        unit = 2 * b * nq * pairs * h
        mask = "causal" if causal else "unmasked"
        if causal:
            fwd_ms = graph_ms(lambda i: ops.flash_attention(
                q, k, v, causal=True, impl="cuda"), 4)
            fwd_lib = graph_ms(lambda i: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True, enable_gqa=True), 4)
            fwd_bound = 2 * unit / PEAK_FLOPS[dt] * 1e3
            print(f"[8] B5 causal {tuple(q.shape)} x {tuple(k.shape)} bf16: "
                  f"{fwd_ms:.4f} ms on the card (CUDA-graph replay), library "
                  f"{fwd_lib:.4f} ms (scaled_dot_product_attention, "
                  f"is_causal, enable_gqa), bound {fwd_bound:.4f} ms by "
                  f"operations (2 products over {pairs} pairs a head, "
                  f"{2 * unit} flops; bound / kernel = "
                  f"{fwd_bound / fwd_ms:.1%}) on {card}")
        io = {"dkv": [q, k, v, do, lse, dvec, k, v],
              "dq": [q, k, v, do, lse, dvec, q]}
        for name, fn, n_prod in (
                ("dkv", lambda i: flash_attention_bwd_dkv(
                    q, k, v, do, lse, dvec, **kw), 4),
                ("dq", lambda i: flash_attention_bwd_dq(
                    q, k, v, do, lse, dvec, **kw), 3)):
            ms = graph_ms(fn, 2, replays=5)
            n_bytes = sum(t.numel() * t.element_size() for t in io[name])
            t_ops = n_prod * unit / PEAK_FLOPS[dt] * 1e3
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            row = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes
                       else "bytes", library_ms=library_ms)
            if not causal:
                rows[name] = row
            print(f"[8] B7 {name} {mask} {tuple(q.shape)} x "
                  f"{tuple(k.shape)} bf16: {ms:.4f} ms on the card "
                  f"(CUDA-graph replay), plain (all three gradients) "
                  f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
                  f"(scaled_dot_product_attention's backward"
                  f"{', is_causal' if causal else ''}, enable_gqa, all three "
                  f"gradients), bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} ({n_prod} products, {n_prod * unit} "
                  f"flops; {n_bytes} bytes; bound / kernel = "
                  f"{row['bound_ms'] / ms:.1%}) on {card}")
        del lq, lk, lv, lout
    return rows, diff_counts


def flash_path(card: str) -> tuple[dict, dict]:
    """The slice's path at full width: ``mpu_offload`` of the GQA
    attention chain plans one flash segment over (2, 16) batch axes,
    launches B5, agrees with the unwrapped chain; its gradients through
    the planned backward agree with autograd of the chain.  Returns the
    B5 row of the kernels line and the launches of the forward run."""
    from repro_torch.core import OffloadPolicy, mpu_offload
    from repro_torch.core.offload import (
        _build_runner,
        bwd_plans,
        capture,
        clear_bwd_plans,
        node_val,
        plan_offload,
    )

    b, s, nq, nk, h = FLASH_SHAPE
    dt = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    q = seeded(gen, (b, nq, s, h), dt)
    k = seeded(gen, (b, nk, s, h), dt)
    v = seeded(gen, (b, nk, s, h), dt)
    wrapped = mpu_offload(attention_chain, policy=OffloadPolicy())
    plan = wrapped.warm(q, k, v)
    flash = [seg for seg in plan.segments
             if seg.matmul is not None and seg.matmul.flash is not None]
    print(f"[8] mpu_offload(attention chain) q {tuple(q.shape)} k, v "
          f"{tuple(k.shape)} bf16: {len(plan.segments)} fused segments "
          f"{[d.form or 'grid' for d in plan.decisions if d.fused]}, "
          f"{sum(not d.fused for d in plan.decisions)} declined; flash "
          f"batch_shape {[seg.matmul.batch_shape for seg in flash]}, scale "
          f"{[seg.matmul.flash['scale'] for seg in flash]}; traffic "
          f"{plan.traffic_reduction:.2f}x ({plan.naive_hbm_bytes} -> "
          f"{plan.fused_hbm_bytes} bytes)")
    check(len(flash) == 1 and flash[0].matmul.batch_shape == (b, nq),
          "the attention chain did not plan one flash segment over (2, 16)")
    check(plan.traffic_reduction >= 4.0, "flash traffic reduction < 4x")
    scale = flash[0].matmul.flash["scale"]

    ops.reset_launch_counts()
    out = wrapped(q, k, v)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = attention_chain(q, k, v)
    ok, err = within(out, want, FLASH_TOL[dt], rel_max=FLASH_TOL[dt])
    print(f"[8] offloaded chain vs the unwrapped chain: max_abs_err "
          f"{err:.3e} (max-abs {float(want.abs().max()):.3f}); launches "
          f"{({k_: n for k_, n in counts.items() if n})}")
    check(ok, "offloaded attention chain vs the unwrapped chain")
    check(counts["flash_attention"] == 1, "the flash segment launched no B5")
    del out, want

    # B5 on the flash segment's own operands, against its plain version
    g = nq // nk
    q3 = q.reshape(b * nq * s, h)
    k3 = torch.repeat_interleave(k, g, dim=1).reshape(b * nq * s, h)
    v3 = torch.repeat_interleave(v, g, dim=1).reshape(b * nq * s, h)
    kw = dict(batch=b * nq, rows=b * nq * s, head_dim=h, t_dim=s, n_dim=h,
              scale=scale, out_dtype=dt)
    ops.reset_launch_counts()
    (got,) = ops.fused_flash_segment(q3, k3, v3, impl="cuda", **kw)
    (again,) = ops.fused_flash_segment(q3, k3, v3, impl="cuda", **kw)
    torch.cuda.synchronize()
    paths = check_paths(dt, "the flash segment")
    (ref,) = ops.fused_flash_segment(q3, k3, v3, impl="ref", **kw)
    ok, b5_err = within(got, ref, FLASH_TOL[dt])
    check(ok, f"B5 on the flash segment vs plain: {b5_err:.3e}")
    check(torch.equal(got, again), "B5 on the flash segment: a relaunch "
          "is not bit-equal")
    print(f"[8] B5 on the flash segment launched twice: bit-equal; launches "
          f"by path {paths}")
    ms = graph_ms(lambda i: ops.fused_flash_segment(q3, k3, v3, impl="cuda",
                                                    **kw), 4)
    plain_ms = time_ms(lambda i: ops.fused_flash_segment(
        q3, k3, v3, impl="ref", **kw), 2, warmup=1)
    sq, sk, sv = (t.reshape(b, nq, s, h) for t in (q3, k3, v3))
    library_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
        sq, sk, sv, scale=scale), 4)
    flops = 2 * 2 * b * nq * s * s * h
    n_bytes = 4 * q3.numel() * q3.element_size()
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    b5 = dict(max_abs_err=b5_err, ms=ms, plain_ms=plain_ms,
              bound_ms=max(t_ops, t_bytes),
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              library_ms=library_ms)
    print(f"[8] B5 on the flash segment ({b * nq} slices x [{s}x{h}], "
          f"unmasked, scale {scale:.6f}) bf16: max_abs_err {b5_err:.3e} vs "
          f"plain; {ms:.4f} ms on the card (CUDA-graph replay), plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
          f"(scaled_dot_product_attention), bound {b5['bound_ms']:.4f} ms "
          f"by {b5['bound_by']} (2 products, {flops} flops; {n_bytes} bytes;"
          f" bound / kernel = {b5['bound_ms'] / ms:.1%}) on {card}")
    del got, again, ref, q3, k3, v3, sq, sk, sv

    # the planned backward of the flash segment
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ct = seeded(gen, (b, nq, s, h), dt)
    clear_bwd_plans()
    ops.reset_launch_counts()
    grads = torch.autograd.grad(wrapped(*leaves), leaves, ct)
    torch.cuda.synchronize()
    bwd_counts = ops.launch_counts()
    plans = bwd_plans()
    for p in plans:
        print(f"[8] backward plan: fused "
              f"{[(d.form or 'grid', d.batch) for d in p.decisions if d.fused]}"
              f"; declined "
              f"{[(d.form or 'grid', d.batch) for d in p.decisions if not d.fused]}")
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_chain(*plain), plain, ct)
    ok, msgs = True, []
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        ok_g, err_g = within(a, w, GRAD_TOL[dt], rel_max=GRAD_TOL[dt])
        ok = ok and ok_g
        msgs.append(f"{name} {err_g:.3e} (max-abs {float(w.abs().max()):.3f})")
    print(f"[8] gradients through the offloaded chain vs autograd of the "
          f"chain: max_abs_err {', '.join(msgs)}; launches "
          f"{({k_: n for k_, n in bwd_counts.items() if n})}")
    check(ok, "gradients through the offloaded attention chain")
    check(any(d.fused and d.form in ("dlhs", "drhs") and d.batch
              for p in plans for d in p.decisions),
          "the flash segment's backward planned no batched contraction")
    del grads, want, leaves, plain

    # every segment of that backward plan on the operands the path gives
    # it: the chain's runner is run once more, recording the flash call's
    # operands, and its backward plan's runner on them and the cotangent
    pol = OffloadPolicy()
    gm, _, _ = capture(attention_chain, (q, k, v))
    rec = SegmentRecorder(_build_runner(gm, plan_offload(gm, policy=pol),
                                        pol.impl, grad_policy=pol))
    rec.run(q, k, v)
    fcall, primals = next((t, a) for t, a in rec.calls
                          if t.segment.matmul is not None
                          and t.segment.matmul.flash is not None)
    cts = [ct.reshape(node_val(fcall.segment.outputs[0]).shape)]
    run, bplan, diff, rest, outs = fcall.bwd.entry_for(list(primals), cts)
    brec = SegmentRecorder(run)
    brec.run(*[primals[i] for i in diff], *[primals[i] for i in rest],
             *[cts[j] for j in outs])
    check_path_segments(bplan.eqns, brec.calls, card)
    return b5, counts


class SegmentRecorder(torch.fx.Interpreter):
    """Runs a plan's runner graph, keeping the operands of every fused
    segment call (the calls carry their ``segment``)."""

    def __init__(self, gm):
        super().__init__(gm)
        self.calls = []

    def call_function(self, target, args, kwargs):
        if getattr(target, "segment", None) is not None:
            self.calls.append((target, args))
        return super().call_function(target, args, kwargs)


def check_path_segments(eqns, calls, card: str) -> None:
    """Every segment call of a backward plan (``eqns`` its graph's call
    nodes) against its plain version on the operands the path gave it,
    timed beside the bound, the plain version and torch.matmul.

    The kernel sums a product's f32 terms in another order than the plain
    version, so a bf16 product can round one ulp apart, and an epilogue
    that carries it through ``exp`` or a second row sum widens that.  Each
    output is held to phase 6's bf16 rule or, where that fails, to
    ``PATH_SPREAD`` times the largest difference between the plain version
    and the segment's own ops run unfused in eager PyTorch (cuBLAS's
    product, the same epilogue ops) on the same operands: the kernel as
    close to the plain version as eager PyTorch is."""
    from repro_torch.core.offload import (
        _segment_kernel,
        _segment_replay,
        segment_programs,
    )

    failed = []
    for run, vals in calls:
        seg = run.segment
        mm = seg.matmul
        # a 0-dim constant is moved to the card before any graph capture
        vals = [v.to(DEVICE) if v.dim() == 0 else v for v in vals]
        ref = _segment_kernel(seg, segment_programs(eqns, seg), impl="ref")
        got = run(*vals)
        torch.cuda.synchronize()
        want = ref(*vals)
        eager = _segment_replay(eqns, seg)(*vals)
        ok, errs, spreads = True, [], []
        for g, w, e in zip(got, want, eager):
            rule, err = seg_close([g], [w], torch.bfloat16)
            spread = seg_close([e], [w], torch.bfloat16)[1]
            ok = ok and (rule or err <= PATH_SPREAD * spread)
            errs.append(err)
            spreads.append(spread)
        bits = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"[8]   {describe_segment(eqns, seg, 1)} bf16 on the path's "
              f"operands: max_abs_err by output {[f'{x:.2e}' for x in errs]}"
              f"{', bit-equal' if bits else ''}; eager ops vs plain "
              f"{[f'{x:.2e}' for x in spreads]}; outside phase 6's rule "
              f"{n_outside(got, want, torch.bfloat16)} of "
              f"{[w.numel() for w in want]}")
        if not ok:
            failed.append(f"{mm.form if mm else 'grid'}")
            continue
        ms = graph_ms(lambda i: run(*vals), 2, replays=5)
        plain_ms = time_ms(lambda i: ref(*vals), 2, warmup=1)
        lib, lib_name = None, "torch.matmul"
        if mm is not None:
            a, b = vals[0], vals[len(mm.lhs_specs)]
            lib = graph_ms(lambda i: torch.matmul(a, b), 2, replays=5)
            lib_name = "torch.bmm" if a.dim() == 3 else lib_name
        n_bytes = sum(_span(v) * v.element_size() for v in vals) + \
            sum(o.numel() * o.element_size() for o in got)
        flops = 2 * seg.rows * mm.k * mm.n if mm is not None else 0
        bound = max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[
            torch.bfloat16]) * 1e3
        print(f"[8]     {ms:.4f} ms on the card (CUDA-graph replay), plain "
              f"{plain_ms:.4f} ms, {lib_name} "
              f"{'-' if lib is None else f'{lib:.4f}'} ms, bound "
              f"{bound:.4f} ms ({n_bytes} bytes, {flops} flops; bound / "
              f"kernel = {bound / ms:.1%}) on {card}")
    check(not failed, f"backward segments differ from their plain versions: "
          f"{failed}")


#: the declined flash chain (queue C, C1): the attention chain with one
#: kv head per query head at a head dim B5 refuses, f32; [B, heads, S, d]
DECLINED_SHAPE = (2, 8, 256, 96)


def flash_declined() -> None:
    """A chain whose flash pair B5 refuses (head_dim 96, f32): the planner
    declines the pair with B5's reason, the chain runs end to end on the
    card through its ordinary segments, launches no B5, and agrees with
    the unwrapped chain (f32 anchored segments: 1e-4, SEG_TOL's rule)."""
    from repro_torch.core import OffloadPolicy, mpu_offload

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    q, k, v = (seeded(gen, DECLINED_SHAPE, torch.float32) for _ in range(3))
    wrapped = mpu_offload(attention_chain,
                          policy=OffloadPolicy(bulk_threshold=64))
    report = wrapped.explain(q, k, v)
    plan = wrapped.warm(q, k, v)
    reasons = [d.reason for d in report.decisions
               if d.form == "flash" and not d.fused]
    check(not any(seg.matmul is not None and seg.matmul.flash is not None
                  for seg in plan.segments) and len(reasons) == 1
          and "head_dim 96" in reasons[0],
          f"the head_dim-96 chain was not declined as a flash pair: "
          f"{reasons}")
    ops.reset_launch_counts()
    out = wrapped(q, k, v)
    torch.cuda.synchronize()
    counts = {k_: n for k_, n in ops.launch_counts().items() if n}
    ok, err = within(out, attention_chain(q, k, v),
                     SEG_TOL[torch.float32][1])
    print(f"[8] C1: chain q, k, v {DECLINED_SHAPE} f32 — {reasons[0]}; "
          f"{len(plan.segments)} fused segments "
          f"{[d.form or 'grid' for d in report.decisions if d.fused]}, run "
          f"on the card with launches {counts}: max_abs_err {err:.3e} "
          f"against the unwrapped chain")
    check(ok and "flash_attention" not in counts and counts,
          "the declined chain on the card")


def phase_flash(card: str) -> tuple[dict, dict]:
    """Phase 8: the flash segment and batched anchors at full width.
    Returns the kernels line's rows of B5 and of B7's two kernels."""
    from repro_torch.core import OffloadPolicy
    from repro_torch.core.offload import offload_report

    t0 = time.perf_counter()
    flash_small_shapes()
    b5, path_counts = flash_path(card)
    flash_declined()
    b7, diff_counts = flash_library(card)
    # every distinct segment of the BATCHED_GEMM_BWD chain (bench shapes,
    # f32 and bf16) on seeded operands
    plans = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=DEVICE).manual_seed(15)
        args = (seeded(gen, (8, 256, 64), dt), seeded(gen, (8, 256, 128), dt),
                (0.1 * torch.randn((8, 128, 64), generator=gen,
                                   device=DEVICE)).to(dt))
        plan = offload_report(batched_gemm_bwd, *args,
                              policy=OffloadPolicy(bulk_threshold=4096))
        forms = [(s.matmul.form, s.matmul.batch_shape)
                 for s in plan.segments if s.matmul is not None]
        print(f"[8] BATCHED_GEMM_BWD {str(dt)[6:]}: {len(plan.segments)} "
              f"segments {forms}, traffic {plan.traffic_reduction:.2f}x")
        check(sorted(f for f, _ in forms) == ["dlhs", "drhs"],
              "BATCHED_GEMM_BWD did not plan batched dlhs and drhs")
        plans[dt] = [plan]
    check_train_segments(plans[torch.float32], torch.float32, card,
                         timed=False, tag="[8]")
    check_train_segments(plans[torch.bfloat16], torch.bfloat16, card,
                         timed=True, tag="[8]")
    print(f"[8] flash and batched anchors in {time.perf_counter() - t0:.1f} s")
    return (dict(launches=path_counts["flash_attention"], **b5),
            {name: dict(launches=diff_counts[f"flash_attention_bwd_{name}"],
                        **row) for name, row in b7.items()})


# --- phase 9: the kernel library's rmsnorm (B9), rotary (B10) and dense
# decode attention (B11) ---------------------------------------------------

#: the CPU tests' shapes (tests/test_torch_library_kernels.py), plus a D
#: that takes the scalar path in both dtypes, one wide enough that a
#: thread holds several vectors, and rows too wide for the registers (the
#: wide kernels, csrc/rmsnorm.cu): a scalar D of 2,050 (bf16 forward; the
#: backward still in registers), 4,099 (scalar, both directions, both
#: dtypes), 8,200 over 300 rows (f32 both directions, bf16 backward; more
#: rows than backward blocks), 16,392 (vectors, both) and 40,968 over 140
#: rows (the wide backward's partial row too large for shared memory)
NORM_SMALL = [(64, 128), (33, 96), (257, 64), (31, 99), (5, 8192),
              (7, 2050), (3, 4099), (300, 8200), (5, 16392), (140, 40968)]
ROPE_SMALL = [(100, 4, 32, 1e4), (64, 1, 64, 1e6), (16, 3, 20, 1e4)]
#: B11 cuts live tokens into 64-token chunks and the chunks into splits by
#: the shapes alone: T = 40 is one split, the others several (4, 2, 9)
DECODE_SMALL = [(3, 40, 4, 2, 32), (2, 256, 8, 2, 32), (3, 100, 4, 4, 16),
                (1, 513, 2, 1, 64)]
#: full width: the training batch's hidden states [2, 1024, d_model]
LIB_TOKENS = (2, 1024)
#: B9's ds sums one product a row over every row, in another order than
#: the plain version (per-block runs, then the block partials); in f32
#: each order errs by a few units of 2^-24 of the column's sum of
#: |g * xhat| per addition level, so the difference is held to 2^-19 (32
#: such units) of that sum, beside 2e-5 of |ds|
DS_ULPS_F32 = 2.0 ** -19
#: distinct input buffers the timed loops rotate through, so that each
#: call finds its inputs out of the 50 MB L2 (8 MB each for B9 / B10, 67
#: MB of K + V each for B11)
LIB_ROTATE = {"rmsnorm": 8, "rmsnorm_bwd": 4, "rotary": 8,
              "decode_attention": 3}


def rope_far_bound(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """Per-element bound of B10 against its plain version at large
    positions: a one-ulp difference in a frequency f (2^-24 f for f in
    [0.5, 1)) moves the angle at position P by up to P 2^-23 f, and the
    output by that times |x1| + |x2|; plus the f32 slack (2e-5)."""
    from repro_torch.kernels.rotary import rotary_freqs

    h = x.shape[-1]
    freqs = rotary_freqs(h, theta, x.device)
    shift = pos.float()[:, None, None] * 2.0 ** -23 * freqs[None, None, :]
    mag = x[..., : h // 2].float().abs() + x[..., h // 2:].float().abs()
    return torch.cat([shift * mag] * 2, dim=-1) + 2e-5


def norm_case(gen, rows_shape, d, dtype, scale_dtype):
    x = torch.randn((*rows_shape, d), generator=gen, device=DEVICE).to(dtype)
    s = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=DEVICE)).to(
        scale_dtype)
    g = torch.randn((*rows_shape, d), generator=gen, device=DEVICE).to(dtype)
    return x, s, g


def norm_grads(x, s, g, eps, impl):
    """dx, ds of ``ops.rmsnorm`` under the cotangent g (autograd)."""
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = ops.rmsnorm(xl, sl, eps=eps, impl=impl)
    y.backward(g)
    return y.detach(), xl.grad, sl.grad


def decode_case(shape, dtype, seed):
    """Dense caches and ragged lengths (T and 1, and 0 with three rows),
    token-major and head-major copies of the same values."""
    b, t, nq, nk, h = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = seeded(gen, (b, nq, h), dtype)
    kc, vc = (seeded(gen, (b, t, nk, h), dtype) for _ in range(2))
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    if b >= 2:
        lengths[0], lengths[-1] = t, 1
    if b >= 3:
        lengths[1] = 0
    hm = [c.transpose(1, 2).contiguous() for c in (kc, vc)]
    return q, kc, vc, hm[0], hm[1], lengths


def library_small_shapes() -> None:
    """B9 (forward, backward), B10 and B11 against their plain versions
    on the card at the CPU tests' shapes, f32 (2e-5) and bf16 (2e-2)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain

    worst: dict = {}

    def note(key, ok, err, what):
        worst[key] = max(worst.get(key, 0.0), err)
        check(ok, f"{what}: max_abs_err {err:.3e}")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for i, (rows, d) in enumerate(NORM_SMALL):
            gen = torch.Generator(device=DEVICE).manual_seed(200 + i)
            for sdt in dict.fromkeys((dtype, torch.float32)):
                x, s, g = norm_case(gen, (rows,), d, dtype, sdt)
                y, dx, ds = norm_grads(x, s, g, 1e-5, "cuda")
                wdx, wds = rmsnorm_bwd_plain(x, s, g)
                check(dx.dtype == dtype and ds.dtype == sdt,
                      f"B9 gradient dtypes {dx.dtype}, {ds.dtype}")
                note((dn, "rmsnorm"), *within(y, ops.rmsnorm(
                    x, s, impl="ref"), TOL[dtype]),
                    f"B9 at ({rows}, {d}) {dn}")
                note((dn, "rmsnorm_bwd dx"), *within(dx, wdx, TOL[dtype]),
                     f"B9-bwd dx at ({rows}, {d}) {dn}")
                note((dn, "rmsnorm_bwd ds"), *within(ds, wds, TOL[sdt]),
                     f"B9-bwd ds at ({rows}, {d}) {dn}, scale {sdt}")
        # x and g one element off 16-byte alignment: scalar loads, and a
        # row of 2,048 too wide for them in the forward's registers
        gen = torch.Generator(device=DEVICE).manual_seed(209)
        x, g = (seeded(gen, (64 * 2048 + 1,), dtype)[1:].view(64, 2048)
                for _ in range(2))
        s = norm_case(gen, (1,), 2048, dtype, dtype)[1]
        check(x.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0,
              "the misaligned B9 case is aligned")
        note((dn, "rmsnorm"), *within(ops.rmsnorm(x, s, impl="cuda"),
                                      ops.rmsnorm(x, s, impl="ref"),
                                      TOL[dtype]),
             f"B9 on a misaligned x (64, 2048) {dn}")
        for got, want, what in zip(rmsnorm_bwd(x, s, g),
                                   rmsnorm_bwd_plain(x, s, g), ("dx", "ds")):
            note((dn, f"rmsnorm_bwd {what}"), *within(got, want, TOL[dtype]),
                 f"B9-bwd {what} on a misaligned x, g (64, 2048) {dn}")
        for i, (r, n, h, theta) in enumerate(ROPE_SMALL):
            gen = torch.Generator(device=DEVICE).manual_seed(210 + i)
            x = seeded(gen, (r, n, h), dtype)
            pos = torch.randint(0, 4096, (r,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
            got = ops.rotary(x, pos, theta=theta, impl="cuda")
            note((dn, "rotary"), *within(got, ops.rotary(
                x, pos, theta=theta, impl="ref"), TOL[dtype]),
                f"B10 at {(r, n, h, theta)} {dn}")
            check(torch.equal(got, ops.rotary(x, pos.long(), theta=theta,
                                              impl="cuda")),
                  "B10 with int64 positions differs from int32")
        for i, shape in enumerate(DECODE_SMALL):
            q, kc, vc, kh, vh, lengths = decode_case(shape, dtype, 220 + i)
            want = ops.decode_attention(q, kc, vc, lengths, impl="ref")
            tm = ops.decode_attention(q, kc, vc, lengths, impl="cuda")
            hm = ops.decode_attention(q, kh, vh, lengths, head_major=True,
                                      impl="cuda")
            note((dn, "decode_attention"), *within(tm, want, TOL[dtype]),
                 f"B11 at {shape} {dn}")
            check(torch.equal(tm, hm), f"B11 token-major and head-major "
                  f"differ at {shape} {dn}")
            if shape[0] >= 3:
                check(bool((tm[1] == 0).all()),
                      "B11: a row with length 0 must come out as zeros")
    errs = {f"{d} {n}": f"{e:.2e}" for (d, n), e in worst.items()}
    print(f"[9] B9 / B10 / B11 at the CPU tests' shapes (and scalar-path, "
          f"wide and misaligned rows for B9; one and several splits for "
          f"B11), f32 and bf16, against the plain versions: worst "
          f"max_abs_err {errs}")


def lib_row(ms, plain_ms, library_ms, n_bytes, n_flops, dtype, err) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, n_bytes=n_bytes)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def library_full_width(card: str) -> tuple[dict, dict]:
    """The kernel library at the width of qwen3-1.7b: one counted run of
    the path (``ops.rmsnorm`` forward and backward on the hidden states,
    the q-norm, ``ops.rotary`` on q and k, ``ops.decode_attention`` in
    both layouts), its outputs against the plain versions in bf16 and f32,
    B11 against B1 on the same cache, then each kernel timed.  Returns the
    kernels line's rows and the path run's launches."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_bwd,
        rmsnorm_bwd_plain,
        rmsnorm_plain,
    )
    from repro_torch.kernels.rotary import rotary, rotary_plain

    cfg = get_config("qwen3-1.7b")
    d, nq, nk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    h, theta, eps = cfg.resolved_head_dim, cfg.rope_theta, cfg.norm_eps
    b, s = LIB_TOKENS
    rows = {}
    counts = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        gen = torch.Generator(device=DEVICE).manual_seed(230)
        x, sc, g = norm_case(gen, LIB_TOKENS, d, dtype, dtype)
        xq, scq, _ = norm_case(gen, (*LIB_TOKENS, nq), h, dtype, dtype)
        q, k = (seeded(gen, (b * s, n, h), dtype) for n in (nq, nk))
        pos = torch.arange(s, device=DEVICE, dtype=torch.int32).repeat(b)
        pq, pk, pv, tables, lengths = make_case(MAIN_SHAPE, dtype, seed=100,
                                                full_row=True)
        bb, np_, page = MAIN_SHAPE[:3]
        gath = [c[tables.long()] for c in (pk, pv)]   # [B, NP, NK, page, H]
        tok = [c.permute(0, 1, 3, 2, 4).reshape(bb, np_ * page, nk, h)
               .contiguous() for c in gath]
        hm = [c.permute(0, 2, 1, 3, 4).reshape(bb, nk, np_ * page, h)
              .contiguous() for c in gath]
        del gath

        # the path, counted: every call launches its kernel
        ops.reset_launch_counts()
        y, dx, ds = norm_grads(x, sc, g, eps, "auto")
        yq = ops.rmsnorm(xq, scq, eps=eps)
        rq = ops.rotary(q, pos, theta=theta)
        rk = ops.rotary(k, pos, theta=theta)
        o_tm = ops.decode_attention(pq, tok[0], tok[1], lengths)
        o_hm = ops.decode_attention(pq, hm[0], hm[1], lengths,
                                    head_major=True)
        torch.cuda.synchronize()
        run = ops.launch_counts()
        want = {"rmsnorm": 2, "rmsnorm_bwd": 1, "rotary": 2,
                "decode_attention": 2}
        check(run == {k_: want.get(k_, 0) for k_ in run},
              f"phase 9 path launches {run}, expected {want}")
        if dtype == torch.bfloat16:
            counts = run

        # the plain versions, asked for by impl="ref": no kernel launches
        ops.reset_launch_counts()
        wy = ops.rmsnorm(x, sc, eps=eps, impl="ref")
        wyq = ops.rmsnorm(xq, scq, eps=eps, impl="ref")
        wrq = ops.rotary(q, pos, theta=theta, impl="ref")
        wrk = ops.rotary(k, pos, theta=theta, impl="ref")
        w_tm = ops.decode_attention(pq, tok[0], tok[1], lengths, impl="ref")
        xl, sl = x.clone().requires_grad_(), sc.clone().requires_grad_()
        rmsnorm_plain(xl, sl, eps).backward(g)
        torch.cuda.synchronize()
        check(not any(ops.launch_counts().values()),
              f"impl='ref' launched kernels: {ops.launch_counts()}")

        res = {"rmsnorm": within(y, wy, TOL[dtype]),
               "rmsnorm q-norm": within(yq, wyq, TOL[dtype]),
               "rmsnorm_bwd dx": within(dx, xl.grad, TOL[dtype]),
               "rmsnorm_bwd ds": within(ds, sl.grad, TOL[dtype]),
               "rotary q": within(rq, wrq, TOL[dtype]),
               "rotary k": within(rk, wrk, TOL[dtype])}
        if dtype == torch.float32:
            xhat = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
            mass = (g * xhat).abs().reshape(-1, d).sum(0)
            diff = (ds - sl.grad).abs()
            res["rmsnorm_bwd ds"] = (bool((diff <= 2e-5 * sl.grad.abs()
                                           + DS_ULPS_F32 * mass).all()),
                                     float(diff.max()))
            del xhat, mass
        ok_d = close_to_plain(o_tm, w_tm, (pq, pk, pv, tables, lengths))
        res["decode_attention"] = (ok_d, max_err(o_tm, w_tm))
        del xl, sl
        b1 = paged_decode_attention(pq, pk, pv, tables, lengths)
        res["decode vs B1"] = (close_to_plain(o_tm, b1, (pq, pk, pv, tables,
                                                          lengths)),
                               max_err(o_tm, b1))
        ds2 = rmsnorm_bwd(x, sc, g, eps=eps)[1]
        ds3 = rmsnorm_bwd(x, sc, g, eps=eps)[1]
        torch.cuda.synchronize()
        for name, (ok, err) in res.items():
            check(ok, f"{name} full width {dn}: max_abs_err {err:.3e}")
        check(torch.equal(ds2, ds3) and torch.equal(ds, ds2),
              f"B9-bwd ds differs between launches ({dn})")
        check(torch.equal(o_tm, o_hm),
              f"B11 token-major and head-major differ at full width ({dn})")
        print(f"[9] full width {dn} (d_model {d}, x {tuple(x.shape)}, q-norm "
              f"{tuple(xq.shape)}, q {tuple(q.shape)}, k {tuple(k.shape)}, "
              f"theta {theta:g}, eps {eps:g}; B11 on phase 3's data as dense "
              f"caches {tuple(tok[0].shape)} / {tuple(hm[0].shape)}): "
              f"max_abs_err { {n: f'{e:.2e}' for n, (_, e) in res.items()} }; "
              f"ds bit-equal over three launches, B11 layouts bit-equal, "
              f"B11 {'bit-equal to' if torch.equal(o_tm, b1) else 'within '
                     'the rule of'} B1")

        # B10 far out: positions up to 32,767, f32, the stated bound
        if dtype == torch.float32:
            gen = torch.Generator(device=DEVICE).manual_seed(231)
            xf = seeded(gen, (b * s, nq, h), torch.float32)
            far = torch.randint(0, 32768, (b * s,), generator=gen,
                                device=DEVICE, dtype=torch.int32)
            far[:2] = torch.tensor([32767, 0], device=DEVICE)
            got = rotary(xf, far, theta=theta)
            want_f = rotary_plain(xf, far, theta)
            diff = (got - want_f).abs()
            check(bool((diff <= rope_far_bound(xf, far, theta)).all()),
                  f"B10 at positions to 32,767: max_abs_err "
                  f"{float(diff.max()):.3e} beyond the one-ulp bound")
            print(f"[9] B10 f32 at positions 0..32,767 against its plain "
                  f"version: max_abs_err {float(diff.max()):.3e} (bound "
                  f"per element: one ulp of a frequency, at most "
                  f"{float(rope_far_bound(xf, far, theta).max()):.3e})")
            continue

        # timing, bf16, CUDA-graph replay, inputs rotated past the L2
        xs = [x] + [x.clone() for _ in range(LIB_ROTATE["rmsnorm"] - 1)]
        ms = graph_ms(lambda i: ops.rmsnorm(xs[i % len(xs)], sc, eps=eps),
                      len(xs))
        plain_ms = time_ms(lambda i: rmsnorm_plain(xs[i % len(xs)], sc, eps),
                           len(xs))
        # every yardstick runs once eagerly, against the plain version,
        # before a graph captures it (cuDNN allocates on its first call)
        check(within(F.rms_norm(x, (d,), sc, eps), wy, TOL[dtype])[0],
              "F.rms_norm disagrees with the plain version")
        lib_ms = graph_ms(lambda i: F.rms_norm(xs[i % len(xs)], (d,), sc,
                                               eps), len(xs))
        rows["rmsnorm"] = lib_row(ms, plain_ms, lib_ms, nbytes(x, y, sc), 0,
                                  dtype, res["rmsnorm"][1])
        del xs
        sets = [(x, g)] + [(x.clone(), g.clone())
                           for _ in range(LIB_ROTATE["rmsnorm_bwd"] - 1)]
        n_sets = len(sets)
        ms = graph_ms(lambda i: rmsnorm_bwd(sets[i % n_sets][0], sc,
                                            sets[i % n_sets][1], eps=eps),
                      n_sets)
        plain_ms = time_ms(lambda i: rmsnorm_bwd_plain(
            sets[i % n_sets][0], sc, sets[i % n_sets][1], eps), n_sets)
        # F.rms_norm's autograd backward (FusedRmsNormBackward0) is this
        # one op; called directly it replays in a graph (autograd does not)
        _, rstd = torch.ops.aten._fused_rms_norm(x, [d], sc, eps)
        lib_dx, lib_ds = torch.ops.aten._fused_rms_norm_backward(
            g, x, [d], rstd, sc, [True, True])
        check(within(lib_dx, dx, TOL[dtype])[0]
              and within(lib_ds, ds, TOL[dtype])[0],
              "_fused_rms_norm_backward disagrees with B9-bwd")
        lib_ms = graph_ms(lambda i: torch.ops.aten._fused_rms_norm_backward(
            sets[i % n_sets][1], sets[i % n_sets][0], [d], rstd, sc,
            [True, True]), n_sets)
        rows["rmsnorm_bwd"] = lib_row(ms, plain_ms, lib_ms,
                                      nbytes(x, g, sc, dx, ds), 0, dtype,
                                      max(res["rmsnorm_bwd dx"][1],
                                          res["rmsnorm_bwd ds"][1]))
        del sets, rstd
        for name, t in (("rotary", q), ("rotary k", k)):
            ts = [t] + [t.clone() for _ in range(LIB_ROTATE["rotary"] - 1)]
            ms = graph_ms(lambda i: rotary(ts[i % len(ts)], pos, theta=theta),
                          len(ts))
            plain_ms = time_ms(lambda i: rotary_plain(ts[i % len(ts)], pos,
                                                      theta), len(ts))
            rows[name] = lib_row(ms, plain_ms, None, 2 * nbytes(t) +
                                 nbytes(pos), 0, dtype,
                                 res["rotary q" if t is q else "rotary k"][1])
            del ts
        # B11: rotate whole caches; time both layouts
        n_rot = LIB_ROTATE["decode_attention"]
        tms = [tok] + [[c.clone() for c in tok] for _ in range(n_rot - 1)]
        hms = [hm] + [[c.clone() for c in hm] for _ in range(n_rot - 1)]
        ms = graph_ms(lambda i: ops.decode_attention(
            pq, *tms[i % n_rot], lengths), n_rot)
        ms_hm = graph_ms(lambda i: ops.decode_attention(
            pq, *hms[i % n_rot], lengths, head_major=True), n_rot)
        plain_ms = time_ms(lambda i: decode_attention_plain(
            pq, *tms[i % n_rot], lengths), n_rot)
        mask = (torch.arange(np_ * page, device=DEVICE)[None, :]
                < lengths[:, None])[:, None, None, :]

        def sdpa(i):
            return F.scaled_dot_product_attention(
                pq[:, :, None, :], *hms[i % n_rot], attn_mask=mask,
                enable_gqa=True)
        check(within(sdpa(0)[:, :, 0], w_tm, TOL[dtype])[0],
              "scaled_dot_product_attention disagrees with the plain version")
        lib_ms = graph_ms(sdpa, n_rot)
        live = int(lengths.sum())
        elt = pq.element_size()
        rows["decode_attention"] = lib_row(
            ms, plain_ms, lib_ms, 2 * live * nk * h * elt + nbytes(pq, o_tm)
            + nbytes(lengths), 4 * live * nq * h, dtype,
            res["decode_attention"][1])
        rows["decode_attention"]["ms_head_major"] = ms_hm
        del tms, hms
    for name, r in rows.items():
        lib = ("none (no one PyTorch call computes it)"
               if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
        extra = (f", head-major {r['ms_head_major']:.4f} ms"
                 if "ms_head_major" in r else "")
        print(f"[9]   {name} bf16: {r['ms']:.4f} ms on the card (CUDA-graph "
              f"replay, {LIB_ROTATE.get(name.split()[0], 1)} rotated input "
              f"sets{extra}), plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['n_bytes']} bytes; bound / kernel = "
              f"{r['bound_ms'] / r['ms']:.1%}), launches in the path run "
              f"{counts[name.split()[0]]}, on {card}")
    return rows, counts


def library_wide_rows(card: str) -> None:
    """B9 on rows too wide for the backward's registers: d_model 16,384
    (the widest dense decoders), 2,048 rows, bf16.  The forward stays on
    its register path, the backward takes the wide kernel (each row read
    twice).  Held against the plain versions, then timed beside the bound
    and the library calls; not an entry of the kernels line."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain

    d, n_rows, dtype, eps = 16384, 2048, torch.bfloat16, 1e-5
    gen = torch.Generator(device=DEVICE).manual_seed(232)
    # two input sets of 67 MB each: every call finds its inputs out of L2
    sets = [norm_case(gen, (n_rows,), d, dtype, dtype) for _ in range(2)]
    x, sc, g = sets[0]
    y = ops.rmsnorm(x, sc, eps=eps, impl="cuda")
    dx, ds = rmsnorm_bwd(x, sc, g, eps=eps)
    wdx, wds = rmsnorm_bwd_plain(x, sc, g, eps)
    for what, got, want in (("y", y, ops.rmsnorm(x, sc, eps=eps, impl="ref")),
                            ("dx", dx, wdx), ("ds", ds, wds)):
        ok, err = within(got, want, TOL[dtype])
        check(ok, f"B9 {what} at ({n_rows}, {d}) bf16: max_abs_err {err:.3e}")
    rstd = [torch.ops.aten._fused_rms_norm(xs, [d], ss, eps)[1]
            for xs, ss, _ in sets]
    lib_dx = torch.ops.aten._fused_rms_norm_backward(
        g, x, [d], rstd[0], sc, [True, True])[0]
    check(within(F.rms_norm(x, (d,), sc, eps), y, TOL[dtype])[0]
          and within(lib_dx, dx, TOL[dtype])[0],
          "F.rms_norm or its fused backward disagrees with B9 at d 16,384")
    fwd = graph_ms(lambda i: ops.rmsnorm(sets[i % 2][0], sets[i % 2][1],
                                         eps=eps), 2)
    bwd = graph_ms(lambda i: rmsnorm_bwd(*sets[i % 2], eps=eps), 2)
    lib_fwd = graph_ms(lambda i: F.rms_norm(sets[i % 2][0], (d,),
                                            sets[i % 2][1], eps), 2)
    lib_bwd = graph_ms(lambda i: torch.ops.aten._fused_rms_norm_backward(
        sets[i % 2][2], sets[i % 2][0], [d], rstd[i % 2], sets[i % 2][1],
        [True, True]), 2)
    b_fwd = nbytes(x, y, sc) / HBM_BYTES_PER_S * 1e3
    b_bwd = nbytes(x, g, dx, sc, ds) / HBM_BYTES_PER_S * 1e3
    print(f"[9] B9 at d_model 16,384 ({n_rows} rows, bf16; the backward on "
          f"the wide kernel): forward {fwd:.4f} ms (bound {b_fwd:.4f}, "
          f"{b_fwd / fwd:.1%}; F.rms_norm {lib_fwd:.4f}), backward "
          f"{bwd:.4f} ms (bound {b_bwd:.4f}, {b_bwd / bwd:.1%}; fused "
          f"library backward {lib_bwd:.4f}), on {card}")


def refused_inputs() -> None:
    """Queue C2: inputs the reference takes and a port kernel refuses, as
    the ``ops`` docstrings state them.  Each wrapper raises a clear error
    on the card before anything launches.  B5 / B7 take bf16 and f16 at
    head dim 96 since C2's lift: held against their plain versions."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def expect(what, exc, match, fn):
        try:
            fn()
        except exc as e:
            check(match in str(e), f"{what}: {type(e).__name__} {e!s} "
                  f"does not name {match!r}")
            print(f"[9] C2: {what} refused: {type(e).__name__}: {e}")
            return
        check(False, f"{what} was not refused")

    def qkv(b, s, nq, nk, h, dtype):
        return (seeded(gen, (b, s, nq, h), dtype),
                seeded(gen, (b, s, nk, h), dtype),
                seeded(gen, (b, s, nk, h), dtype))

    for dt in (torch.bfloat16, torch.float16):
        q, k, v = qkv(1, 64, 2, 2, 96, dt)
        do = seeded(gen, q.shape, dt)
        ops.reset_launch_counts()
        o, lse = ops.flash_attention(q, k, v, return_lse=True, impl="cuda")
        grads = flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        paths = check_paths(dt, f"{dt} head dim 96")
        wo = flash_attention_plain(q, k, v)
        wgrads = flash_attention_bwd_plain(q, k, v, o, lse, do)
        errs = [within(o, wo, FLASH_TOL[dt])] + [
            within(a, w, GRAD_TOL[dt]) for a, w in zip(grads, wgrads)]
        print(f"[9] C2 lifted: B5 / B7 {str(dt)[6:]} head_dim 96 against "
              f"the plain versions: max_abs_err out, dq, dk, dv "
              f"{[f'{e:.2e}' for _, e in errs]}; launches by path {paths}")
        check(all(ok for ok, _ in errs), f"B5 / B7 {dt} head_dim 96")

    ops.reset_launch_counts()
    expect("B5 bf16 head_dim 12", ValueError, "head_dim 12",
           lambda: ops.flash_attention(*qkv(1, 64, 2, 2, 12,
                                            torch.bfloat16)))
    expect("B5 f16 head_dim 264", ValueError, "head_dim 264",
           lambda: ops.flash_attention(*qkv(1, 64, 2, 2, 264,
                                            torch.float16)))
    expect("B5 f32 head_dim 96", ValueError, "head_dim 96",
           lambda: ops.flash_attention(*qkv(1, 64, 2, 2, 96, torch.float32)))
    expect("B5 G = 128", ValueError, "G=128",
           lambda: ops.flash_attention(*qkv(1, 16, 128, 1, 32,
                                            torch.bfloat16)))
    q, k, v = qkv(1, 64, 2, 2, 128, torch.float32)
    lse = torch.zeros((1, 64, 2), device=DEVICE)
    expect("B7 f32 head_dim 128", ValueError, "head_dim <= 64",
           lambda: flash_attention_bwd(q, k, v, q, lse, q))
    pq, pk, pv, tables, lengths = make_case((2, 2, 16, 4, 2, 40),
                                            torch.bfloat16, seed=18)
    expect("B1 bf16 head_dim 40", ValueError, "head_dim 40",
           lambda: ops.paged_decode_attention(pq, pk, pv, tables, lengths))
    dq = seeded(gen, (2, 4, 24), torch.float32)
    dk, dv = (seeded(gen, (2, 32, 2, 24), torch.float32) for _ in range(2))
    expect("B11 f32 head_dim 24", ValueError, "head_dim 24",
           lambda: ops.decode_attention(dq, dk, dv, lengths))
    torch.cuda.synchronize()
    check(not any(ops.launch_counts().values()),
          f"a refused input launched: {ops.launch_counts()}")


def phase_library(card: str) -> dict:
    """Phase 9: the kernel library's B9 (forward, backward), B10 and B11
    at the CPU tests' shapes and at full width, and the inputs B1, B5, B7
    and B11 refuse.  Returns the kernels line's four rows."""
    t0 = time.perf_counter()
    refused_inputs()
    library_small_shapes()
    rows, counts = library_full_width(card)
    library_wide_rows(card)
    print(f"[9] path launches (bf16 run): "
          f"{ {k: n for k, n in counts.items() if n} }")
    print(f"[9] kernel library in {time.perf_counter() - t0:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {name: dict(launches=counts[name],
                       **{k: rows[name][k] for k in keys})
            for name in ("rmsnorm", "rmsnorm_bwd", "rotary",
                         "decode_attention")}


# --- phase 10: the kernel library's ssd_scan (B12) and wkv6 (B13) ---------

#: the CPU tests' shapes (tests/test_torch_scan_kernels.py) plus S that is
#: a multiple of no chunk (999) and odd P, N / K, V: B12 (B, S, H, P, N),
#: B13 (B, S, H, K, V)
SSD_SMALL = [(2, 64, 2, 16, 8), (1, 100, 3, 8, 16), (1, 999, 4, 64, 64),
             (1, 77, 2, 40, 24)]
WKV_SMALL = [(2, 48, 2, 16, 16), (1, 70, 1, 32, 32), (1, 999, 3, 64, 64),
             (1, 45, 2, 24, 40)]
#: full width, B = 2, S = 2,048: B12 at zamba2-1.2b's (H = 2 * 2048 / 64,
#: P = N = 64), B13 at rwkv6-1.6b's (H = 32, K = V = 64)
SSD_FULL = (2, 2048, 64, 64, 64)
WKV_FULL = (2, 2048, 32, 64, 64)
#: B12 / B13 against their plain versions.  Both sum in f32, in another
#: order (the plain version's einsum against the kernel's FMA loops), so
#: the difference is a few units of 2^-24 of the terms a sum adds, which
#: are at most the output's largest magnitude: 2e-5 of that.  A bf16
#: output may besides round to the other neighbour: one bf16 ulp, at most
#: 2^-7 of the value
SCAN_F32_SLACK = 2e-5


def scan_close(got, want) -> tuple[bool, float]:
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bound = SCAN_F32_SLACK * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * w.abs()
    ok = bool(torch.isfinite(g).all()) and bool((diff <= bound).all())
    return ok, float(diff.max())


def ssd_case(shape, dtype, seed):
    """x in ``dtype``, the rest f32: dt = softplus(normal), a = -exp
    (normal) per head, logd = dt * a, unit-normal B and C."""
    b, s, h, p, n = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = seeded(gen, (b, s, h, p), dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
    a = -torch.exp(torch.randn((h,), generator=gen, device=DEVICE))
    bm, cm = (torch.randn((b, s, n), generator=gen, device=DEVICE)
              for _ in range(2))
    return x, dt * a, dt, bm, cm


def wkv_case(shape, dtype, seed, lo=0.45, hi=0.95):
    """r, k, v in ``dtype``; w uniform in [lo, hi] and u f32."""
    b, s, h, k, v = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    r, kk = (seeded(gen, (b, s, h, k), dtype) for _ in range(2))
    vv = seeded(gen, (b, s, h, v), dtype)
    w = lo + (hi - lo) * torch.rand((b, s, h, k), generator=gen,
                                    device=DEVICE)
    u = 0.1 * torch.randn((h, k), generator=gen, device=DEVICE)
    return r, kk, vv, w, u


def ssd_flops(shape, chunk: int) -> int:
    """f32 operations of the chunked SSD scan with C B^T formed once per
    batch row and chunk (B and C are shared by the heads): per chunk of q
    rows, q(q+1)/2 (C.B) dot products of N; per head q(q+1)/2 P (scores
    times dt x), q N P (C against the state), N P q (the state update)
    multiply-adds."""
    b, s, h, p, n = shape
    total = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        tri = q * (q + 1) // 2
        total += 2 * b * tri * n + 2 * b * h * (tri * p + 2 * q * n * p)
    return total


def wkv_flops(shape, chunk: int) -> int:
    """f32 operations of the chunked WKV6 form: per chunk of q rows and
    head, the q(q-1)/2 pair scores over K (three operations a channel:
    r k, times the decay, added) and the diagonal, the scores times v,
    r against the state and the state update (multiply-adds)."""
    b, s, h, k, v = shape
    total = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        total += b * h * (3 * q * (q - 1) // 2 * k + 3 * q * k
                          + q * (q + 1) * v + 4 * q * k * v)
    return total


def scan_small_shapes() -> dict:
    """B12 and B13 against their plain versions at the CPU tests' shapes
    (and S a multiple of no chunk), f32 and bf16, and B13 at strong
    decay.  Returns the worst max_abs_err by name."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain

    worst: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for i, shape in enumerate(SSD_SMALL):
            args = ssd_case(shape, dtype, 300 + i)
            ok, err = scan_close(ops.ssd_scan(*args, impl="cuda"),
                                 ssd_scan_plain(*args)[0])
            worst[f"{dn} ssd_scan"] = max(worst.get(f"{dn} ssd_scan", 0), err)
            check(ok, f"B12 at {shape} {dn}: max_abs_err {err:.3e}")
        for i, shape in enumerate(WKV_SMALL):
            args = wkv_case(shape, dtype, 310 + i)
            ok, err = scan_close(ops.wkv6(*args, impl="cuda"),
                                 wkv6_plain(*args)[0])
            worst[f"{dn} wkv6"] = max(worst.get(f"{dn} wkv6", 0), err)
            check(ok, f"B13 at {shape} {dn}: max_abs_err {err:.3e}")
        # strong decay: w in [0.05, 0.2], a chunk of 32 sums log-decays to
        # about -96 at worst, past f32's exp range for the reference's form
        args = wkv_case((2, 256, 4, 64, 64), dtype, 320, lo=0.05, hi=0.2)
        got = ops.wkv6(*args, impl="cuda")
        ok, err = scan_close(got, wkv6_plain(*args)[0])
        worst[f"{dn} wkv6 strong decay"] = err
        check(ok and bool(torch.isfinite(got).all()),
              f"B13 at strong decay {dn}: max_abs_err {err:.3e}")
    torch.cuda.synchronize()
    print(f"[10] B12 / B13 at the CPU tests' shapes, S = 999 and odd widths, "
          f"and B13 at w in [0.05, 0.2] (finite), f32 and bf16, against "
          f"the plain versions: worst max_abs_err "
          f"{ {k: f'{e:.2e}' for k, e in worst.items()} }")
    return worst


def phase_scan(card: str) -> dict:
    """Phase 10: the kernel library's B12 and B13 through ``ops`` at the
    CPU tests' shapes and at full width (zamba2's and rwkv6's), one
    counted run of the library path, each timed beside its bound and its
    plain version.  Returns the kernels line's two rows."""
    from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.wkv6 import CHUNK as WKV_CHUNK
    from repro_torch.kernels.wkv6 import wkv6_plain

    t0 = time.perf_counter()
    scan_small_shapes()
    rows, counts = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        s_args = ssd_case(SSD_FULL, dtype, 330)
        w_args = wkv_case(WKV_FULL, dtype, 331)
        # the path, counted: every call launches its kernel
        ops.reset_launch_counts()
        y_s = ops.ssd_scan(*s_args)
        y_w = ops.wkv6(*w_args)
        torch.cuda.synchronize()
        run = ops.launch_counts()
        want = {"ssd_scan": 1, "wkv6": 1}
        check(run == {k_: want.get(k_, 0) for k_ in run},
              f"phase 10 path launches {run}, expected {want}")
        if dtype == torch.bfloat16:
            counts = run
        ops.reset_launch_counts()
        p_s = ops.ssd_scan(*s_args, impl="ref")
        p_w = ops.wkv6(*w_args, impl="ref")
        torch.cuda.synchronize()
        check(not any(ops.launch_counts().values()),
              f"impl='ref' launched kernels: {ops.launch_counts()}")
        res = {"ssd_scan": scan_close(y_s, p_s), "wkv6": scan_close(y_w, p_w)}
        for name, (ok, err) in res.items():
            check(ok, f"{name} full width {dn}: max_abs_err {err:.3e}")
        print(f"[10] full width {dn}: B12 x {tuple(s_args[0].shape)} "
              f"(N {SSD_FULL[4]}), B13 r {tuple(w_args[0].shape)}: "
              f"max_abs_err { {n: f'{e:.2e}' for n, (_, e) in res.items()} } "
              f"(max-abs {float(p_s.float().abs().max()):.1f} / "
              f"{float(p_w.float().abs().max()):.1f})")
        if dtype != torch.bfloat16:
            continue
        # timing, bf16: two input sets (71 / 101 MB each, past the L2)
        for name, args, fn, plain, out, flops in (
                ("ssd_scan", s_args, ops.ssd_scan, ssd_scan_plain, y_s,
                 ssd_flops(SSD_FULL, SSD_CHUNK)),
                ("wkv6", w_args, ops.wkv6, wkv6_plain, y_w,
                 wkv_flops(WKV_FULL, WKV_CHUNK))):
            sets = [args, tuple(t.clone() for t in args)]
            ms = graph_ms(lambda i: fn(*sets[i % 2]), 2)
            plain_ms = time_ms(lambda i: plain(*sets[i % 2]), 2, warmup=1)
            rows[name] = lib_row(ms, plain_ms, None, nbytes(*args, out),
                                 flops, torch.float32, res[name][1])
            del sets
    for name, r in rows.items():
        print(f"[10]   {name} bf16: {r['ms']:.4f} ms on the card (CUDA-graph "
              f"replay, 2 rotated input sets), plain {r['plain_ms']:.4f} ms, "
              f"library none (no one PyTorch call computes it), bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['n_bytes']} "
              f"bytes; bound / kernel = {r['bound_ms'] / r['ms']:.1%}), "
              f"launches in the path run {counts[name]}, on {card}")
    print(f"[10] ssd_scan and wkv6 in {time.perf_counter() - t0:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {name: dict(launches=counts[name],
                       **{k: rows[name][k] for k in keys})
            for name in ("ssd_scan", "wkv6")}


# --- phase 11: zamba2-1.2b and rwkv6-1.6b served at full width -------------

ZOO_ARCHS = ("zamba2-1.2b", "rwkv6-1.6b")
#: the engine's logits (prefill, then each decode step) against one
#: full-sequence forward of the same tokens, bf16, full depth.  The two
#: paths run the same weights through different kernels (a recurrent step
#: against the chunked scan, paged decode against blockwise attention,
#: [8, d] products against [S, d] ones), so each layer's bf16 rounding of
#: its output may flip, and the flips add up over the depth.  Both are
#: held to the same forward in f32 (the bf16 weights upcast): the
#: engine's mean and max distance from it may be at most ZOO_BF16_SPREAD
#: times the bf16 forward's own (two bf16 computations of one function,
#: each its rounding away from the f32 one).  A state dropped or carried
#: wrong moves the logits by their own magnitude, far past that
ZOO_BF16_SPREAD = 2.0
#: the same in f32 at a cut depth: only the order of f32 sums differs
ZOO_F32_TOL = 1e-3
#: the f32 depths (two zamba2 periods: two tied shared-attention layers)
ZOO_F32_LAYERS = {"zamba2-1.2b": 12, "rwkv6-1.6b": 4}


def capture_logits(engine):
    """Wrap the engine's model so that every prefill and every decode
    step's logits are kept, with the slot -> request map of the step.
    Returns the two lists and ``restore()``, which unwraps the model."""
    prefills, steps = [], []
    model = engine.model

    def prefill(*a, **kw):
        logits, cache = model.prefill(*a, **kw)
        prefills.append(logits[0].float().clone())
        return logits, cache

    def decode(*a, **kw):
        logits, cache = model.decode_step_paged(*a, **kw)
        steps.append((logits.float().clone(), engine._slot_rid.copy(),
                      engine._state["active"].clone()))
        return logits, cache

    def restore():
        engine.model = model     # drops the cycle engine -> capture -> engine

    engine.model = model._replace(prefill=prefill, decode_step_paged=decode)
    return prefills, steps, restore


def forward_logits(model, params, seq, start: int) -> torch.Tensor:
    """f32 logits of one full-sequence forward from position ``start``."""
    with torch.no_grad():
        h, _, _ = model.forward(params, {"tokens": seq[None]})
        return lm_head_apply(params["embed"], h[0, start:],
                             model.cfg.vocab_size).float()


def engine_vs_forward(cfg, params, lens, new_tokens, seed, label: str
                      ) -> None:
    """Serve ``lens`` prompts, then hold each request's prefill and decode
    logits against a full-sequence forward of its prompt and emitted
    tokens on the card: in f32 within ZOO_F32_TOL; in bf16 no farther
    from the f32 forward than ZOO_BF16_SPREAD times the bf16 forward."""
    engine = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                    page_size=64)
    prefills, steps, restore = capture_logits(engine)
    reqs = make_requests(cfg, lens, new_tokens, seed)
    done = engine.generate(reqs)
    restore()
    bf16 = engine.model.dtype == torch.bfloat16
    if bf16:
        f32_model = build_model(dataclasses.replace(cfg, dtype="float32"),
                                device="cuda")
        f32_params = cast_params(engine.params, torch.float32)
    stats, failed = {}, []
    for i, r in enumerate(reqs):
        toks = done[r.rid].tokens
        check(len(toks) == new_tokens, f"{label} request {r.rid} short")
        got = [prefills[i]] + [lg[list(rid).index(r.rid)]
                               for lg, rid, act in steps
                               if r.rid in rid and
                               bool(act[list(rid).index(r.rid)])]
        got = torch.stack(got[:new_tokens])
        seq = np.concatenate([r.prompt, np.asarray(toks[:-1], np.int32)])
        start = len(r.prompt) - 1
        fwd = forward_logits(engine.model, engine.params, seq, start)
        direct = float((got - fwd).abs().max())
        same = float((got.argmax(-1) == fwd.argmax(-1)).float().mean())
        if bf16:
            ref = forward_logits(f32_model, f32_params, seq, start)
            e_eng, e_fwd = (got - ref).abs(), (fwd - ref).abs()
            row = dict(engine_mean=float(e_eng.mean()),
                       engine_max=float(e_eng.max()),
                       fwd_mean=float(e_fwd.mean()),
                       fwd_max=float(e_fwd.max()))
            ok = (row["engine_mean"] <= ZOO_BF16_SPREAD * row["fwd_mean"]
                  and row["engine_max"] <= ZOO_BF16_SPREAD * row["fwd_max"])
        else:
            row, ok = {}, direct <= ZOO_F32_TOL
        stats[r.rid] = {**{k: f"{v:.4g}" for k, v in row.items()},
                        "engine_vs_fwd_max": f"{direct:.4g}",
                        "same_argmax": f"{same:.3f}",
                        "mean_abs_logit": f"{float(fwd.abs().mean()):.3f}"}
        if not ok:
            failed.append(r.rid)
    rule = (f"distance from the f32 forward at most {ZOO_BF16_SPREAD}x the "
            "bf16 forward's" if bf16 else f"within {ZOO_F32_TOL}")
    print(f"[11] {label}: engine prefill + decode logits vs one "
          f"full-sequence forward of the same tokens ({rule}), per request "
          f"(prompt lengths {list(lens)}, {new_tokens} positions each): "
          f"{stats}")
    check(not failed, f"{label}: engine logits vs the full-sequence "
          f"forward outside the rule for requests {failed}")
    del engine


def phase_zoo(card: str) -> None:
    """Phase 11: zamba2-1.2b and rwkv6-1.6b at full width and depth,
    random bf16 weights from seed 0, served through the paged Engine as
    phase 4 serves qwen3; a decode step profiled mid-flight; the engine's
    logits against full-sequence forwards (bf16 at full depth, f32 at a
    cut depth)."""
    t0 = time.perf_counter()
    for arch in ZOO_ARCHS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gib = 2.0 ** 30
        before = torch.cuda.memory_allocated() / gib
        model = build_model(cfg, device="cuda")
        params = cast_params(model.init(0), model.dtype)
        n_params = sum({id(t): t.numel() for t in _leaves(params)}.values())
        kinds = layer_kinds(cfg)
        print(f"[11] {arch} full width: {cfg.num_layers} layers "
              f"({ {k: kinds.count(k) for k in dict.fromkeys(kinds)} }), "
              f"d_model {cfg.d_model}, {n_params / 1e9:.2f} B parameters "
              f"in {model.dtype} (tied ones once); device memory "
              f"{before:.2f} GiB before, {torch.cuda.memory_allocated() / gib:.2f} "
              f"GiB with the bf16 weights, peak {torch.cuda.max_memory_allocated() / gib:.2f} "
              f"GiB while the f32 masters were cast")
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                        page_size=64)
        lens = np.random.default_rng(0).integers(16, 701, size=12)
        lens[0], lens[1] = 16, 700
        launches = serve(engine, make_requests(cfg, lens, 64, seed=1),
                         f"{arch} whole-prompt prefill", tag="[11]")
        n_attn = attention_layers(cfg)
        print(f"[11] {arch}: B1 launched {launches} times, "
              f"{n_attn} a decode step (its attention layers)")
        phase_full_width_check(engine, tag="[11]")
        print(f"[11] {arch} serving peak device memory "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (weights, "
              f"caches, prefill of 700 tokens, 8-slot decode)")
        del engine
        engine_vs_forward(cfg, params, [100, 333, 700], 64, 5,
                          f"{arch} bf16")
        del params, model
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, num_layers=ZOO_F32_LAYERS[arch],
                                  dtype="float32")
        cmodel = build_model(cut, device="cuda")
        engine_vs_forward(cut, cmodel.init(0), [40, 257], 16, 6,
                          f"{arch} f32 at {cut.num_layers} layers")
        del cmodel
    print(f"[11] zamba2 and rwkv6 served in {time.perf_counter() - t0:.1f} s")


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
    if "--decode-segments" in sys.argv:
        phase_decode_segments(card)
        return 0
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
    torch.cuda.empty_cache()
    b5, b7 = phase_flash(card)
    torch.cuda.empty_cache()
    lib = phase_library(card)
    torch.cuda.empty_cache()
    scan = phase_scan(card)
    torch.cuda.empty_cache()
    phase_zoo(card)
    print(f"[12] total {time.perf_counter() - t0:.1f} s")
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
        "source": "src/repro_torch/kernels/csrc/fused_matmul_stream.cuh",
        "replaces": "src/repro/kernels/fused_matmul.py:240",
        "launches": counts["fused_matmul_segment"],
        **kernel_entry(timed, "matmul")}, {
        "name": "fused_matmul_segment (training forward)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul_sm90.cuh",
        "replaces": "src/repro/kernels/fused_matmul.py:240",
        "launches": train_counts["fused_matmul_segment"],
        **kernel_entry(train_rows, "fwd")}, {
        "name": "fused_matmul_dlhs_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul_sm90.cuh",
        "replaces": "src/repro/kernels/fused_matmul_bwd.py:178",
        "launches": train_counts["fused_matmul_dlhs_segment"],
        **kernel_entry(train_rows, "dlhs")}, {
        "name": "fused_matmul_drhs_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_matmul_sm90.cuh",
        "replaces": "src/repro/kernels/fused_matmul_bwd.py:343",
        "launches": train_counts["fused_matmul_drhs_segment"],
        **kernel_entry(train_rows, "drhs")}, {
        "name": "adamw_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw_update.cu",
        "replaces": "src/repro/kernels/adamw_update.py:55",
        **b8}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cuh",
        "replaces": "src/repro/kernels/flash_attention.py:145",
        **b5}, {
        "name": "flash_attention_bwd_dkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cuh",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:196",
        **b7["dkv"]}, {
        "name": "flash_attention_bwd_dq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cuh",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:218",
        **b7["dq"]}, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:52",
        **lib["rmsnorm"]}, {
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:76",
        **lib["rmsnorm_bwd"]}, {
        "name": "rotary", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rotary.cu",
        "replaces": "src/repro/kernels/rotary.py:42",
        **lib["rotary"]}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:118",
        **lib["decode_attention"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:91",
        **scan["ssd_scan"]}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:83",
        **scan["wkv6"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
