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
   instantiation whose registers spill (none of B5's, B7's, B8's, B9's,
   B12's or B13's may; those of B9, B12 and B13 printed one by one);
3. ``paged_decode_attention`` vs its plain version on the card: small
   shapes in f32 (2e-5) and bf16 (2e-2, and within one bf16 rounding of
   the plain version run in f32) with permuted tables, ragged lengths
   and an empty row, with and without split-KV; every head
   tile, strided pools and the widest rows; stale-table-tail invariance
   (bit-equal); and the main-path shape, timed (CUDA-graph replay)
   beside the plain version, a ``scaled_dot_product_attention``
   yardstick and the card's bound;
4. the engine at full width: 12 greedy requests through
   ``capture_decode=False`` (first: the process's first model run; every
   static function eager), then twice through the engine whose decode
   step, admits (one graph a pow2 prompt bucket), chunk and slot controls
   are CUDA graphs (the same tokens), then a shorter pass with chunked
   prefill, captured and eager (the same tokens); every request
   completes, no page leaks, and the kernel's launch count equals decode
   steps x layers (counted from the graph's replays: ``step_traces == 1``
   after the mix; the warm step and capture's host time and the graph
   pool's memory printed); ``admit_traces`` equals the mix's distinct
   buckets after the first pass and stays there on the second,
   ``chunk_traces == 1``, ``control_traces`` printed, with the shared
   pool's reserved bytes; each pass's admit time of the first 8 prompts,
   time to first token (median, max) and tokens/s; every admit bucket's
   graph and the chunk's replayed against the same static function run
   eagerly from the same state (pages, rows, slot state and last logits
   bit-equal), each replay's device time by CUDA events; four
   sampled requests (temperature 1) through two captured engines of one
   seed give the same tokens, with fresh noise every step; the same 12
   prompts, 16 tokens each, through ``FixedSlotEngine`` (a dense
   ``[8, 2048]`` bf16 cache, its decode step captured once), plain and
   offloaded (the dense decode plan verified, planned once): the paged
   engine's first greedy tokens, a differing token only as a tie of the
   dense engine's logits within ``LOGIT_TOL``, and its captured step's
   host clock and replay time mid-flight;
5. a decode step mid-flight, 8 active slots: the captured step by the
   host clock, one replay's device time by CUDA events, its idle share
   and the profiler's view, beside the eager step's host clock and
   device kernels under ``torch.profiler``; one replay's logits against
   one eager run of the same static step from the same state (equal);
   and the same step taken through the kernel and through the plain
   version — logits agree;
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
   the attention and x segments of the plan for the fused kernels, the
   plans verified,
   ``plan_misses == traces == 1`` and ``plan_hits == 0``, captured once)
   and through ``capture_decode=False`` (the same tokens), then again
   through the captured engine (phase 4's admit readings, counters and
   replays); phase 5's
   decode readings for the offloaded step (B2's device time a step,
   summed over its ``seg_`` kernels); and take one decode step on the
   same state offloaded and eager, in bf16 and in f32 — logits agree;
7. training full-width qwen3-1.7b cut to 4 layers (``TRAIN_LAYERS``;
   ``--train`` trains all 28; f32 master parameters, bf16 compute,
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
   cast and batch slices (these untimed checks run while phase 12's
   processes do, in the whole script); the forward plan unchanged by batched
   anchors, its attention ``bmm`` declined; then the compiled step
   (``compile_train_step``: one CUDA graph over the donated state) from
   the same seed-0 state for 3 steps against those eager steps — losses,
   grad norms and lr of every step and every parameter and moment after
   step 3 bit-equal (compared on the host, leaf by leaf), launches a step
   by kernel equal, ``train_traces == 1``, the loss's and the update's
   ``plan_misses == traces == 1`` / ``plan_hits == 0``, ``bwd_plan_stats()``
   unchanged after the warm step; a replay's host clock, device time
   (CUDA events), idle share, kernels a step, the warm call's and the
   capture's seconds, the graph pool's bytes, peak memory and tokens/s
   beside the eager step's, and the state slots its write-back still
   copies (those the donating update leaves far) and their bytes; and
   the 2-layer f32 build with remat on,
   offload off and 2 microbatches, captured against ``capture=False``
   (bit-equal).  Phases 6 and 7 also launch one donating segment of each
   aliasing kind in place and with fresh outputs, each on its own copy
   of the same seeded operands (``inplace_check``: bit-equal, the output
   in the operand's storage, both times): the decode plan's weight
   stream (B3), the update bound with its parameters and moments donated
   (B2 on f32 leaves), and B3 / B4 / B6 from the training plans or,
   where those donate none, from a full-width chain whose operand a far
   ``sort`` makes (``DONATION_CHAINS``);
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
   (2e-5), bf16 (2e-2) and f16 (4e-3; B1 there too), plus rows for
   every path of B9 (registers, staged, direct; any D) and a
   misaligned x, and decode with ragged, full
   and empty rows in one split and in several (by T); at the width of qwen3-1.7b (hidden states
   [2, 1024, 2048], the q-norm [2, 1024, 16, 128], q / k [2048, 16 | 8,
   128] at theta 1e6, phase 3's cache gathered into dense caches), bf16
   and f32, one counted run of the path (every call a kernel launch, the
   plain versions only where asked for by ``impl="ref"``), B9's gradient
   through ``RMSNormFn`` against autograd of the plain version with a
   bit-equal ``ds`` over three launches, B10 at positions to 32,767, B11
   against B1 on the same cache and bit-equal across layouts; each timed
   (CUDA-graph replay, inputs rotated past the L2) beside the bound, the
   plain version and ``F.rms_norm`` / its fused backward / SDPA, and the
   device kernels of B9 and B9-bwd calls under the profiler, in a fresh
   process (one a call each); B9 and B10 in f16 at that width (one counted run, ds bit-equal
   over three launches, an f32 scale too), timed; B9 at d_model 16,384
   in f32, bf16 and f16 (staged rows, ds bit-equal), bf16 and f16
   timed beside the same; B1 and B11 (both layouts) in f16 at phase 3's
   main shape (queue C3's lift), one counted run against the plain
   versions, timed beside the bound, the plain version and SDPA; B5 / B7
   in bf16 and f16 at head dim 96 (taken since queue C2's lift) against
   their plain versions; and the inputs B1, B5, B7 and B11 refuse (queue
   C2: B5 / B7 at head dims 12 and 264, G = 128, f32 head dim 96, B7's
   f32 head dim 128; B1 / B11 at head dims 40 / 24), each raising before
   anything launches;
10. the kernel library's ssd_scan (B12) and wkv6 (B13) through ``ops``:
    each against its plain version at the CPU tests' shapes, at S = 999
    and odd widths, B13 at strong decay (w in [0.05, 0.2], finite), and at
    the FMA kernels' N / K = 96, in f32, bf16 and f16 (taken since queue
    C3's lift), every launch on the path its shape should take (``tc``,
    tensor cores at f32 accuracy, wherever the shape allows; ``fma`` for
    the rest) and printed; at full width (B = 2, S = 2,048; B12 at
    zamba2-1.2b's H = 64, P = N = 64, B13 at rwkv6-1.6b's H = 32, K = V =
    64) in bf16, f16 and f32, one counted run of the path each, every
    launch on the tensor-core path and bit-equal to its relaunch, each
    timed (CUDA-graph replay, two rotated input sets) beside the bound
    (bytes, or the products as TF32 passes at 495 TFLOP/s: three for two
    f32 operands, two where one is a 16-bit input), the previous f32
    FMA-rate bound and, in bf16, the plain version;
11. zamba2-1.2b and rwkv6-1.6b at full width, cut to 12 and 4 layers
    (``ZOO_SERVE_LAYERS``; ``--decode`` serves the full depth; random bf16
    weights from seed 0) through ``Engine(slots=8, max_len=2048,
    page_size=64)``: 12 greedy requests x 64 tokens (every request
    completes, B1 launched once a decode step for each of zamba2's
    shared-attention layers, 0 for rwkv6; captured once, the same tokens through
    ``capture_decode=False``; served twice, phase 4's admit readings, the
    admits eager — no bucket — and ``admit_traces`` the mix's distinct
    lengths), phase 5's decode readings with 8 active
    slots (zamba2: the step through B1 against its plain version), peak
    memory, and the captured engine's prefill and decode logits of 3
    requests against a full-sequence forward of the same tokens (bf16;
    f32 at 12 / 4 layers); then each through ``Engine(offload=True)`` as
    phase 6 serves qwen3's: the decode step captured and planned (seconds
    printed) and verified — zamba2's through the wrapper
    (``MPU_VERIFY_PLANS``) — its unit built, every distinct segment
    against its plain version (each anchored one's GEMM path printed),
    the mix served captured (one plan, the launches a step the plan's;
    the plain engine's tokens, a differing token only as a tie of the
    offloaded engine's logits within ``LOGIT_TOL``) and eagerly, 16
    tokens a request (the captured engine's first tokens), the offloaded
    step's decode readings beside the plain step's, and one step's logits
    and the recurrent state it writes against the plain model's
    (``--zoo-serve`` takes this phase alone);
12. durability and injected faults (below, also alone as
    ``--durability``);
13. zamba2-1.2b and rwkv6-1.6b trained, and queue C5's check (below, also
    alone as ``--zoo-train``);
14. the static plan verifier's finding counts over every plan the run
    built (the decode plans of phases 4, 6 and 11, the training plans of
    phases 7 and 13, phase 8's attention chain and its backward; any
    error fails), each distinct sm90 / weight-stream / flash kernel's
    shared memory as its launcher set it equal to the verifier's; a
    ``kernels`` JSON line, then the card line, then the result line.

    python3 chip_smoke.py --decode-segments [--src DIR]

takes phase 1 and phase 6's decode segment timings alone, on the package
under ``DIR`` where given (another checkout's ``src``), and prints no
result line: two checkouts' kernels timed by one script.

    python3 chip_smoke.py --decode [--src DIR]

takes phase 1 and the decode readings of phases 5, 6 and 11 alone
(qwen3-1.7b eager and offloaded, zamba2-1.2b, rwkv6-1.6b: the captured
step beside the eager one), on the package under ``DIR`` where given; a
package whose ``Engine`` has no ``capture_decode`` gives the eager step
alone, so one call compares two checkouts.

    python3 chip_smoke.py --admit [--src DIR]

takes phase 1 and the admit readings of phases 4, 6 and 11 alone (the
12-request mix eager, then twice captured, for qwen3-1.7b eager and
offloaded, zamba2-1.2b and rwkv6-1.6b), on the package under ``DIR``
where given; a package whose ``Engine`` has no ``admit_traces`` serves
the mix twice with its own (eager) admits.

    python3 chip_smoke.py --train [--src DIR]

takes phase 1 and phase 7's training readings alone (full-width,
full-depth qwen3-1.7b planned and built, 3 eager steps, then 3 compiled steps held
against them, and the 2-layer f32 build), on the package under ``DIR``
where given; a package without ``compile_train_step`` gives the eager
step alone, so one call compares two checkouts.

    python3 chip_smoke.py --donation

takes the in-place checks of phases 6 and 7 alone (at phase 7's depth)
and the compiled step's readings after them (``donation_alone``).

    python3 chip_smoke.py --norm [--src DIR]

does the same for phase 9's bf16 readings of B9 / B9-bwd (the hidden
states and d_model 16,384, each against its plain version, timed beside
the bound and the library calls, the device kernels a call);

    python3 chip_smoke.py --scan [--src DIR]

for phase 10's full-width readings of B12 / B13 in bf16 and f32 (each
against its plain version, timed beside the bounds);
``--kernels-a-call`` prints those device kernels alone, as a JSON line
(phase 9 runs it in a fresh process).  Phase 9 also launches two B9-bwd
calls of different shapes at once on two streams, then captures both on
two branches of one graph (queue C4: each launch's own arrival ticket),
every output bit-equal to its launch made alone.  Phase 12, also alone as

    python3 chip_smoke.py --durability [--src DIR]

trains full-width qwen3-1.7b at 4 layers (offloaded, compiled, 2 x 1,024
tokens) with ``train()`` in a subprocess from an empty checkpoint
directory and plan store under ``TMPDIR`` (steps 0-3, checkpoints every 2
steps), tears step 3's checkpoint, and resumes in a fresh subprocess:
step 3 bit-equal (metrics and every leaf's sha256), every loss, update
and backward plan a disk hit; it prints planning, first-step, save,
verify and restore seconds and GB/s, the checkpoint's bytes, peak device
memory and peak host RSS during each save.  Both subprocesses then serve
8 requests through a full-depth ``Engine(offload=True)`` on the same
store (the warm one's decode plan a disk hit, the same greedy tokens),
and the second serves them again with every ``fused_segment_grid``
launch faulted (quarantine, ``kernel_replans == 1``, the re-captured step
launching no B2, every request ``ok``; the share of tokens equal to the
unfaulted engine's and the largest logit difference printed).

Phase 13, also alone as

    python3 chip_smoke.py --zoo-train [--src DIR]

first takes queue C5's check: full-width qwen3-1.7b (f32 masters, bf16
compute, offloaded, remat off, 2 x 1,024 tokens) trained in a fresh
subprocess at 4 and at 28 layers — 2 eager steps of ``make_train_step``
as the first thing the process does, nothing planned or built ahead,
then 2 steps of ``compile_train_step`` bit-equal to them — and, in the
first, one bf16 dlhs segment launched through its plan's translation
unit and through a second unit of its own, bit-equal.  Then each of
full-width, full-depth zamba2-1.2b (38 layers, remat off) and
rwkv6-1.6b (24 layers, remat on: off, its step would not fit in 80 GB)
with random weights from seed 0 is trained the same way in a fresh
subprocess for 3 eager and 3 compiled steps: every compiled step
bit-equal to its eager step (losses, grad norms, lr, every leaf),
``train_traces == 1``, the plan counters as under jit, the tied
shared-attention block one tensor at every position with one AdamW
entry; every distinct B2 / B3 / B4 / B6 segment of the loss, backward
and update plans against its plain version (the bf16 anchored ones on
the sm90 mainloop), the plans verified (no error) and each sm90 kernel's
shared memory read back against the verifier's; a 2-layer f32 build
(zamba2: 12, for two ``shared_attention`` positions) offloaded against
the plain eager step; for rwkv6, 3 steps of the plain eager step in f32
at full depth, their
grad norms beside the offloaded bf16 steps'; it prints a replay's host
clock, CUDA-event device time and idle share, tokens/s, the first eager
step's capture, plan and build seconds, the first compiled step's warm
and capture seconds, launches a step by kernel, the plans' node and
segment counts, peak memory and the graph pool's bytes.  In the whole
script, to keep within its time limit, C5's check runs at 4 layers only
and rwkv6-1.6b at 4 (``WHOLE_RWKV6_LAYERS``; its plain f32 steps too);
zamba2's process takes its first eager step beside phase 12 and its
timed steps after it, and the C5 and rwkv6 processes
run beside zamba2's segment checks and f32 build, where the card's free
memory allows (``BESIDE_GIB``, ``BESIDE_RWKV6_GIB``); ``--durability``
and ``--zoo-train`` run each process alone, ``--zoo-train`` at the
depths above.

Exits non-zero (printing no result line) without a CUDA device, when a
kernel fails to build or launch, or when any check fails.  Float32
matrix products run in full float32 (TF32 off).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
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
from repro_torch.serve import Engine, Request, bucket_length
# the module, not the entry point of the same name the package exports
fe = importlib.import_module("repro_torch.kernels.fused_elementwise")

# datasheet figures of one H100 SXM (NVIDIA): the bound is computed
# against these whatever the card's power limit, which is printed beside
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

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
#: kernel against plain version: f32 2e-5 (summation order), bf16 2e-2
#: (one bf16 rounding on either side); f16 4e-3 (one f16 rounding, 2^-11
#: of the value, on either side; FLASH_TOL's f16 bound), which B9 / B10
#: and B1 / B11 take since queue C3's lift
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}
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
#: FMA kernels and their bf16 / f16 wgmma kernels; B8; B9; B12 / B13: their
#: tensor-core and FMA kernels)
NO_SPILL = ("flash_attention", "flash_attention_bwd", "adamw_update",
            "rmsnorm", "ssd_scan", "wkv6")
#: sources whose every instantiation's registers and spills are printed
PER_INSTANTIATION = ("rmsnorm", "ssd_scan", "wkv6")


def ptxas_entries(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) of each entry function in a
    ``ptxas -v`` report, demangled where ``c++filt`` is at hand."""
    out, entry, spill = [], "", 0
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "Used " in ln and " registers" in ln and entry:
            out.append((entry, int(ln.split("Used ")[1].split()[0]), spill))
            entry, spill = "", 0
    if out and shutil.which("c++filt"):
        names = run(["c++filt", *[e for e, _, _ in out]]).splitlines()
        out = [(n, r, sp) for n, (_, r, sp) in zip(names, out)]
    return [(n.replace("(anonymous namespace)::", "").replace("void ", "")
             .split("(")[0], r, sp) for n, r, sp in out]


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
        if name in PER_INSTANTIATION:
            for entry, r, sp in ptxas_entries(log):
                print(f"[2]   {entry}: {r} registers, {sp} bytes spilled")
    print(f"[2] build total {time.perf_counter() - t0:.1f} s -> "
          f"{_build.build_dir()}")
    check(not spilling, f"B5 / B7 / B8 / B9 / B12 / B13 instantiations "
          f"spill: {spilling}")


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


def timed_generate(engine, reqs) -> tuple[dict, dict]:
    """``engine.generate(reqs)`` by the host clock, the device synchronized
    before and after.  Returns the completions and the readings: the wall
    seconds and tokens/s, the first ``_pump``'s seconds (the admits of the
    first prompts, one a free slot) and how many it admitted, and each
    request's time to first token (submit, at the start, to the end of the
    step that emits its first token; median and max)."""
    pump, step = engine._pump, engine.step
    marks, first = {}, {}

    def timed_pump():
        if "admit_s" in marks:
            return pump()
        t = time.perf_counter()
        moved = pump()
        torch.cuda.synchronize()
        marks["admit_s"] = time.perf_counter() - t
        marks["admitted"] = int(engine._host_active.sum())
        return moved

    def timed_step():
        out = step()
        now = time.perf_counter() - t0
        for rid, _ in out:
            first.setdefault(rid, now)
        return out

    engine._pump, engine.step = timed_pump, timed_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = engine.generate(reqs)
        torch.cuda.synchronize()
    finally:
        del engine._pump, engine.step
    wall = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in done.values())
    ttft = sorted(first.values())
    return done, {"wall": wall, "tokens": tokens, "tokens_s": tokens / wall,
                  **marks, "ttft_median": float(np.median(ttft)),
                  "ttft_max": ttft[-1]}


def admit_line(r: dict) -> str:
    return (f"first {r['admitted']} prompts admitted in {r['admit_s']:.3f} s; "
            f"time to first token median {r['ttft_median']:.3f} s, max "
            f"{r['ttft_max']:.3f} s (host clock, submit -> first emitted "
            f"token); {r['tokens_s']:.1f} tokens/s")


def print_passes(first: dict, second: dict, label: str, tag: str) -> None:
    """Two passes of one mix through one engine, side by side."""
    print(f"{tag} {label} admits, pass 1 / pass 2: first prompts "
          f"{first['admit_s']:.3f} / {second['admit_s']:.3f} s, time to "
          f"first token median {first['ttft_median']:.3f} / "
          f"{second['ttft_median']:.3f} s, max {first['ttft_max']:.3f} / "
          f"{second['ttft_max']:.3f} s, {first['tokens_s']:.1f} / "
          f"{second['tokens_s']:.1f} tokens/s")


def serve(engine, reqs, label: str, tag: str = "[4]"
          ) -> tuple[dict, dict, dict]:
    """Run ``reqs`` to completion with the launch counts zeroed just
    before; returns the launch counts, read just after, the completions
    and the readings of ``timed_generate``."""
    layers = attention_layers(engine.cfg)
    ops.reset_launch_counts()
    steps0 = engine.decode_steps
    done, r = timed_generate(engine, reqs)
    counts = ops.launch_counts()
    launches = counts["paged_decode_attention"]
    steps = engine.decode_steps - steps0
    fused = {k: counts[k] for k in ("fused_segment_grid",
                                    "fused_matmul_segment") if counts[k]}
    print(f"{tag} {label}: {len(reqs)} requests, {r['tokens']} tokens, "
          f"{steps} decode steps, {r['wall']:.2f} s wall, "
          f"{r['tokens_s']:.1f} tokens/s, {launches} kernel launches (each "
          f"one wrapper call: the attention kernel plus, when split, its "
          f"combine kernel){f', fused {fused}' if fused else ''}, "
          f"serve_counters "
          f"{ {k: v for k, v in engine.serve_counters.items() if v} }")
    print(f"{tag} {label}: {admit_line(r)}")
    for q in reqs:
        c = done[q.rid]
        check(c.status == "ok" and len(c.tokens) == q.max_new_tokens,
              f"request {q.rid}: status {c.status}/{c.reason}, "
              f"{len(c.tokens)} tokens")
        check(all(0 <= t < engine.cfg.vocab_size for t in c.tokens),
              f"request {q.rid}: token outside the vocabulary")
    check(engine.pool.used_pages == 0, "pages leaked")
    check(steps > 0 and launches == steps * layers,
          f"{launches} launches != {steps} decode steps x {layers} "
          "attention layers")
    return {**counts, "decode_steps": steps}, done, r


def same_tokens(done: dict, want: dict, what: str, tag: str) -> None:
    """Token-for-token equality of two engines' completions."""
    diff = [r for r in want if done[r].tokens != want[r].tokens]
    print(f"{tag} {what}: {len(want) - len(diff)}/{len(want)} requests "
          "token for token identical")
    check(not diff, f"{what}: requests {diff} differ")


def check_captured(engine, label: str, tag: str) -> None:
    """The engine has served a mix: its decode step was built once
    (``step_traces == 1``) as one CUDA graph."""
    check(engine._graph is not None, f"{label}: the decode step was not "
          "captured")
    check(engine.serve_counters["step_traces"] == 1,
          f"{label}: step_traces {engine.serve_counters['step_traces']} "
          "!= 1 after the mix")
    graph = engine._graph
    mem, gib = graph.memory, 2.0 ** 30
    print(f"{tag} {label}: decode step captured once (step_traces 1), warm "
          f"step and capture {graph.seconds:.2f} s; max_memory_allocated "
          f"{mem['max_allocated'][0] / gib:.3f} -> "
          f"{mem['max_allocated'][1] / gib:.3f} GiB, memory_reserved "
          f"{mem['reserved'][0] / gib:.3f} -> {mem['reserved'][1] / gib:.3f} "
          "GiB across the capture (the growth: the graph's private pool)")


def serve_eager(eager, reqs, label: str, tag: str) -> dict:
    """``eager`` (the same static functions, ``capture_decode=False``)
    serves ``reqs``; returns its completions."""
    done, r = timed_generate(eager, reqs)
    print(f"{tag} {label}, capture_decode=False: {r['tokens']} tokens, "
          f"{r['wall']:.2f} s wall, {r['tokens_s']:.1f} tokens/s; "
          f"{admit_line(r)}")
    check(eager._graph is None and not eager._graphs,
          f"{label}: capture_decode=False captured")
    return done


def captured_vs_eager(engine, eager, reqs, label: str, tag: str) -> dict:
    """The captured engine has served ``reqs`` (``check_captured``);
    ``eager`` serves the same requests.  Returns its completions."""
    check_captured(engine, label, tag)
    return serve_eager(eager, reqs, label, tag)


def expected_admits(engine, lens) -> int:
    """The admit builds a mix of prompt lengths ``lens`` takes: one a pow2
    bucket, or one a distinct length where bucketing is off (the JAX
    engine's ``admit_traces``).  Chunked prompts take no admit."""
    chunk = engine.prefill_chunk if engine._chunkable else 0
    whole = [int(n) for n in lens if not chunk or n <= chunk]
    if not engine.bucket_prompts:
        return len(set(whole))
    return len({bucket_length(n, engine.max_len) for n in whole})


def pool_bytes(engine) -> int:
    """The reserved bytes the captures of the admit, chunk and control
    graphs added: the pool they share."""
    return sum(g.memory["reserved"][1] - g.memory["reserved"][0]
               for g in engine._graphs.values())


def check_admits(engine, lens, label: str, tag: str,
                 before: dict | None = None) -> dict:
    """The engine has served a mix of prompt lengths ``lens`` (again,
    where ``before`` holds the counters after the first pass): its
    ``admit_traces`` is the mix's distinct buckets (lengths where
    bucketing is off) and froze on the repeat; ``chunk_traces`` is 1 where
    it chunked.  Prints the graphs, the build time and the shared pool's
    reserved bytes; returns the trace counters."""
    sc = engine.serve_counters
    traces = {k: sc[k] for k in ("admit_traces", "step_traces",
                                 "chunk_traces", "control_traces")}
    want = expected_admits(engine, lens)
    graphs = engine._graphs
    built = sum(g.seconds for g in graphs.values())
    admits = sorted(k[1] for k in graphs if k[0] == "admit")
    print(f"{tag} {label}: {traces}; admit graphs by bucket {admits}, "
          f"{len(graphs)} graphs in all, built (warm call and capture) in "
          f"{built:.2f} s; the shared pool reserves "
          f"{pool_bytes(engine) / 2**20:.1f} MiB"
          + ("" if before is None else
             f"; after the first pass {before}"))
    check(traces["admit_traces"] == want,
          f"{label}: admit_traces {traces['admit_traces']} != {want}")
    if engine._capture and engine.bucket_prompts:
        check(len(admits) == want, f"{label}: {len(admits)} admit graphs")
    if not engine.bucket_prompts:
        check(not admits, f"{label}: an unbucketed admit was captured")
    if engine._chunkable:
        check(traces["chunk_traces"] == 1, f"{label}: chunk_traces "
              f"{traces['chunk_traces']} != 1")
    if before is not None:
        check(traces == before, f"{label}: the counters moved on the "
              f"repeat: {before} -> {traces}")
    return traces


def snapshot(engine, slot: int, ids) -> list:
    """Copies of what an admit or a chunk of ``slot`` writes: the pages
    ``ids`` of every attention layer, the slot's recurrent rows, the slot
    state and the last logits."""
    out = [t[slot].clone() for t in engine._state.values()]
    out.append(engine._prefill_logits.clone())
    for c in engine.cache:
        for n, t in c.items():
            out.append(t[ids].clone() if n in ("k", "v") else
                       t[slot].clone())
    return out


def put_back(engine, slot: int, ids, saved: list) -> None:
    it = iter(saved)
    for t in engine._state.values():
        t[slot] = next(it)
    engine._prefill_logits.copy_(next(it))
    for c in engine.cache:
        for n, t in c.items():
            if n in ("k", "v"):
                t[ids] = next(it)
            else:
                t[slot] = next(it)


def replay_vs_eager(engine, key: tuple, slot: int, ids, label: str,
                    tag: str, reps: int = 5) -> float:
    """The staged call ``key`` through its graph and through the same
    static function run eagerly, from the same state: every page and row
    it writes, the slot state and the last logits bit-equal.  Returns one
    replay's device milliseconds (CUDA events, mean of ``reps``; the
    replays repeat the same writes)."""
    graph = engine._graphs[key]
    fn = (functools.partial(engine._static_admit, key[1])
          if key[0] == "admit" else getattr(engine, f"_static_{key[0]}"))
    before = snapshot(engine, slot, ids)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    replayed = snapshot(engine, slot, ids)
    put_back(engine, slot, ids, before)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    eager = snapshot(engine, slot, ids)
    put_back(engine, slot, ids, before)
    same = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    print(f"{tag} {label} {key}: one replay {ms:.3f} ms on the device "
          f"(CUDA events, mean of {reps}), the same function eagerly "
          f"{eager_ms:.1f} ms by the host clock; pages {ids.tolist()}, the "
          f"slot's rows and state, the last logits "
          f"{'bit-equal' if same else 'DIFFERENT'}")
    check(same, f"{label} {key}: a replay differs from the eager call")
    return ms


def admit_replays(engine, label: str, tag: str) -> dict:
    """For every admit bucket the engine captured (the engine drained):
    a prompt of the bucket staged into slot 0, then ``replay_vs_eager``.
    Returns bucket -> one replay's device ms."""
    check(not engine._host_active.any(), f"{label}: engine not drained")
    cfg, out, slot = engine.cfg, {}, 0
    for key in sorted(k for k in engine._graphs if k[0] == "admit"):
        width = key[1]
        n = max(1, 3 * width // 4)
        prompt = make_requests(cfg, [n], 1, seed=9)[0].prompt
        need = engine.pool.pages_for(min(width, engine.kv_capacity))
        check(engine.pool.ensure(slot, need), "pages for the admit check")
        ids = torch.as_tensor(engine.pool.tables[slot][:need].astype(
            np.int64), device=engine.device)
        engine._stage(slot, 0, n, 7, 0.0, prompt, width)
        out[width] = replay_vs_eager(engine, key, slot, ids, label, tag)
        engine.pool.free_slot(slot)
    return out


def chunk_replay(engine, label: str, tag: str) -> float:
    """The chunk graph against the eager static chunk (the engine
    drained): slot 0's second chunk (ctx = one chunk, up to 200 real
    tokens), its pages compared (scratch page 0, where pad rows land in
    an unspecified order, left out)."""
    check(not engine._host_active.any(), f"{label}: engine not drained")
    c, slot = engine.prefill_chunk, 0
    n = min(200, c - 1)
    prompt = make_requests(engine.cfg, [n], 1, seed=10)[0].prompt
    need = engine.pool.pages_for(c + n)
    check(engine.pool.ensure(slot, need), "pages for the chunk check")
    ids = torch.as_tensor(engine.pool.tables[slot][:need].astype(np.int64),
                          device=engine.device)
    engine._stage(slot, c, n, 7, 0.0, prompt, c)
    ms = replay_vs_eager(engine, ("chunk",), slot, ids, label, tag)
    engine.pool.free_slot(slot)
    return ms


def sampled_runs(cfg, params, tag: str = "[4]") -> None:
    """Temperature 1 through two captured engines of one seed: the same
    tokens; the noise is drawn afresh before every step (no replay
    reuses a draw), and the draws leave the greedy tokens."""
    reqs = make_requests(cfg, [40, 300, 120, 64], 16, seed=8)
    runs = []
    for _ in range(2):
        eng = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                     page_size=64, seed=11)
        sums, step = [], eng.step

        def summed(eng=eng, sums=sums, step=step):
            n = eng.decode_steps
            out = step()
            if eng.decode_steps > n:
                sums.append(float(eng._noise.double().sum()))
            return out

        eng.step = summed
        done = eng.generate([dataclasses.replace(r, temperature=1.0)
                             for r in reqs])
        check(eng._graph is not None, "sampled engine not captured")
        runs.append(({r: c.tokens for r, c in done.items()}, sums))
        del eng
    greedy = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                    page_size=64).generate(reqs)
    (a, sums), (b, _) = runs
    fresh = all(x != y for x, y in zip(sums, sums[1:]))
    off_greedy = sum(a[r] != greedy[r].tokens for r in a)
    print(f"{tag} temperature 1, two captured engines of seed 11: "
          f"{'the same' if a == b else 'DIFFERENT'} tokens; noise drawn "
          f"afresh before each of {len(sums)} steps: {fresh}; "
          f"{off_greedy}/{len(a)} requests leave the greedy tokens")
    check(a == b, "sampled tokens differ between two engines of one seed")
    check(fresh and len(sums) > 1, "a decode step reused the noise")
    check(off_greedy > 0, "sampled requests equal the greedy ones")

def serve_twice(engine, eager, cfg, lens, new_tokens: int, seed: int,
                label: str, tag: str) -> tuple[dict, dict]:
    """The mix through the eager engine (``capture_decode=False``: every
    static function eager; first, as the process's first model run where
    it is), then twice through the captured one (admit graphs built in the
    first pass, replayed in the second); tokens identical, the counters
    as ``check_admits`` wants; then every admit bucket replayed against
    its eager call.  Returns the first captured pass's launch counts (and
    its decode steps) and completions."""
    want = serve_eager(eager, make_requests(cfg, lens, new_tokens, seed),
                       label, tag)
    check_admits(eager, lens, f"{label} capture_decode=False", tag)
    counts, done, first = serve(
        engine, make_requests(cfg, lens, new_tokens, seed),
        f"{label} pass 1", tag)
    check_captured(engine, label, tag)
    same_tokens(done, want, f"{label} captured vs eager", tag)
    before = check_admits(engine, lens, f"{label} pass 1", tag)
    _, again, second = serve(engine, make_requests(cfg, lens, new_tokens,
                                                   seed),
                             f"{label} pass 2", tag)
    same_tokens(again, want, f"{label} pass 2 vs eager", tag)
    check_admits(engine, lens, f"{label} pass 2", tag, before=before)
    print_passes(first, second, label, tag)
    if engine.bucket_prompts:
        admit_replays(engine, label, tag)
    return counts, done


# ------------------------------------------- the static plan verifier

#: finding counts by "rule/severity" over every plan this run verified,
#: and "plans", the plans verified
VERIFIED: dict = {}


def verify_plans(label: str, plans: list, tag: str) -> dict:
    """The static plan verifier (``repro_torch.analysis``) over ``plans``:
    their finding counts by rule printed, a failure on any
    error-severity finding.  Returns the counts."""
    from repro_torch.analysis import verify_plan

    t0 = time.perf_counter()
    counts: dict = {}
    errors = []
    for plan in plans:
        for f in verify_plan(plan):
            key = f"{f.rule}/{f.severity}"
            counts[key] = counts.get(key, 0) + 1
            VERIFIED[key] = VERIFIED.get(key, 0) + 1
            if f.severity == "error":
                errors.append(str(f))
    VERIFIED["plans"] = VERIFIED.get("plans", 0) + len(plans)
    segs = [sg for p in plans for sg in p.segments]
    print(f"{tag} verifier on {label}: {len(plans)} plan(s), "
          f"{len(segs)} segments ({sum(len(sg.donations) for sg in segs)} "
          f"donations, {sum(len(getattr(sg, 'dropped', ())) for sg in segs)}"
          f" dropped at plan time), findings by rule {counts or 'none'} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(not errors, f"{label}: verifier errors {errors[:3]}")
    return counts


def check_launched_smem(plans: list, tag: str) -> int:
    """For every distinct sm90, weight-stream and flash kernel of the
    plans (each launched by now), the verifier's dynamic shared memory
    (``segment_smem``) against what its launcher set, read back from the
    loaded kernel (``cudaFuncGetAttributes``' ``maxDynamicSharedSizeBytes``,
    as queue C5's probe read it).  The FMA template's products take only
    static shared memory.  Returns the number checked."""
    from repro_torch.analysis import segment_smem
    from repro_torch.core.offload import _matmul_gen, segment_call
    from repro_torch.kernels.flash_attention import launched_smem

    seen: dict = {}
    for plan in plans:
        eqns = plan.eqns
        for seg in plan.segments:
            mm = seg.matmul
            if mm is None:
                continue
            want = segment_smem(eqns, seg)
            if mm.flash is not None:
                dt = mm.lhs_var.meta["val"].dtype
                key = f"flash_attention h{mm.k} {dt}"
                if key not in seen:
                    seen[key] = (want["flash_attention"],
                                 launched_smem(mm.k, dt))
                continue
            gen = _matmul_gen(segment_call(eqns, seg))
            if gen["path"] != "fma" and gen["name"] not in seen:
                seen[gen["name"]] = (want[gen["path"]],
                                     fm.launched_smem(gen))
    bad = {k: v for k, v in seen.items() if v[0] != v[1]}
    print(f"{tag} dynamic shared memory of {len(seen)} distinct sm90 / "
          f"weight-stream / flash kernels launched: the verifier's bytes "
          f"{sorted({v[0] for v in seen.values()})}, the launchers' "
          f"maxDynamicSharedSizeBytes read back "
          f"{sorted({v[1] for v in seen.values()})}: "
          f"{'equal' if not bad else f'differ at {bad}'}")
    check(not bad, f"verifier vs launcher shared memory: {bad}")
    return len(seen)


# ------------------------------------- the dense FixedSlotEngine (4)

#: the tokens a request of phase 4's mix takes through ``FixedSlotEngine``:
#: held against the first 16 of the paged engine's 64 (a greedy token
#: depends on the tokens before it alone)
FIXED_SLOT_TOKENS = 16


def only_ties(done: dict, want: dict, logits: dict, label: str,
              what: str, tag: str) -> None:
    """Where a request's tokens (``done``) first differ from ``want``'s
    (its first ``len`` tokens), the logits its engine took the token from
    (``logits[rid][position]``) may only tie: ``want``'s token within
    ``LOGIT_TOL`` of their largest."""
    ties = []
    for rid, c in want.items():
        got = done[rid].tokens
        ref = c.tokens[:len(got)]
        if got == ref:
            continue
        p = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        lg = logits[rid][p].float()
        ties.append((rid, p, float(lg.max() - lg[ref[p]])))
    print(f"{tag} {label} vs {what}: {len(want) - len(ties)}/{len(want)} "
          f"requests token for token identical; first differing token "
          f"(request, position, this engine's logit gap to the other's "
          f"token): {ties or 'none'} (a tie within {LOGIT_TOL} accepted)")
    check(all(g <= LOGIT_TOL for _, _, g in ties),
          f"{label}: tokens differ from {what}'s beyond a tie")


def fixed_slot_runs(cfg, params, lens, paged: dict, tag: str = "[4]"
                    ) -> None:
    """``FixedSlotEngine`` (the reference's dense-cache engine: one
    ``[8, 2048]`` bf16 KV cache a layer) serves phase 4's mix, plain and
    offloaded, ``FIXED_SLOT_TOKENS`` a request, its decode step captured:
    the paged engine's greedy tokens (``paged``), a differing token
    accepted only as a tie of the dense engine's logits (``only_ties``);
    the offloaded plan
    verified, planned once; the captured step's host clock, a replay's
    device time and idle share mid-flight, beside phase 5's paged step."""
    from repro_torch.serve import FixedSlotEngine

    for offload in (False, True):
        label = "FixedSlotEngine" + " offload=True" * offload
        gc.collect()
        torch.cuda.empty_cache()
        eng = FixedSlotEngine(cfg, params, device="cuda", slots=8,
                              max_len=2048, offload=offload)
        cache_gb = sum(t.numel() * t.element_size()
                       for c in eng.cache for t in c.values()) / 1e9
        if offload:
            t0 = time.perf_counter()
            plan = eng.prepare_decode()
            t1 = time.perf_counter()
            if plan.library:
                fm.finish_library(fm.start_library(plan.library))
            st = eng.offload_stats
            n_mm = sum(seg.matmul is not None for seg in plan.segments)
            print(f"{tag} {label}: dense decode step captured "
                  f"{st['capture_s']:.1f} s and planned {st['plan_s']:.1f} s "
                  f"({t1 - t0:.1f} s), {len(plan.segments)} fused segments "
                  f"({len(plan.segments) - n_mm} grid, {n_mm} anchored), "
                  f"{sum(not d.fused for d in plan.decisions)} declined; "
                  f"its CUDA translation unit built in "
                  f"{time.perf_counter() - t1:.1f} s")
            verify_plans(f"{label} decode", [plan], tag)
        prefill, rows = {}, {}
        admit, run_decode = eng.admit, eng._run_decode_step

        def keep_admit(req, admit=admit, eng=eng):
            ok = admit(req)
            if ok:
                prefill[req.rid] = eng._prefill_logits[0]
            return ok

        def keep_step(run_decode=run_decode, eng=eng):
            rid, active = eng.rid.copy(), eng.active.copy()
            run_decode()
            for slot in np.flatnonzero(active):
                rows.setdefault(int(rid[slot]), []).append(
                    eng._logits[slot].clone())

        eng.admit, eng._run_decode_step = keep_admit, keep_step
        reqs = make_requests(cfg, lens, FIXED_SLOT_TOKENS, 1)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del eng.admit, eng._run_decode_step
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        tokens = sum(len(c.tokens) for c in done.values())
        print(f"{tag} {label}: {len(reqs)} requests, {tokens} tokens, "
              f"{eng.decode_steps} decode steps, {wall:.2f} s wall, "
              f"{tokens / wall:.1f} tokens/s; launches {counts}; "
              f"serve_counters {eng.serve_counters}; dense cache "
              f"{cache_gb:.3f} GB")
        check(eng._graph is not None and
              eng.serve_counters["step_traces"] == 1,
              f"{label}: the decode step was not captured once")
        if offload:
            st = eng.offload_stats
            check(st["plan_misses"] == st["traces"] == 1 and
                  st["plan_hits"] == 0, f"{label}: offload_stats {st}")
        for r in reqs:
            check(len(done[r.rid].tokens) == r.max_new_tokens,
                  f"{label} {r.rid} short")
        only_ties(done, paged, {rid: [prefill[rid], *rows[rid]]
                                for rid in prefill}, label,
                  f"the paged Engine (its first {FIXED_SLOT_TOKENS} tokens)",
                  tag)
        del prefill, rows
        for r in make_requests(cfg, MIDFLIGHT_LENS, 32, seed=3):
            eng.admit(r)
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / 5
        dev = replay_ms(eng, 5)
        print(f"{tag} {label} captured decode step, 8 active slots "
              f"(contexts {MIDFLIGHT_LENS}, the dense cache read to 2048): "
              f"{host:.3f} ms by the host clock, one replay {dev:.4f} ms on "
              f"the device (CUDA events), idle {1 - dev / host:.1%} of the "
              f"step")
        if offload:
            check_launched_smem([plan], tag)
        while eng.active.any():
            eng.step()
        del eng


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
    eager = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                   page_size=64, capture_decode=False)
    lens = np.random.default_rng(0).integers(16, 701, size=12)
    lens[0], lens[1] = 16, 700
    # the eager engine first: the process's first model run (library
    # handles, kernel loading) falls on it, as it fell on the eager step
    # of earlier readings of this phase
    counts, paged = serve_twice(engine, eager, cfg, lens, 64, 1,
                                "qwen3-1.7b", "[4]")
    fixed_slot_runs(cfg, params, lens, paged)

    chunk_lens = [300, 700, 520, 40]
    kw = dict(device="cuda", slots=8, max_len=2048, page_size=64,
              prefill_chunk=256)
    chunked, chunked_eager = Engine(cfg, params, **kw), \
        Engine(cfg, params, **kw, capture_decode=False)
    _, done, _ = serve(chunked, make_requests(cfg, chunk_lens, 16, seed=2),
                       "prefill_chunk=256")
    check_admits(chunked, chunk_lens, "prefill_chunk=256", "[4]")
    same_tokens(done, serve_eager(chunked_eager, make_requests(
        cfg, chunk_lens, 16, seed=2), "prefill_chunk=256", "[4]"),
        "prefill_chunk=256, captured vs eager", "[4]")
    chunk_replay(chunked, "prefill_chunk=256", "[4]")
    del chunked, chunked_eager
    sampled_runs(cfg, params)
    print(f"[4] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return engine, eager, counts["paged_decode_attention"]


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def profile_decode(engine, steps: int = 5, tag: str = "[5]",
                   what: str = "decode step") -> dict:
    """Where a decode step's time goes: ``steps`` steps by the host
    clock, then as many under ``torch.profiler``.  Returns the host
    clock, the device-busy time and the device kernels a step (the last
    two None where the profiler saw no device kernel)."""
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
        graph = [e.key for e in prof.key_averages() if "Graph" in e.key]
        print(f"{tag} {what} {step_ms:.2f} ms by the host clock; device "
              "time by kernel: not measured (the profiler saw no device "
              f"kernel; graph rows {graph})")
        return {"host_ms": step_ms, "busy_ms": None, "kernels": None}
    print(f"{tag} {what}, 8 active slots: {step_ms:.2f} ms by the host "
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
    return {"host_ms": step_ms, "busy_ms": busy_ms, "kernels": n_launch}


#: the eight prompts of the mid-flight decode readings
MIDFLIGHT_LENS = [33, 700, 64, 129, 511, 250, 17, 400]


def admit_midflight(engine, tag: str) -> float:
    """Admit MIDFLIGHT_LENS's prompts (32 new tokens each) into every
    slot; returns the host milliseconds of the admits."""
    for r in make_requests(engine.cfg, MIDFLIGHT_LENS, 32, seed=3):
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._pump()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"{tag} admitted {len(MIDFLIGHT_LENS)} prompts (lengths "
          f"{MIDFLIGHT_LENS}) in {ms:.1f} ms")
    return ms


def replay_ms(engine, steps: int = 5) -> float:
    """Mean device milliseconds of one replay of the engine's decode
    graph by CUDA events around it, over ``steps`` engine steps."""
    graph = engine._graph
    events = []

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        type(graph).replay(graph)
        end.record()
        events.append((start, end))

    graph.replay = timed
    try:
        for _ in range(steps):
            engine.step()
    finally:
        del graph.replay
    torch.cuda.synchronize()
    check(len(events) == steps, "a step did not replay the graph")
    return sum(a.elapsed_time(b) for a, b in events) / steps


def drain(engine) -> None:
    while engine._host_active.any():
        engine.step()
    engine.pop_finished()
    check(engine.pool.used_pages == 0, "pages leaked")


def replay_vs_eager_logits(engine, tag: str) -> float:
    """One replay's logits against one eager run of the same static step
    from the same state (the slot state, the emit buffer and the
    recurrent rows put back after each; both write the same K/V entry).
    The same kernels run in the same order: the difference should be 0."""
    engine._stage_inputs(None)
    saved = [t.clone() for t in (*engine._state.values(), engine._emit,
                                 *[t for c in engine.cache
                                   for n, t in c.items()
                                   if n not in ("k", "v")])]

    def put_back():
        for t, s in zip((*engine._state.values(), engine._emit,
                         *[t for c in engine.cache for n, t in c.items()
                           if n not in ("k", "v")]), saved):
            t.copy_(s)

    engine._graph.replay()
    replayed = engine._logits.float().clone()
    put_back()
    engine._static_step()
    eager = engine._logits.float().clone()
    put_back()
    torch.cuda.synchronize()
    err = float((replayed - eager).abs().max())
    same = int((replayed.argmax(-1) == eager.argmax(-1)).sum())
    print(f"{tag} one replay's logits vs one eager step from the same "
          f"state: max abs difference {err} (expected 0: the same kernels "
          f"in the same order), same greedy token in {same}/"
          f"{engine.slots} rows")
    check(bool(torch.isfinite(replayed).all()), "non-finite replay logits")
    check(err == 0.0, "a replay's logits differ from the eager step's")
    return err


def decode_readings(engine, eager, tag: str, label: str,
                    steps: int = 5) -> dict:
    """The decode step mid-flight, 8 active slots, the same prompts in
    both engines: the captured one (None on a package without
    ``capture_decode``) by the host clock, one replay's device time by
    CUDA events and the idle share, then under the profiler; the eager
    one (``capture_decode=False``, or the package's own) by the host
    clock and the profiler; then a replay's logits against the eager
    step's.  The engines are left mid-flight."""
    out = {}
    if engine is not None:
        admit_midflight(engine, tag)
        for _ in range(2):
            engine.step()
        check(engine._graph is not None, f"{label}: not captured")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / steps
        dev = replay_ms(engine, steps)
        print(f"{tag} {label} captured decode step, 8 active slots: "
              f"{host:.3f} ms by the host clock, one replay {dev:.4f} ms "
              f"on the device (CUDA events), idle {1 - dev / host:.1%} "
              "of the step")
        prof = profile_decode(engine, steps=steps, tag=tag,
                              what=f"{label} captured decode step")
        out["captured"] = {"host_ms": host, "replay_ms": dev,
                           "idle": 1 - dev / host, "profiler": prof}
    admit_midflight(eager, tag)
    prof = profile_decode(eager, steps=steps, tag=tag,
                          what=f"{label} eager decode step")
    out["eager"] = prof
    if prof["busy_ms"] is not None:
        print(f"{tag} {label} eager decode step: {prof['host_ms']:.3f} ms "
              f"by the host clock, busy {prof['busy_ms']:.4f} ms, idle "
              f"{1 - prof['busy_ms'] / prof['host_ms']:.1%}")
    if engine is not None:
        c = out["captured"]
        busy = "not measured" if prof["busy_ms"] is None else \
            f"{prof['busy_ms']:.4f} ms"
        print(f"{tag} {label}: step {prof['host_ms']:.3f} -> "
              f"{c['host_ms']:.3f} ms by the host clock "
              f"({prof['host_ms'] / c['host_ms']:.1f}x); eager device busy "
              f"{busy}, one replay {c['replay_ms']:.4f} ms")
        replay_vs_eager_logits(engine, tag)
    return out


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


def phase_full_width_check(engine, eager, label: str,
                           tag: str = "[5]") -> dict:
    """Stop the engine mid-flight (``decode_readings``) and take one
    decode step twice on the same state: through the kernel, and through
    the plain version (the recurrent layers' state rows restored after
    each step).  Returns the decode readings."""
    cfg = engine.cfg
    lens = MIDFLIGHT_LENS
    readings = decode_readings(engine, eager, tag, label)
    drain(eager)
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
    drain(engine)
    return readings


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
        vmem_bytes=call["vmem_bytes"], sms=call["sms"], batch=call["batch"],
        impl=impl)


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
    """Build and check every distinct segment kernel of phase 6's decode
    plans (``check_decode_segments``), their counts pinned, every bf16
    anchored one on the weight stream; time the bf16 ones.  Returns the
    timing rows by symbol."""
    rows = check_decode_segments(plans, "[6]", pinned=DECODE_PLAN,
                                 stream=("bf16",))
    return time_decode_segments(
        {sym: r for (label, sym), r in rows.items() if label == "bf16"},
        card)


def check_decode_segments(plans: dict, tag: str, *, pinned: dict | None,
                          stream: tuple = ()) -> dict:
    """Build and check every distinct segment kernel of the decode plans
    (label -> plan; a label starting "f32" holds an f32 plan) against its
    plain version, an anchored one also relaunched bit-equal, printing
    each one's path; with ``pinned``, each plan's (segments, grid,
    declined) counts; the plans labelled in ``stream`` keep every
    anchored segment on the weight stream.  Returns (label, symbol) ->
    (call, launches a step, operands)."""
    from repro_torch.core.offload import _matmul_gen

    t0 = time.perf_counter()
    started = [(label, fm.start_library(plan.library, verbose=True))
               for label, plan in plans.items() if plan.library]
    rows = {}
    for label, plan in plans.items():
        dtype = torch.float32 if label.startswith("f32") else torch.bfloat16
        segs = distinct_segments(plan)
        n_grid = sum(c for call, c in segs.values() if call["kind"] == "grid")
        n_declined = sum(not d.fused for d in plan.decisions)
        print(f"{tag} {label} plan: {len(plan.segments)} fused segments a "
              f"decode step ({n_grid} grid, {len(plan.segments) - n_grid} "
              f"anchored), {len(segs)} distinct kernels, "
              f"{n_declined} declined; "
              f"traffic {plan.traffic_reduction:.2f}x")
        if pinned is not None:
            check((len(plan.segments), n_grid, n_declined) == pinned[label],
                  f"{label} decode plan moved from {pinned[label]}")
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
            print(f"{tag}   grid {sym} rows {call['rows']} cols "
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
        print(f"{tag} {label} plan's CUDA translation unit: "
              f"{len(plans[label].library)} segments, registers per thread "
              f"{regs}, {spills} with spills")
        check(not gemm_spilling, f"weight-stream instantiations spill: "
              f"{gemm_spilling}")
    for label, plan in plans.items():
        dtype = torch.float32 if label.startswith("f32") else torch.bfloat16
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
            print(f"{tag}   anchored {sym} [{call['rows']}x{call['k']}]@"
                  f"[{call['k']}x{call['n']}] outs {call['out_cols']} "
                  f"x{count}/step, {path}: max_abs_err {err:.3e}, "
                  f"relaunch bit-equal {same}")
            check(ok, f"{label} anchored segment {sym} vs plain")
            check(same, f"{label} anchored segment {sym}: a relaunch differs")
            if label in stream:
                check(path.startswith("stream"), f"bf16 decode segment {sym} "
                      f"off the weight stream: {path}")
            rows[(label, sym)] = (call, count, vals)
    print(f"{tag} kernels built and checked in "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


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


def serve_offload(engine, eager, cfg, plan) -> dict:
    """Phase 4's mix through ``serve_twice`` on the offloaded engines:
    the plan looked up once, and each fused kernel launched once a decode
    step for each of its segments in the plan."""
    n_grid = sum(s.matmul is None for s in plan.segments)
    n_mm = len(plan.segments) - n_grid
    lens = np.random.default_rng(0).integers(16, 701, size=12)
    lens[0], lens[1] = 16, 700
    counts, _ = serve_twice(engine, eager, cfg, lens, 64, 1,
                            "qwen3-1.7b offload=True", "[6]")
    steps = counts["decode_steps"]
    st = engine.offload_stats
    print(f"[6] Engine(offload=True): launches in pass 1 {counts}, "
          f"offload_stats {st}")
    check(st["plan_misses"] == st["traces"] == 1 and st["plan_hits"] == 0,
          f"offload_stats {st}: not plan_misses == traces == 1, "
          "plan_hits == 0")
    check(counts["fused_segment_grid"] == steps * n_grid,
          f"grid launches != steps x {n_grid}")
    check(counts["fused_matmul_segment"] == steps * n_mm,
          f"anchored launches != steps x {n_mm}")
    return counts


#: the recurrent state one decode step writes, offloaded against the
#: plain model (the zoo's ``ssm`` / ``wkv`` in f32, ``conv`` / ``tshift``
#: / ``cshift`` in the compute dtype): the fused kernels round the step's
#: bf16 inputs and intermediates otherwise than the plain ops, each by up
#: to one bf16 ulp (2^-7 of a value), and a state's increment is a product
#: of up to three such factors, so each leaf is held within four ulps of
#: its largest magnitude.  A state row written from the wrong step, slot
#: or layer is off by the state's own size
STATE_ULPS = 4 * 2.0 ** -7


def offload_vs_eager(engine, label: str, tol: float, mean_tol: float, *,
                     eager=None, tag: str = "[6]") -> dict | None:
    """One decode step on the same state, offloaded and eager (after the
    decode readings of the captured offloaded step beside ``eager``'s,
    when given): the logits, and every recurrent state leaf each step
    writes (``STATE_ULPS``)."""
    cfg = engine.cfg
    lens = MIDFLIGHT_LENS
    readings = None
    if eager is not None:
        readings = decode_readings(engine, eager, tag,
                                   f"{engine.cfg.name} offload=True")
        drain(eager)
    else:
        for r in make_requests(cfg, lens, 32, seed=3):
            engine.submit(r)
        engine._pump()
    st = engine._state
    tables = torch.as_tensor(engine.pool.tables, device="cuda")
    check(int(st["active"].sum()) == len(lens), "not every slot decodes")
    args = (engine.params, engine.cache, st["tok"], st["pos"], tables,
            st["active"])
    # both steps write the same K/V entry; a recurrent row is put back
    state = [{n: t.clone() for n, t in c.items() if n not in ("k", "v")}
             for c in engine.cache]

    def put_back():
        for c, saved in zip(engine.cache, state):
            for n, t in saved.items():
                c[n].copy_(t)

    off, _ = engine._decode_offload(*args)
    wrote = [{n: c[n].clone() for n in saved}
             for c, saved in zip(engine.cache, state)]
    put_back()
    eager, _ = engine.model.decode_step_paged(*args, max_len=engine.max_len)
    worst: dict = {}
    for c, w in zip(engine.cache, wrote):
        for n, t in w.items():
            ref = c[n].float()
            scale = float(ref.abs().max())
            rel = float((t.float() - ref).abs().max()) / max(scale, 1e-30)
            check(bool(torch.isfinite(t).all()) and rel <= STATE_ULPS,
                  f"{label}: the offloaded step wrote recurrent state "
                  f"{n!r} {rel:.3e} of its largest magnitude from the "
                  f"plain step's")
            worst[n] = max(worst.get(n, 0.0), rel)
    put_back()
    del state, wrote
    torch.cuda.synchronize()
    if worst:
        print(f"{tag} {label} decode step, recurrent state written "
              f"offloaded vs plain: worst difference by leaf, as a share "
              f"of the leaf's largest magnitude "
              f"{ {n: f'{v:.3e}' for n, v in worst.items()} } (tolerance "
              f"{STATE_ULPS:.3e}: four bf16 ulps)")
    check(bool(torch.isfinite(off).all()), f"{label}: non-finite logits")
    err = max_err(off, eager)
    mean_err = float((off.float() - eager.float()).abs().mean())
    tok_o = off.argmax(-1)
    same = int((tok_o == eager.argmax(-1)).sum())
    gap = float((eager.max(-1).values
                 - eager.gather(1, tok_o[:, None])[:, 0]).max())
    print(f"{tag} {label} decode step, offloaded vs eager: max abs logit "
          f"difference {err:.3e} (tolerance {tol}), mean {mean_err:.3e} "
          f"(tolerance {mean_tol}, mean |logit| "
          f"{float(eager.float().abs().mean()):.3f}), same greedy token in "
          f"{same}/{len(lens)} rows, largest gap {gap:.4f}")
    check(err <= tol and mean_err <= mean_tol, f"{label} logits differ")
    check(gap <= 2 * err, f"{label} greedy tokens differ beyond a tie")
    drain(engine)
    return readings


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
    verify_plans("qwen3-1.7b decode plans (bf16, f32)", [plan16, plan32],
                 "[6]")
    donation_checks([plan16], ["stream"], card, "[6]")
    timed = phase_offload_kernels({"bf16": plan16, "f32": plan32}, card)
    check_launched_smem([plan16], "[6]")
    phase_offload_roles()
    eager = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                   page_size=64, offload=True, capture_decode=False)
    counts = serve_offload(off, eager, cfg, plan16)
    offload_vs_eager(off, "bf16", OFFLOAD_LOGIT_TOL, OFFLOAD_LOGIT_MEAN_TOL,
                     eager=eager)
    offload_vs_eager(off32, "f32", LOGIT_TOL_F32, LOGIT_MEAN_TOL_F32)
    del off32, params32, eager
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
#: phase 7's depth in the whole script: full-width qwen3-1.7b cut to 4
#: layers, so that the script keeps within its time limit; ``--train``
#: trains the full depth, and ``--zoo-train``'s C5 check trains the 28
#: layers, eager and compiled, from a fresh process
TRAIN_LAYERS = 4
#: the bf16 training plans of qwen3-1.7b at full width, by depth: the
#: forward plan (fused, fused by form, declined) as measured before
#: batched contractions were planned, which must not move it (the
#: attention bmm stay declined); the backward plans (plans, fused by
#: form, declined by form) and the update plan (fused, declined) as
#: planned before B2's redesign, whose geometry must not move them
TRAIN_PLANS = {28: ((719, {"grid": 557, "fwd": 162}, 1019),
                    (719, {"grid": 889, "drhs": 162, "dlhs": 162,
                           "fwd": 84}, {"grid": 448}),
                    (85, 284)),
               4: ((108, {"grid": 83, "fwd": 25}, 149),
                   (108, {"grid": 133, "drhs": 25, "dlhs": 25, "fwd": 12},
                    {"grid": 65}),
                   (13, 44))}
#: B4 / B6 launches a bf16 step at 28 layers as planned before the sm90
#: cost model: a difference is a backward decision the new modeled bytes
#: flip
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


def build_units(plans, tag: str = "[7]") -> tuple[list, float, list, int]:
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
        print(f"{tag} sm90 mainloop / weight-stream instantiations: registers "
              f"per thread {sm90_regs}, {len(sm90_spilling)} spilling")
    check(not sm90_spilling, f"sm90 / stream instantiations spill: "
          f"{sm90_spilling}")
    return units, time.perf_counter() - t0, regs, spills


def plan_training(step, state, batch, label: str, *, layers: int = 28,
                  tag: str = "[7]", copied_bmm: bool = True):
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
    uplan = step.update_fn.warm(*update_args(state))
    fst, bst = step.stats, bwd_plan_stats()
    units, build_s, regs, spills = build_units([fplan, uplan, *bplans], tag)

    def forms(plans, fused):
        n: dict = {}
        for p in plans:
            for d in p.decisions:
                if d.fused == fused:
                    k = d.form or "grid"
                    n[k] = n.get(k, 0) + 1
        return n

    print(f"{tag} {label}: forward plan {len(fplan.segments)} fused "
          f"{forms([fplan], True)} / {sum(not d.fused for d in fplan.decisions)}"
          f" declined, traffic {fplan.traffic_reduction:.2f}x; update plan "
          f"{len(uplan.segments)} fused / "
          f"{sum(not d.fused for d in uplan.decisions)} declined")
    print(f"{tag} {label}: {len(bplans)} backward plans: fused "
          f"{forms(bplans, True)}, declined {forms(bplans, False)}")
    bmm = [d for d in fplan.decisions if d.form == "bmm"]
    print(f"{tag} {label}: {len(bmm)} bmm in the forward, "
          f"{sum(not d.fused and 'batch axes not leading' in d.reason for d in bmm)}"
          f" declined for batch axes that a copy moved")
    check(all(not d.fused and (not copied_bmm or "batch axes not leading"
                                in d.reason) for d in bmm),
          f"{label}: a bmm was anchored")
    if label == "bf16":
        got = ((len(fplan.segments), forms([fplan], True),
                sum(not d.fused for d in fplan.decisions)),
               (len(bplans), forms(bplans, True), forms(bplans, False)),
               (len(uplan.segments),
                sum(not d.fused for d in uplan.decisions)))
        want = TRAIN_PLANS.get(layers)
        print(f"{tag} {label} plans at {layers} layers: {got}")
        check(want is not None, f"{label}: no plan counts pinned at "
              f"{layers} layers")
        for what, g, w in zip(("forward", "backward", "update"), got, want):
            check(g == w, f"{label}: the {what} plans moved from {w}")
    why: dict = {}
    for p in [fplan, *bplans]:
        for d in p.decisions:
            if d.form and not d.fused:
                why.setdefault(d.form, d.reason)
    for form, reason in why.items():
        print(f"{tag} {label}: a declined {form} anchor, for example: {reason}")
    print(f"{tag} {label}: capture {fst.capture_s + bst.capture_s:.1f} s "
          f"(forward {fst.capture_s:.1f}, backward {bst.capture_s:.1f}), plan "
          f"{fst.plan_s + bst.plan_s:.1f} s (forward {fst.plan_s:.1f}, "
          f"backward {bst.plan_s:.1f}); {len(units)} CUDA translation units "
          f"for {sum(len(u) for u in units)} anchored segments built together "
          f"in {build_s:.1f} s (registers per thread {regs}, {spills} with "
          f"spills)")
    verify_plans(f"{label} training plans (forward, backward, update)",
                 [fplan, *bplans, uplan], tag)
    return [fplan, *bplans, uplan]


def update_args(state) -> tuple:
    """The offloaded update's arguments in the train step's own form:
    the state's unique tensors (``Ties``) — the parameters, the
    parameters again standing in for the f32 gradients, and the moments
    with the step."""
    from repro_torch.models.transformer import Ties
    from repro_torch.optim import AdamWState

    ties = Ties(state.params)
    unique = ties.unique(state.params)
    return unique, unique, AdamWState(state.opt.step,
                                      ties.unique(state.opt.m),
                                      ties.unique(state.opt.v))


def global_norm_of(grads) -> float:
    """The global norm of a gradient tree, a tied block counted once."""
    from repro_torch.models.transformer import Ties
    from repro_torch.optim import global_norm
    return float(global_norm(Ties(grads).unique(grads)))


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
    times, per_step, losses, peaks, gnorms, lrs = [], [], [], [], [], []
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
        gnorms.append(float(metrics["grad_norm"]))
        lrs.append(float(metrics["lr"]))
        check(np.isfinite(losses[-1]) and np.isfinite(gnorms[-1]),
              "non-finite step")
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
          f"{per_step[2].get('fused_matmul_drhs_segment', 0)} (at 28 layers "
          f"before the sm90 cost model: {EARLIER_BWD_LAUNCHES[0]} / "
          f"{EARLIER_BWD_LAUNCHES[1]})")
    return state, counts, dict(step_ms=host_ms, busy_ms=busy_ms, peak=peak,
                               B2=b2_ms, grid=grid, **by_form, losses=losses,
                               gnorms=gnorms, lrs=lrs, per_step=per_step,
                               times=times,
                               kernels=sum(e.count for e in rows) / 2)


def memory_split(step, state, batch, plans) -> dict:
    """Device memory over one more offloaded step taken in its three
    parts — the forward, the backward and the update — each with its own
    peak; and the f32 workspace the anchored segments of the plans ask
    for (the largest call's, and the LM head's)."""
    from repro_torch.core.offload import _matmul_gen, segment_call
    from repro_torch.models.transformer import Ties
    from repro_torch.optim import AdamWState

    gib = 2.0 ** 30
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the step's own form: gradients and the update of the unique leaves
    ties = Ties(state.params)
    leaves = [p.detach().requires_grad_() for p in ties.unique(state.params)]
    loss, _ = step.loss_fn(ties.tree(leaves), batch)
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
        out = step.update_fn(ties.unique(state.params), list(grads),
                             AdamWState(state.opt.step,
                                        ties.unique(state.opt.m),
                                        ties.unique(state.opt.v)))
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
                   f32: bool, tag: str = "[7]"):
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
        print(f"{tag} {label}: loss offloaded {float(loss_o):.6f} vs plain "
              f"{float(loss_p):.6f} (|diff| {dl:.2e}, tolerance "
              f"{F32_LOSS_TOL}); worst gradient leaf {worst:.2e} of its "
              f"max-abs (tolerance {F32_GRAD_TOL}); grad norm {gn_o:.4f} "
              f"vs {gn_p:.4f}")
        check(dl <= F32_LOSS_TOL and worst <= F32_GRAD_TOL,
              f"{label}: offloaded and plain gradients differ")
    else:
        rel = abs(gn_o - gn_p) / gn_p
        print(f"{tag} {label}: loss offloaded {float(loss_o):.5f} vs plain "
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
        # fresh outputs: the operands are run again (``inplace_check``
        # holds the in-place launches)
        call = functools.partial(_segment_kernel(seg, progs, impl="cuda"),
                                 alias=False)
        ref = functools.partial(_segment_kernel(seg, progs, impl="ref"),
                                alias=False)
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
            path = "stream" if form == "fwd" and \
                seg.rows // mm.batch < 64 else "sm90"
            if gen["path"] != path or not gemm_path(gen).startswith(path):
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
            call = functools.partial(
                _segment_kernel(seg, progs, impl="cuda"), alias=False)
            ref = functools.partial(
                _segment_kernel(seg, progs, impl="ref"), alias=False)
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
    call = functools.partial(_segment_kernel(seg, progs, impl="cuda"),
                             alias=False)
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

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(remat=False, offload=True)
    model = build_model(cfg, device=DEVICE)
    state = init_train_state(model, 0)
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip",
                                                         *TRAIN_SHAPE)))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    t0 = time.perf_counter()

    def done(what: str) -> None:
        print(f"[7] {what}, {time.perf_counter() - t0:.1f} s into the phase")
    print(f"[7] training qwen3-1.7b at full width, {TRAIN_LAYERS} layers: "
          f"f32 master parameters and AdamW moments, bf16 compute, "
          f"{TRAIN_SHAPE[1]} x {TRAIN_SHAPE[0]} tokens a step, remat off, "
          f"offload on")
    step = make_train_step(model, tcfg)
    plans = plan_training(step, state, data.batch(0), "bf16",
                          layers=TRAIN_LAYERS)
    done("planned and built")
    held = [state]
    del state
    state, counts, reading = train_steps(step, held, data, tokens, plans)
    host = host_state(state)
    reading.update(memory_split(step, state,
                                device_batch(data.batch(3), DEVICE), plans))
    batch = device_batch(data.batch(0), DEVICE)
    grads = train_numerics(model, step, state, batch, tcfg,
                           "bf16 offloaded vs plain step", f32=False)
    b8 = phase_adamw(state, grads, tcfg, card)
    done("steps, memory, numerics and B8")
    del grads
    rows = check_train_segments(plans, torch.bfloat16, card, timed=True,
                                grid_ms=reading["grid"])
    check_launched_smem(plans, "[7]")
    update_leaf_segment(plans[-1], b8, card)
    done("segments")
    update_donation(state, tcfg, card)
    donation_checks(plans, ["fwd", "dlhs", "drhs"], card, "[7]")
    done("in-place launches (the sm90 variants, untimed, run beside phase "
         "12)")
    del state, step, plans
    gc.collect()
    torch.cuda.empty_cache()
    reading["compiled"] = train_compiled(model, tcfg, data, tokens, reading,
                                         host, f"bf16 {TRAIN_LAYERS} layers")
    del host
    train_small_compiled()
    done("compiled steps")

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


# ------------------------------- segment-boundary donation (phases 6, 7)

#: full-width chains (qwen3-1.7b's 2,048 tokens, d_model 2,048, MLP width
#: 6,144, bf16) whose plans donate an anchored epilogue operand of each
#: contraction form: the operand a far sort makes dies at the segment
DONATION_SHAPES = {"fwd": ((2048, 2048), (2048, 6144), (2048, 6144)),
                   "dlhs": ((2048, 6144), (2048, 6144), (2048, 2048)),
                   "drhs": ((2048, 2048), (2048, 6144), (2048, 6144))}


def _fwd_chain(x, w, y):
    r = torch.sort(y, dim=1).values
    return F.gelu(x @ w, approximate="tanh") + r


def _dlhs_chain(g, w, x):
    r = torch.sort(x, dim=1).values
    return torch.tanh(g @ w.t()) * 0.5 + r


def _drhs_chain(x, g, w):
    r = torch.sort(w, dim=1).values
    return x.t() @ g + r


DONATION_CHAINS = {"fwd": _fwd_chain, "dlhs": _dlhs_chain,
                   "drhs": _drhs_chain}


def donation_kind(eqns, seg) -> str:
    """``grid``, ``stream`` (a B3 weight-stream forward) or the anchored
    segment's form."""
    from repro_torch.core.offload import _matmul_gen, segment_call

    if seg.matmul is None:
        return "grid"
    if seg.matmul.form == "fwd" and \
            _matmul_gen(segment_call(eqns, seg))["path"] == "stream":
        return "stream"
    return seg.matmul.form


def donating_segments(plans, kinds) -> dict:
    """kind -> (eqns, segment) of the first segment of ``plans`` that
    donates, for each of ``kinds``."""
    out: dict = {}
    for plan in plans:
        for seg in plan.segments:
            if seg.donations:
                kind = donation_kind(plan.eqns, seg)
                if kind in kinds and kind not in out:
                    out[kind] = (plan.eqns, seg)
    return out


def chain_segments(kinds, tag: str) -> dict:
    """kind -> (eqns, segment): the donating segment of each
    ``DONATION_CHAINS[kind]`` at full width, its plan verified; the
    chains' translation units built together."""
    from repro_torch.core.offload import _register_library, offload_report

    out, units = {}, []
    for kind in kinds:
        args = [torch.zeros(s, dtype=torch.bfloat16, device=DEVICE)
                for s in DONATION_SHAPES[kind]]
        plan = offload_report(DONATION_CHAINS[kind], *args)
        verify_plans(f"the full-width {kind} donation chain", [plan], tag)
        seg = next((sg for sg in plan.segments if sg.donations and
                    donation_kind(plan.eqns, sg) == kind), None)
        check(seg is not None, f"the {kind} chain's plan donates nothing")
        units.append(_register_library(plan.eqns, plan))
        out[kind] = (plan.eqns, seg)
    for started in [fm.start_library(u) for u in units if u]:
        fm.finish_library(started)
    return out


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(torch.where(nan, 0, a), torch.where(nan, 0, b)))


def inplace_check(label: str, eqns, seg, card: str, tag: str) -> dict:
    """One donating segment launched in place (its planned aliases) and
    with fresh outputs (``alias=False``), each on its own copy of the
    same seeded operands (``seg_operands``): every output bit-equal, each
    donated output in its operand's storage (a mismatch fails the
    script); both device times by CUDA-graph replays, each launch of the
    in-place graph again on the operands the last one wrote."""
    from repro_torch.core.offload import (
        _dtype,
        _segment_arg_vars,
        _segment_kernel,
        segment_programs,
    )

    call = _segment_kernel(seg, segment_programs(eqns, seg), impl="cuda")
    n_mm = len(_segment_arg_vars(seg)) - len(seg.operand_specs)
    a, b = seg_operands(seg, 29), seg_operands(seg, 29)
    with torch.no_grad():
        got = call(*a)
        want = call(*b, alias=False)
        torch.cuda.synchronize()
        same = all(_bits_equal(g, w) for g, w in zip(got, want))
        home = all(got[oi].data_ptr() == a[n_mm + bi].data_ptr()
                   for bi, oi in seg.donations)
        check(same, f"{label}: the in-place launch differs from the "
              "fresh-output launch")
        check(home, f"{label}: a donated output is not in its operand's "
              "storage")
        check(all(want[oi].data_ptr() != b[n_mm + bi].data_ptr()
                  for bi, oi in seg.donations),
              f"{label}: the fresh-output launch wrote in place")
        ms = graph_ms(lambda i: call(*a), 4, replays=10)
        fresh_ms = graph_ms(lambda i: call(*b, alias=False), 4, replays=10)
    shape = f"[{seg.rows}x{max(seg.out_cols)}]"
    dts = sorted({str(_dtype(seg.operand_specs[bi].var))[6:]
                  for bi, _ in seg.donations})
    print(f"{tag} in place {label} {shape} ({'/'.join(dts)} donated, "
          f"{len(seg.donations)} of {len(seg.outputs)} outputs): bit-equal "
          f"to the fresh-output launch, each donated output in its "
          f"operand's storage; {ms:.4f} ms in place vs {fresh_ms:.4f} ms "
          f"fresh ({ms / fresh_ms:.3f}x) on {card}")
    del a, b, got, want
    return dict(shape=shape, ms=ms, fresh_ms=fresh_ms,
                donations=len(seg.donations))


def donation_checks(plans, kinds, card: str, tag: str) -> dict:
    """``inplace_check`` on one donating segment of each of ``kinds``
    that ``plans`` hold; an anchored form they do not donate in comes
    from its full-width ``DONATION_CHAINS`` chain (printed so).  Returns
    kind -> the check's reading."""
    found = donating_segments(plans, kinds)
    names = {"grid": "B2", "stream": "B3 (weight stream)", "fwd": "B3",
             "dlhs": "B4", "drhs": "B6"}
    missing = [k for k in kinds if k not in found]
    for kind in missing:
        print(f"{tag} the plans hold no donating {names[kind]} segment"
              + (": its full-width chain stands in"
                 if kind in DONATION_CHAINS else ""))
    chains = chain_segments([k for k in missing if k in DONATION_CHAINS],
                            tag)
    out = {}
    for kind in kinds:
        if kind not in found and kind not in chains:
            continue
        source = "the plans" if kind in found else "a chain"
        eqns, seg = found.get(kind) or chains[kind]
        out[kind] = dict(inplace_check(f"{names[kind]} ({source})", eqns,
                                       seg, card, tag), source=source)
    return out


def update_donation(state, tcfg, card: str, tag: str = "[7]") -> dict:
    """The update as the compiled step binds it (parameters and moments
    donated): its plan verified, its donations counted, and its
    donating B2 segment with the most donations (the fewest rows of
    those) launched in place against fresh outputs."""
    from repro_torch.train.step import _update_fn

    uplan = _update_fn(tcfg, True, donate=True).plan_for(
        *update_args(state))
    verify_plans("the donating update plan", [uplan], tag)
    segs = [sg for sg in uplan.segments if sg.donations]
    check(segs, "the donating update plan donates nothing")
    seg = max(segs, key=lambda sg: (len(sg.donations), -sg.rows))
    print(f"{tag} the donating update plan: {len(uplan.segments)} segments, "
          f"{sum(len(sg.donations) for sg in uplan.segments)} donations "
          f"({uplan.donated_hbm_bytes} bytes written in place), "
          f"{sum(len(sg.dropped) for sg in uplan.segments)} dropped")
    return inplace_check("B2 (the update, f32 leaves)", uplan.eqns, seg,
                         card, tag)


# ------------------------------------------ the compiled training step (7)

#: the kernels whose launches a step the compiled and the eager step must
#: share (the training path's; the grid kernel's operand copies beside)
TRAIN_KERNELS = ("fused_segment_grid", "fused_matmul_segment",
                 "fused_matmul_dlhs_segment", "fused_matmul_drhs_segment")


def state_leaves(state) -> list:
    """The leaves of a training state: parameters, step, moments."""
    import torch.utils._pytree as pytree
    return pytree.tree_leaves(state)


def host_state(state) -> list:
    """Every leaf of a training state copied to the host, one at a time,
    so that the next run's state can take the card's memory."""
    return [t.detach().cpu() for t in state_leaves(state)]


def state_differences(state, host: list) -> list:
    """(leaf index, shape, max abs difference) of every leaf of ``state``
    that is not bit-equal to ``host``'s, compared leaf by leaf where
    ``host``'s leaf lies (on the host, or kept on the device)."""
    out = []
    for i, (t, h) in enumerate(zip(state_leaves(state), host)):
        c = t.detach().to(h.device)
        if not torch.equal(c, h):
            out.append((i, tuple(h.shape), max_err(c, h)))
    return out


def timed_replays(graph, events: list) -> None:
    """Record CUDA events around each replay of ``graph`` into
    ``events`` (until ``del graph.replay``)."""
    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        type(graph).replay(graph)
        end.record()
        events.append((start, end))
    graph.replay = timed


def train_compiled(model, tcfg, data, tokens: int, eager: dict,
                   host: list | None, label: str, tag: str = "[7]",
                   steps: int = 3, plans_of=None, profile: bool = True
                   ) -> dict:
    """``compile_train_step`` from the seed-0 state for ``steps`` steps
    (the first: the warm call and the capture; then replays), held
    against the eager run ``eager`` (``train_steps``' reading, its final
    state on the host as ``host``): losses, grad norms and lr of every
    step and every parameter and moment after the last step bit-equal
    (else phase 7's bf16 rule, naming the leaves that differ), launches a
    step by kernel equal, ``train_traces == 1``, the loss's and the
    update's ``plan_misses == traces == 1`` and ``plan_hits == 0``,
    ``bwd_plan_stats()`` unchanged after the warm step, and every tensor
    the state's tree holds at several places (a tied block and its
    moments) still one tensor.  Prints a replay's host clock, its device
    time (CUDA events), the idle share, the kernels a step (profiler, one
    more step), the warm call's and the capture's seconds, the graph
    pool's bytes, peak memory and tokens/s, beside the eager step's.
    Prints the state slots the write-back copied (``last_copied``: the
    leaves the donating update leaves far), their bytes, and the leaves
    written in place.
    ``plans_of``: the eager step whose offloaded loss the compiled step
    looks its plans up in (planned once in the process; the plan counters
    then count the eager steps too and are not checked; the update, which
    the compiled step binds donated, is its own);
    ``profile=False`` takes no profiled step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profile_ctx

    from repro_torch.core.offload import bwd_plan_stats
    from repro_torch.models.transformer import Ties
    from repro_torch.train import compile_train_step, init_train_state

    state = init_train_state(model, 0)
    tied = [Ties(t).index for t in (state.params, state.opt.m, state.opt.v)]
    step = compile_train_step(model, tcfg)
    if plans_of is not None:
        # the loss's plans only: the compiled step binds its own update,
        # with the parameters and moments donated
        step.loss_fn, step.stats = plans_of.loss_fn, plans_of.stats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    times, per_step, metrics, events = [], [], [], []
    warm_bwd = None
    for i in range(steps):
        before = ops.launch_counts()
        copies = sum(fe.COPIES.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after
                         if after[k] - before[k]})
        per_step[-1]["grid operand copies"] = \
            sum(fe.COPIES.values()) - copies
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        if i == 0:
            warm_bwd = bwd_plan_stats().as_dict()
            graph = step.graph
            check(graph is not None, f"{label}: the step was not captured")
            timed_replays(graph, events)
    del graph.replay
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(events) == steps - 1,
          f"{label}: steps 2-{steps} did not replay the graph")
    dev_ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
    host_ms = sum(times[1:]) / len(times[1:]) * 1e3
    check([Ties(t).index for t in (state.params, state.opt.m,
                                   state.opt.v)] == tied,
          f"{label}: the state's tied tensors came apart")
    unique = len(step._unique_state(state))
    n_tied = sum(len(x) - max(x, default=-1) - 1 for x in tied)
    losses = [x["loss"] for x in metrics]
    check(all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
              for x in metrics), f"{label}: a non-finite compiled step")

    # counters as under jit
    counters = dict(step.counters)
    check(counters["train_traces"] == 1,
          f"{label}: train_traces {counters['train_traces']}")
    for name, st in (("loss", step.stats), ("update", step.update_stats)):
        st = st.as_dict()
        check(plans_of is not None or st["plan_misses"] == st["traces"] == 1
              and st["plan_hits"] == 0, f"{label}: {name} plan stats {st}")
    now_bwd = bwd_plan_stats().as_dict()
    check(all(now_bwd[k] == warm_bwd[k] for k in ("plan_misses", "traces",
                                                  "plan_hits")),
          f"{label}: bwd_plan_stats moved after the warm step: {warm_bwd} "
          f"-> {now_bwd}")
    want = eager["per_step"][-1]
    for i, got in enumerate(per_step):
        check(got == want, f"{label}: launches of step {i + 1} {got} differ "
              f"from the eager step's {want}")

    # against the eager run: bit for bit, else phase 7's bf16 rule
    same_metrics = [x["loss"] for x in metrics] == eager["losses"] and \
        [x["grad_norm"] for x in metrics] == eager["gnorms"] and \
        [x["lr"] for x in metrics] == eager["lrs"]
    diffs = state_differences(state, host) if host is not None else []
    bit_equal = same_metrics and not diffs
    print(f"{tag} {label} compiled vs eager, {steps} steps from the seed-0 "
          f"state: "
          f"losses {losses} vs {eager['losses']}, grad norms "
          f"{[x['grad_norm'] for x in metrics]} vs {eager['gnorms']}, lr "
          f"{[x['lr'] for x in metrics]} vs {eager['lrs']}; "
          + (f"{len(host)} leaves (parameters, step, moments) compared: "
             f"{len(diffs)} differ" if host is not None
             else "the state not compared")
          + (f" (first: {diffs[:4]})" if diffs else "")
          + f"; {'bit-equal' if bit_equal else 'NOT bit-equal'}; "
          f"{n_tied} places of the state hold a tensor another place "
          f"holds (a tied block), still one tensor each; the step "
          f"donates and writes {unique} unique tensors")
    if not bit_equal:
        for x, el, eg in zip(metrics, eager["losses"], eager["gnorms"]):
            dl = abs(x["loss"] - el)
            rel = abs(x["grad_norm"] - eg) / eg
            check(dl <= TRAIN_LOSS_TOL and rel <= TRAIN_GNORM_RTOL,
                  f"{label}: compiled and eager steps differ beyond phase "
                  f"7's bf16 rule (loss {dl:.2e}, grad norm {rel:.2e})")
        print(f"{tag} {label}: not bit-equal, within phase 7's bf16 rule "
              f"(loss {TRAIN_LOSS_TOL}, grad norm {TRAIN_GNORM_RTOL})")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # one more step under the profiler: the replay's kernels
    device = []
    if profile:
        with profile_ctx(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, data.batch(steps))
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and dev_us(e) > 0]
    rows = [e for e in device if "Memcpy" not in e.key]
    kernels = sum(e.count for e in rows) if rows else None
    busy = sum(dev_us(e) for e in rows) / 1e3 if rows else None
    # the copy-back of the update's outputs into the donated state (and
    # any other device-to-device copy of the step)
    copies = [e for e in device if "Memcpy" in e.key]
    copy_ms = sum(dev_us(e) for e in copies) / 1e3 if copies else None
    if profile:
        print(f"{tag} {label} compiled step's device copies (profiler, step "
              f"{steps + 1}): "
              + (", ".join(f"{e.key} x{e.count} {dev_us(e) / 1e3:.3f} ms"
                           for e in copies) if copies else "none seen"))
    slots = step._unique_state(state)
    # a package without donation copies every slot back
    copied = getattr(step, "last_copied", range(len(slots)))
    copied_bytes = sum(slots[i].numel() * slots[i].element_size()
                       for i in copied)
    print(f"{tag} {label} compiled step's write-back: {len(slots)} state "
          f"slots, {len(slots) - len(copied)} written in place by the "
          f"donating update, {len(copied)} copied ({copied_bytes} bytes, "
          f"{2 * copied_bytes} moved: each read and written once; "
          f"the leaves the update leaves far and the step counter)")
    pool = graph.memory["reserved"][1] - graph.memory["reserved"][0]
    warm_s, capture_s = graph.warm_seconds, graph.seconds - graph.warm_seconds
    print(f"{tag} {label} compiled step: first step {times[0]:.3f} s (warm "
          f"call {warm_s:.3f} s, capture {capture_s:.3f} s), replays "
          f"{[round(t * 1e3, 3) for t in times[1:]]} ms by the host clock "
          f"({host_ms:.3f} ms a step, {tokens / host_ms * 1e3:.0f} tokens/s);"
          f" one replay {dev_ms:.3f} ms on the device (CUDA events), idle "
          f"{1 - dev_ms / host_ms:.1%} of the step; "
          + (f"{kernels} device kernels a step, busy {busy:.3f} ms "
             f"(profiler, step {steps + 1})" if rows else
             "device kernels: not measured (" + (
                 "the profiler saw none)" if profile else "not profiled)"))
          + f"; graph pool {pool} bytes reserved ({pool / 2 ** 30:.2f} GiB),"
          f" peak device memory {peak:.2f} GiB ({resident:.2f} allocated "
          f"before the first step: the state and what earlier phases "
          f"hold); train_traces "
          f"{counters['train_traces']}, kernel_replans "
          f"{counters['kernel_replans']}; launches a step {per_step[-1]}")
    eager_busy = (f"device busy {eager['busy_ms']:.3f} ms "
                  f"({eager['kernels']:.0f} kernels a step)"
                  if eager.get("busy_ms") is not None
                  else "device busy not measured")
    print(f"{tag} {label} eager step beside it (same run): "
          f"{eager['step_ms']:.3f} ms a step by the host clock "
          f"({tokens / eager['step_ms'] * 1e3:.0f} tokens/s), {eager_busy}, "
          f"peak {eager['peak']:.2f} GiB; compiled / eager host clock "
          f"{host_ms / eager['step_ms']:.3f}")
    del state, step, graph
    gc.collect()
    torch.cuda.empty_cache()
    return dict(host_ms=host_ms, replay_ms=dev_ms, idle=1 - dev_ms / host_ms,
                kernels=kernels, busy_ms=busy, copy_ms=copy_ms,
                warm_s=warm_s,
                capture_s=capture_s, pool=pool, peak=peak, resident=resident,
                tokens_s=tokens / host_ms * 1e3, bit_equal=bit_equal,
                launches=per_step[-1], first_s=times[0],
                copied=len(copied), copied_bytes=copied_bytes,
                in_place=len(slots) - len(copied),
                metrics=metrics, unique=unique, tied=n_tied)


def train_small_compiled(tag: str = "[7]") -> None:
    """The 2-layer f32 build at full width with ``remat=True``,
    ``offload=False`` and 2 microbatches: ``compile_train_step`` captured
    against the same step with ``capture=False`` (eager on the card) for
    3 steps from the seed-0 state — metrics and every leaf bit-equal,
    ``train_traces == 1`` each."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.train import compile_train_step, init_train_state

    cfg32 = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2,
                                dtype="float32")
    model32 = build_model(cfg32, device=DEVICE)
    tcfg = TrainConfig(remat=True, offload=False, microbatches=2)
    data = SyntheticLM(make_data_config(cfg32, ShapeConfig("chip",
                                                           *TRAIN_SHAPE)))
    runs = {}
    for capture in (False, True):
        state = init_train_state(model32, 0)
        step = compile_train_step(model32, tcfg, capture=capture)
        ms, t0 = [], time.perf_counter()
        for i in range(3):
            state, m = step(state, data.batch(i))
            ms.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        check(step.counters["train_traces"] == 1 and
              (step.graph is not None) == capture,
              f"small build capture={capture}: {step.counters}")
        runs[capture] = (ms, host_state(state), time.perf_counter() - t0)
        del state, step
    (m0, s0, t_eager), (m1, s1, t_comp) = runs[False], runs[True]
    diffs = [i for i, (a, b) in enumerate(zip(s0, s1)) if not torch.equal(a, b)]
    print(f"{tag} 2-layer f32 full width, remat on, offload off, 2 "
          f"microbatches: compiled vs capture=False, 3 steps: losses "
          f"{[x['loss'] for x in m1]} vs {[x['loss'] for x in m0]}; "
          f"{len(s0)} leaves, {len(diffs)} differ; {t_comp:.1f} s vs "
          f"{t_eager:.1f} s for the 3 steps")
    check(m0 == m1 and not diffs,
          "small build: compiled and eager steps differ")


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
    verify_plans("the attention chain's plan and its backward plans",
                 [plan, *plans, bplan], "[8]")
    check_launched_smem([plan, *plans, bplan], "[8]")
    return b5, counts


@contextlib.contextmanager
def fresh_outputs():
    """Every segment call inside writes fresh outputs (its planned aliases
    dropped, as under autograd): a harness that runs a segment again on
    the operands it recorded keeps them (``inplace_check`` holds the
    in-place launches)."""
    from repro_torch.core import offload

    offload._NO_ALIAS[0] += 1
    try:
        yield
    finally:
        offload._NO_ALIAS[0] -= 1


class SegmentRecorder(torch.fx.Interpreter):
    """Runs a plan's runner graph, keeping the operands of every fused
    segment call (the calls carry their ``segment``), each call writing
    fresh outputs (``fresh_outputs``)."""

    def __init__(self, gm):
        super().__init__(gm)
        self.calls = []

    def run(self, *args, **kwargs):
        with fresh_outputs():
            return super().run(*args, **kwargs)

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
        with fresh_outputs():
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
        with fresh_outputs():
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

#: the CPU tests' shapes (tests/test_torch_library_kernels.py), plus rows
#: for every path of csrc/rmsnorm.cu (launch_geometry): narrow rows in
#: registers (D = 128, 96, 64), rows no multiple of 16 bytes (the direct
#: kernels: D = 99, 2,050, 4,099), staged wide rows (8,192; 8,200 over 300
#: rows, more rows than blocks), and rows too wide for the staged kernels
#: (the direct kernels in 16-byte vectors: 16,392, and 40,968 over 140
#: rows, whose backward partial row is too large for shared memory)
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


def ds_f32_close(ds, want, x, g, eps) -> tuple[bool, float]:
    """An f32 ds against the plain version's: 2e-5 of |ds| plus
    DS_ULPS_F32 of the column's sum of |g * xhat|."""
    d = x.shape[-1]
    xf, gf = x.float().reshape(-1, d), g.float().reshape(-1, d)
    xhat = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    mass = (gf * xhat).abs().sum(0)
    diff = (ds.float() - want.float()).abs()
    ok = bool((diff <= 2e-5 * want.float().abs() + DS_ULPS_F32 * mass).all())
    return ok, float(diff.max())


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
    on the card at the CPU tests' shapes, f32 (2e-5), bf16 (2e-2) and f16
    (4e-3), and B1 in f16 at its CPU tests' shapes (phase 3 holds it in
    f32 and bf16), one split and several."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain

    worst: dict = {}

    def note(key, ok, err, what):
        worst[key] = max(worst.get(key, 0.0), err)
        check(ok, f"{what}: max_abs_err {err:.3e}")

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
        if dtype == torch.float16:
            for i, shape in enumerate(SMALL_SHAPES):
                args = make_case(shape, dtype, seed=240 + i,
                                 empty_row=shape[0] > 1)
                want = paged_decode_attention_plain(*args)
                for splits in (None, 1, 3):
                    got = paged_decode_attention(*args, num_splits=splits)
                    note((dn, "paged_decode_attention"),
                         close_to_plain(got, want, args), max_err(got, want),
                         f"B1 at {shape} {dn} splits={splits}")
                    if shape[0] > 1:
                        check(bool((got[-1] == 0).all()),
                              "B1: a row with length 0 must come out as "
                              "zeros")
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
    print(f"[9] B9 / B10 / B11 at the CPU tests' shapes (and direct-path, "
          f"wide and misaligned rows for B9; one and several splits for "
          f"B11), f32, bf16 and f16, and B1 in f16 at its CPU tests' "
          f"shapes (queue C3 lifted), against the plain versions: worst "
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


def b9_readings(x, sc, g, eps, n_fwd: int, n_bwd: int, errs: dict
                ) -> dict:
    """B9 and B9-bwd on x / g ``[..., d]`` timed by CUDA-graph replay over
    ``n_fwd`` copies of x and ``n_bwd`` of (x, g), rotated so that each
    call finds its inputs out of the L2, beside their plain versions
    (eager) and ``F.rms_norm`` / its fused backward
    (``_fused_rms_norm_backward``, what its autograd runs; each checked
    against the plain version first).  Returns the kernels line's rows,
    ``errs`` giving each one's max_abs_err."""
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_bwd,
        rmsnorm_bwd_plain,
        rmsnorm_plain,
    )

    d, dtype = x.shape[-1], x.dtype
    wy = rmsnorm_plain(x, sc, eps)
    wdx, wds = rmsnorm_bwd_plain(x, sc, g, eps)
    # every yardstick runs once eagerly, against the plain version,
    # before a graph captures it (cuDNN allocates on its first call)
    check(within(F.rms_norm(x, (d,), sc, eps), wy, TOL[dtype])[0],
          f"F.rms_norm disagrees with the plain version ({dtype})")
    rstd = torch.ops.aten._fused_rms_norm(x, [d], sc, eps)[1]
    lib_dx, lib_ds = torch.ops.aten._fused_rms_norm_backward(
        g, x, [d], rstd, sc, [True, True])
    check(within(lib_dx, wdx, TOL[dtype])[0]
          and within(lib_ds, wds, TOL[dtype])[0],
          f"_fused_rms_norm_backward disagrees with the plain version "
          f"({dtype})")
    rows = {}
    xs = [x] + [x.clone() for _ in range(n_fwd - 1)]
    ms = graph_ms(lambda i: ops.rmsnorm(xs[i % n_fwd], sc, eps=eps), n_fwd)
    plain_ms = time_ms(lambda i: rmsnorm_plain(xs[i % n_fwd], sc, eps),
                       n_fwd)
    lib_ms = graph_ms(lambda i: F.rms_norm(xs[i % n_fwd], (d,), sc, eps),
                      n_fwd)
    rows["rmsnorm"] = lib_row(ms, plain_ms, lib_ms, nbytes(x, wy, sc), 0,
                              dtype, errs["rmsnorm"])
    del xs
    sets = [(x, g)] + [(x.clone(), g.clone()) for _ in range(n_bwd - 1)]
    rstds = [torch.ops.aten._fused_rms_norm(a, [d], sc, eps)[1]
             for a, _ in sets]
    ms = graph_ms(lambda i: rmsnorm_bwd(sets[i % n_bwd][0], sc,
                                        sets[i % n_bwd][1], eps=eps), n_bwd)
    plain_ms = time_ms(lambda i: rmsnorm_bwd_plain(
        sets[i % n_bwd][0], sc, sets[i % n_bwd][1], eps), n_bwd)
    lib_ms = graph_ms(lambda i: torch.ops.aten._fused_rms_norm_backward(
        sets[i % n_bwd][1], sets[i % n_bwd][0], [d], rstds[i % n_bwd], sc,
        [True, True]), n_bwd)
    rows["rmsnorm_bwd"] = lib_row(ms, plain_ms, lib_ms,
                                  nbytes(x, g, sc, wdx, wds), 0, dtype,
                                  errs["rmsnorm_bwd"])
    return rows


#: calls of each direction a profiler session holds, and the sessions
#: tried while one sees no device kernel at all (a session can miss them)
KERNEL_CALLS, KERNEL_SESSIONS = 4, 3


def kernels_a_call() -> dict:
    """The device kernels of KERNEL_CALLS calls of B9 and of B9-bwd at
    phase 9's bf16 hidden states, by ``torch.profiler`` (a throwaway
    session first, each call made once before, outside it; a session that
    sees no device kernel is tried again): {name: [kernel names]}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    cfg = get_config("qwen3-1.7b")
    eps = cfg.norm_eps
    gen = torch.Generator(device=DEVICE).manual_seed(230)
    x, sc, g = norm_case(gen, LIB_TOKENS, cfg.d_model, torch.bfloat16,
                         torch.bfloat16)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
    out = {}
    for name, fn in (("rmsnorm", lambda: ops.rmsnorm(x, sc, eps=eps)),
                     ("rmsnorm_bwd", lambda: rmsnorm_bwd(x, sc, g,
                                                         eps=eps))):
        fn()
        torch.cuda.synchronize()
        for _ in range(KERNEL_SESSIONS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(KERNEL_CALLS):
                    fn()
                torch.cuda.synchronize()
            out[name] = [e.key for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "Memcpy" not in e.key for _ in range(e.count)]
            if out[name]:
                break
    return out


def one_call_kernels(tag: str) -> dict:
    """``kernels_a_call`` in a fresh process of this script (a profiler
    session late in a long run of it saw no device kernels at all, while a
    fresh one sees them), printed; the caller requires one kernel a
    call."""
    cmd = [sys.executable, os.path.abspath(__file__), "--kernels-a-call"]
    if "--src" in sys.argv:
        cmd += ["--src", _src_root()]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"--kernels-a-call failed: {proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, kernels in out.items():
        print(f"{tag} {KERNEL_CALLS} {name} calls at {LIB_TOKENS + (2048,)} "
              f"bfloat16 under the profiler: {len(kernels)} device "
              f"kernel(s) {sorted(set(kernels))}")
    return out


#: B9-bwd launches in flight at once (queue C4): two shapes on two paths
#: (bf16 rows in registers, f32 rows staged), launched on two streams
#: ``C4_REPS`` times, then captured on two branches of one graph
C4_CASES = (((4096,), 2048, torch.bfloat16), ((1024,), 5120, torch.float32))
C4_REPS = 64


def b9_bwd_concurrent(card: str) -> None:
    """Queue C4: each B9-bwd launch counts its arriving blocks on a ticket
    of its own workspace.  Two launches of different shapes in flight at
    once on two streams, ``C4_REPS`` times, each bit-equal to the same
    launch made alone and within phase 9's tolerance of its plain
    version; then both captured on parallel branches of one CUDA graph
    and replayed, the same.  Either failing fails the script."""
    from repro_torch.kernels.rmsnorm import (
        launch_geometry,
        rmsnorm_bwd,
        rmsnorm_bwd_plain,
    )

    cases = []
    for i, (rows, d, dtype) in enumerate(C4_CASES):
        gen = torch.Generator(device=DEVICE).manual_seed(260 + i)
        x, s, g = norm_case(gen, rows, d, dtype, dtype)
        alone = rmsnorm_bwd(x, s, g)
        for got, want, what in zip(alone, rmsnorm_bwd_plain(x, s, g),
                                   ("dx", "ds")):
            ok, err = within(got, want, TOL[dtype])
            check(ok, f"C4: B9-bwd {what} alone at {rows + (d,)} "
                      f"{dtype}: max_abs_err {err:.3e}")
        geo = launch_geometry(
            rows[0], d, dtype, backward=True,
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
        cases.append(((x, s, g), alone, f"{rows + (d,)} {str(dtype)[6:]} "
                                        f"{geo.path}, grid {geo.grid}"))
    streams = [torch.cuda.Stream() for _ in cases]
    outs: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(C4_REPS):
        rep = []
        for st, (args, _, _) in zip(streams, cases):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                rep.append(rmsnorm_bwd(*args))
        outs.append(rep)
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    two_streams_s = time.perf_counter() - t0
    for rep in outs:
        for (_, alone, what), got in zip(cases, rep):
            check(all(torch.equal(a, b) for a, b in zip(got, alone)),
                  f"C4: B9-bwd {what} on two streams differs from the "
                  "launch made alone")
    del outs
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.graph(graph):
        main = torch.cuda.current_stream()
        side.wait_stream(main)
        first = rmsnorm_bwd(*cases[0][0])
        with torch.cuda.stream(side):
            second = rmsnorm_bwd(*cases[1][0])
        main.wait_stream(side)
    for _ in range(C4_REPS):
        for o in (*first, *second):
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for got, (_, alone, what) in zip((first, second), cases):
            check(all(torch.equal(a, b) for a, b in zip(got, alone)),
                  f"C4: B9-bwd {what} on a graph branch differs from the "
                  "launch made alone")
    del graph
    print(f"[9] C4: B9-bwd {cases[0][2]} and {cases[1][2]} in flight "
          f"together: {C4_REPS} launch pairs on two streams "
          f"({two_streams_s:.3f} s) and {C4_REPS} replays of both on two "
          f"branches of one graph, every output bit-equal to its launch "
          f"made alone; card {card}")


def library_full_width(card: str) -> tuple[dict, dict]:
    """The kernel library at the width of qwen3-1.7b: one counted run of
    the path (``ops.rmsnorm`` forward and backward on the hidden states,
    the q-norm, ``ops.rotary`` on q and k, ``ops.decode_attention`` in
    both layouts), its outputs against the plain versions in bf16 and f32,
    B11 against B1 on the same cache, then each kernel timed.  Returns the
    kernels line's rows and the path run's launches."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_plain
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
            res["rmsnorm_bwd ds"] = ds_f32_close(ds, sl.grad, x, g, eps)
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
        rows.update(b9_readings(x, sc, g, eps, LIB_ROTATE["rmsnorm"],
                                LIB_ROTATE["rmsnorm_bwd"], {
                                    "rmsnorm": res["rmsnorm"][1],
                                    "rmsnorm_bwd": max(
                                        res["rmsnorm_bwd dx"][1],
                                        res["rmsnorm_bwd ds"][1])}))
        kernels = one_call_kernels("[9]")
        # B9-bwd zeroes its launch's arrival ticket first (queue C4)
        memsets = {n: sum(k.startswith("Memset") for k in ks)
                   for n, ks in kernels.items()}
        launched = {n: [k for k in ks if not k.startswith("Memset")]
                    for n, ks in kernels.items()}
        check(all(len(k) == KERNEL_CALLS for k in launched.values())
              and memsets == {"rmsnorm": 0, "rmsnorm_bwd": KERNEL_CALLS},
              f"B9 / B9-bwd launch {kernels} over {KERNEL_CALLS} calls, "
              f"not one kernel a call each (and B9-bwd one 4-byte memset "
              f"a call)")
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


def print_b9(rows: dict, what: str, card: str, tag: str = "[9]") -> None:
    for name, r in rows.items():
        print(f"{tag}   {name} {what}: {r['ms']:.4f} ms on the card "
              f"(CUDA-graph replay), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"bytes ({r['n_bytes']} bytes; bound / kernel = "
              f"{r['bound_ms'] / r['ms']:.1%}; library / kernel = "
              f"{r['library_ms'] / r['ms']:.2f}), on {card}")


def library_wide_rows(card: str) -> None:
    """B9 on the widest dense decoders' rows: d_model 16,384, 2,048 rows,
    on the staged path (a row of x, and of x and g backward, in shared
    memory: read from device memory once), in f32, bf16 and f16:
    against the plain versions, ds bit-equal over three launches; bf16
    and f16 timed beside the bound and the library calls (two input sets
    of 67 MB each: every call finds its inputs out of the L2).  Not an
    entry of the kernels line."""
    from repro_torch.kernels.rmsnorm import (
        launch_geometry,
        rmsnorm_bwd,
        rmsnorm_bwd_plain,
    )

    d, n_rows, eps = 16384, 2048, 1e-5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype)[6:]
        gen = torch.Generator(device=DEVICE).manual_seed(232)
        x, sc, g = norm_case(gen, (n_rows,), d, dtype, dtype)
        y = ops.rmsnorm(x, sc, eps=eps, impl="cuda")
        (dx, ds), ds2, ds3 = (rmsnorm_bwd(x, sc, g, eps=eps),
                              rmsnorm_bwd(x, sc, g, eps=eps)[1],
                              rmsnorm_bwd(x, sc, g, eps=eps)[1])
        wdx, wds = rmsnorm_bwd_plain(x, sc, g, eps)
        res = {"y": within(y, ops.rmsnorm(x, sc, eps=eps, impl="ref"),
                           TOL[dtype]),
               "dx": within(dx, wdx, TOL[dtype]),
               "ds": (ds_f32_close(ds, wds, x, g, eps)
                      if dtype == torch.float32
                      else within(ds, wds, TOL[dtype]))}
        for what, (ok, err) in res.items():
            check(ok, f"B9 {what} at ({n_rows}, {d}) {dn}: max_abs_err "
                  f"{err:.3e}")
        check(torch.equal(ds, ds2) and torch.equal(ds2, ds3),
              f"B9-bwd ds differs between launches at d {d} ({dn})")
        paths = [launch_geometry(n_rows, d, dtype, backward=bwd,
                                 sms=sms).path for bwd in (False, True)]
        print(f"[9] B9 at d_model 16,384 ({n_rows} rows, {dn}; forward "
              f"{paths[0]}, backward {paths[1]}): max_abs_err "
              f"{ {n: f'{e:.2e}' for n, (_, e) in res.items()} }, ds "
              f"bit-equal over three launches")
        if dtype == torch.float32:
            continue
        print_b9(b9_readings(x, sc, g, eps, 2, 2, {
            "rmsnorm": res["y"][1],
            "rmsnorm_bwd": max(res["dx"][1], res["ds"][1])}),
            f"{dn} at d_model 16,384", card)
        del x, g, y, dx, wdx


def library_f16(card: str) -> None:
    """Queue C3 lifted at full width: B9 (forward; backward through
    ``RMSNormFn``; the q-norm) and B10 (q, k) in f16 at qwen3-1.7b's
    width, one counted run, against their plain versions, ds bit-equal
    over three launches, with an f16 and an f32 scale; B9 / B9-bwd timed
    beside the bound and the library calls, B10 beside its bound."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    from repro_torch.kernels.rotary import rotary, rotary_plain

    cfg = get_config("qwen3-1.7b")
    d, nq, nk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    h, theta, eps = cfg.resolved_head_dim, cfg.rope_theta, cfg.norm_eps
    b, s = LIB_TOKENS
    dtype = torch.float16
    gen = torch.Generator(device=DEVICE).manual_seed(233)
    x, sc, g = norm_case(gen, LIB_TOKENS, d, dtype, dtype)
    xq, scq, _ = norm_case(gen, (*LIB_TOKENS, nq), h, dtype, dtype)
    q, k = (seeded(gen, (b * s, n, h), dtype) for n in (nq, nk))
    pos = torch.arange(s, device=DEVICE, dtype=torch.int32).repeat(b)
    ops.reset_launch_counts()
    y, dx, ds = norm_grads(x, sc, g, eps, "auto")
    yq = ops.rmsnorm(xq, scq, eps=eps)
    rq, rk = (ops.rotary(t, pos, theta=theta) for t in (q, k))
    torch.cuda.synchronize()
    run = ops.launch_counts()
    want = {"rmsnorm": 2, "rmsnorm_bwd": 1, "rotary": 2}
    check(run == {k_: want.get(k_, 0) for k_ in run},
          f"phase 9 f16 path launches {run}, expected {want}")
    wdx, wds = rmsnorm_bwd_plain(x, sc, g, eps)
    res = {"rmsnorm": within(y, ops.rmsnorm(x, sc, eps=eps, impl="ref"),
                             TOL[dtype]),
           "rmsnorm q-norm": within(yq, ops.rmsnorm(xq, scq, eps=eps,
                                                    impl="ref"), TOL[dtype]),
           "rmsnorm_bwd dx": within(dx, wdx, TOL[dtype]),
           "rmsnorm_bwd ds": within(ds, wds, TOL[dtype]),
           "rotary q": within(rq, rotary_plain(q, pos, theta), TOL[dtype]),
           "rotary k": within(rk, rotary_plain(k, pos, theta), TOL[dtype])}
    # an f32 scale with f16 x: ds comes back in f32
    sc32 = sc.float()
    dx32, ds32 = rmsnorm_bwd(x, sc32, g, eps=eps)
    wdx32, wds32 = rmsnorm_bwd_plain(x, sc32, g, eps)
    check(dx32.dtype == dtype and ds32.dtype == torch.float32,
          f"B9-bwd f16 x, f32 scale gives {dx32.dtype}, {ds32.dtype}")
    res["rmsnorm_bwd dx, f32 scale"] = within(dx32, wdx32, TOL[dtype])
    res["rmsnorm_bwd ds, f32 scale"] = ds_f32_close(ds32, wds32, x, g, eps)
    ds2 = rmsnorm_bwd(x, sc, g, eps=eps)[1]
    ds3 = rmsnorm_bwd(x, sc, g, eps=eps)[1]
    torch.cuda.synchronize()
    for name, (ok, err) in res.items():
        check(ok, f"{name} full width float16: max_abs_err {err:.3e}")
    check(torch.equal(ds, ds2) and torch.equal(ds2, ds3)
          and torch.equal(ds32, rmsnorm_bwd(x, sc32, g, eps=eps)[1]),
          "B9-bwd ds differs between launches (float16)")
    print(f"[9] full width float16 (B9 x {tuple(x.shape)}, q-norm "
          f"{tuple(xq.shape)}, B10 q {tuple(q.shape)}, k {tuple(k.shape)}; "
          f"tolerance {TOL[dtype]}): max_abs_err "
          f"{ {n: f'{e:.2e}' for n, (_, e) in res.items()} }; ds bit-equal "
          f"over three launches; launches {run}")
    print_b9(b9_readings(x, sc, g, eps, LIB_ROTATE["rmsnorm"],
                         LIB_ROTATE["rmsnorm_bwd"], {
                             "rmsnorm": res["rmsnorm"][1],
                             "rmsnorm_bwd": max(res["rmsnorm_bwd dx"][1],
                                                res["rmsnorm_bwd ds"][1])}),
             "float16 [2, 1024, 2048]", card)
    for name, t in (("rotary q", q), ("rotary k", k)):
        ts = [t] + [t.clone() for _ in range(LIB_ROTATE["rotary"] - 1)]
        ms = graph_ms(lambda i: rotary(ts[i % len(ts)], pos, theta=theta),
                      len(ts))
        bound = (2 * nbytes(t) + nbytes(pos)) / HBM_BYTES_PER_S * 1e3
        print(f"[9]   {name} float16: {ms:.4f} ms on the card (CUDA-graph "
              f"replay), bound {bound:.4f} ms by bytes (bound / kernel = "
              f"{bound / ms:.1%}), on {card}")
        del ts


def decode_f16(card: str) -> dict:
    """Queue C3 lifted for B1 / B11: f16 at full width (phase 3's main
    shape, 8 sequences, 16 / 8 heads of 128, lengths to 2,048), one
    counted run — B1 on the pool, B11 on the same rows as dense caches in
    both layouts — against the plain versions (4e-3), B11's layouts
    bit-equal and B11 against B1; each timed (CUDA-graph replay, inputs
    rotated past the L2) beside the bound, the plain version and SDPA.
    Returns the readings by kernel."""
    from repro_torch.kernels.decode_attention import decode_attention_plain

    dtype = torch.float16
    b, np_, page, nq, nk, h = MAIN_SHAPE
    t = np_ * page
    n_rot = LIB_ROTATE["decode_attention"]
    pools = [make_case(MAIN_SHAPE, dtype, seed=100 + j, full_row=True)
             for j in range(n_rot)]
    q, pk, pv, tables, lengths = pools[0]

    def dense(case):
        gath = [c[case[3].long()] for c in case[1:3]]
        tok = [c.permute(0, 1, 3, 2, 4).reshape(b, t, nk, h).contiguous()
               for c in gath]
        hm = [c.permute(0, 2, 1, 3, 4).reshape(b, nk, t, h).contiguous()
              for c in gath]
        return tok, hm
    caches = [dense(c) for c in pools]
    tok, hm = caches[0]
    ops.reset_launch_counts()
    b1 = ops.paged_decode_attention(q, pk, pv, tables, lengths)
    o_tm = ops.decode_attention(q, *tok, lengths)
    o_hm = ops.decode_attention(q, *hm, lengths, head_major=True)
    torch.cuda.synchronize()
    run = ops.launch_counts()
    want_run = {"paged_decode_attention": 1, "decode_attention": 2}
    check(run == {k_: want_run.get(k_, 0) for k_ in run},
          f"phase 9 f16 decode launches {run}, expected {want_run}")
    w_b1 = paged_decode_attention_plain(q, pk, pv, tables, lengths)
    w_tm = decode_attention_plain(q, *tok, lengths)
    res = {"paged_decode_attention": within(b1, w_b1, TOL[dtype]),
           "decode_attention": within(o_tm, w_tm, TOL[dtype]),
           "decode vs B1": within(o_tm, b1, TOL[dtype])}
    for name, (ok, err) in res.items():
        check(ok, f"{name} full width float16: max_abs_err {err:.3e}")
    check(torch.equal(o_tm, o_hm),
          "B11 token-major and head-major differ at full width (float16)")
    print(f"[9] C3 lifted for B1 / B11: full width float16 {MAIN_SHAPE}, "
          f"lengths {lengths.tolist()}: max_abs_err "
          f"{ {n: f'{e:.2e}' for n, (_, e) in res.items()} } (tolerance "
          f"{TOL[dtype]}); B11 layouts bit-equal, B11 "
          f"{'bit-equal to' if torch.equal(o_tm, b1) else 'within the rule of'}"
          f" B1; launches {run}")
    live = int(lengths.sum())
    live_pages = int(((lengths + page - 1) // page).sum())
    elt = q.element_size()
    kv_bytes = 2 * live * nk * h * elt + 2 * q.numel() * elt + 4 * b
    flops = 4 * live * nq * h
    mask = (torch.arange(t, device=DEVICE)[None, :]
            < lengths[:, None])[:, None, None, :]

    def sdpa(i):
        return F.scaled_dot_product_attention(
            q[:, :, None, :], *caches[i % n_rot][1], attn_mask=mask,
            enable_gqa=True)
    check(within(sdpa(0)[:, :, 0], w_tm, TOL[dtype])[0],
          "scaled_dot_product_attention disagrees with the plain version "
          "(float16)")
    lib_ms = graph_ms(sdpa, n_rot)
    out = {}
    for name, ms, plain_ms, n_bytes in (
            ("paged_decode_attention", graph_ms(
                lambda i: paged_decode_attention(*pools[i % n_rot]), n_rot),
             time_ms(lambda i: paged_decode_attention_plain(
                 *pools[i % n_rot]), n_rot),
             kv_bytes + 4 * live_pages),
            ("decode_attention", graph_ms(lambda i: ops.decode_attention(
                q, *caches[i % n_rot][0], lengths), n_rot),
             time_ms(lambda i: decode_attention_plain(
                 q, *caches[i % n_rot][0], lengths), n_rot), kv_bytes)):
        out[name] = lib_row(ms, plain_ms, lib_ms, n_bytes, flops, dtype,
                            res[name][1])
    out["decode_attention"]["ms_head_major"] = graph_ms(
        lambda i: ops.decode_attention(q, *caches[i % n_rot][1], lengths,
                                       head_major=True), n_rot)
    for name, r in out.items():
        extra = (f", head-major {r['ms_head_major']:.4f} ms"
                 if "ms_head_major" in r else "")
        print(f"[9]   {name} float16: {r['ms']:.4f} ms on the card "
              f"(CUDA-graph replay, {n_rot} rotated input sets{extra}), "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms (scaled_dot_product_attention), "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['n_bytes']} bytes; bound / kernel = "
              f"{r['bound_ms'] / r['ms']:.1%}), on {card}")
    return out


def norm_readings(card: str) -> None:
    """``--norm``: phase 9's bf16 readings of B9 / B9-bwd alone, on the
    package this script was pointed at (``--src``): the hidden states [2,
    1024, 2048] (8 / 4 rotated input sets) and d_model 16,384 (2,048
    rows, 2 sets), each output against its plain version, timed beside
    the bound and the library calls, and the device kernels a call
    each.  Two checkouts' kernels compared by one script."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain

    cfg = get_config("qwen3-1.7b")
    dtype = torch.bfloat16
    for seed, lead, d, eps, n_fwd, n_bwd in (
            (230, LIB_TOKENS, cfg.d_model, cfg.norm_eps,
             LIB_ROTATE["rmsnorm"], LIB_ROTATE["rmsnorm_bwd"]),
            (232, (2048,), 16384, 1e-5, 2, 2)):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x, sc, g = norm_case(gen, lead, d, dtype, dtype)
        dx, ds = rmsnorm_bwd(x, sc, g, eps=eps)
        wdx, wds = rmsnorm_bwd_plain(x, sc, g, eps)
        res = {"y": within(ops.rmsnorm(x, sc, eps=eps),
                           ops.rmsnorm(x, sc, eps=eps, impl="ref"),
                           TOL[dtype]),
               "dx": within(dx, wdx, TOL[dtype]),
               "ds": within(ds, wds, TOL[dtype])}
        for what, (ok, err) in res.items():
            check(ok, f"B9 {what} at {tuple(x.shape)}: max_abs_err "
                  f"{err:.3e}")
        label = f"bf16 {list(x.shape)}"
        print_b9(b9_readings(x, sc, g, eps, n_fwd, n_bwd, {
            "rmsnorm": res["y"][1],
            "rmsnorm_bwd": max(res["dx"][1], res["ds"][1])}), label, card,
            "[norm]")
        del x, g, dx, wdx
    for name, kernels in kernels_a_call().items():
        print(f"[norm] {KERNEL_CALLS} {name} calls at "
              f"{LIB_TOKENS + (cfg.d_model,)} bfloat16 under the profiler: "
              f"{len(kernels)} device kernel(s) {sorted(set(kernels))}")


def expect_refusal(tag: str, what: str, exc, match: str, fn) -> None:
    """``fn`` must raise ``exc`` naming ``match``."""
    try:
        fn()
    except exc as e:
        check(match in str(e), f"{what}: {type(e).__name__} {e!s} "
              f"does not name {match!r}")
        print(f"{tag}: {what} refused: {type(e).__name__}: {e}")
        return
    check(False, f"{what} was not refused")


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
        expect_refusal("[9] C2", what, exc, match, fn)

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
    at the CPU tests' shapes and at full width, B1 / B11 in f16, and the
    inputs B1, B5, B7 and B11 refuse.  Returns the kernels line's four
    rows."""
    t0 = time.perf_counter()
    refused_inputs()
    library_small_shapes()
    b9_bwd_concurrent(card)
    rows, counts = library_full_width(card)
    library_f16(card)
    decode_f16(card)
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
#: B13 (B, S, H, K, V); every one on the tensor-core path
SSD_SMALL = [(2, 64, 2, 16, 8), (1, 100, 3, 8, 16), (1, 999, 4, 64, 64),
             (1, 77, 2, 40, 24)]
WKV_SMALL = [(2, 48, 2, 16, 16), (1, 70, 1, 32, 32), (1, 999, 3, 64, 64),
             (1, 45, 2, 24, 40)]
#: what the tensor-core paths leave to the FMA kernels: N, K = 96
SSD_FMA = [(1, 130, 2, 16, 96)]
WKV_FMA = [(1, 70, 2, 96, 32)]
#: full width, B = 2, S = 2,048: B12 at zamba2-1.2b's (H = 2 * 2048 / 64,
#: P = N = 64), B13 at rwkv6-1.6b's (H = 32, K = V = 64)
SSD_FULL = (2, 2048, 64, 64, 64)
WKV_FULL = (2, 2048, 32, 64, 64)
SCAN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SCAN_KERNELS = ("ssd_scan", "wkv6")
#: B12 / B13 against their plain versions.  Both sum in f32 (the kernels'
#: products in 3xTF32, within a few 2^-22 of the f32 product), in another
#: order than the plain version's einsum, so the difference is a few units
#: of 2^-22 of the terms a sum adds, which are at most the output's
#: largest magnitude: 2e-5 of that.  A 16-bit output may besides round to
#: the other neighbour: one ulp, at most 2^-7 of the value in bf16, 2^-10
#: in f16
SCAN_F32_SLACK = 2e-5
SCAN_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
#: the least time of f32-accurate products: TF32 tensor-core products
#: (NVIDIA's datasheet, dense), three a product of two f32 operands
#: (3xTF32), two where one operand is a 16-bit input (exact in TF32), by
#: that input's dtype
TF32_FLOPS = 495e12
TF32_PASSES = {torch.float32: 3, torch.bfloat16: 2, torch.float16: 2}
#: the chunk the operations are counted at, the one the bounds were first
#: stated with (B12 64, B13 32): B13's quadratic part is smaller at 32
#: than at its kernel's chunk of 64, and the bounds compare across PRs
SSD_FLOP_CHUNK, WKV_FLOP_CHUNK = 64, 32


def scan_close(got, want) -> tuple[bool, float]:
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bound = SCAN_F32_SLACK * float(w.abs().max())
    if got.dtype in SCAN_ULP:
        bound = bound + SCAN_ULP[got.dtype] * w.abs()
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


def ssd_flops(shape, chunk: int) -> tuple[int, int]:
    """f32 operations of the chunked SSD scan with C B^T formed once per
    batch row and chunk (B and C are shared by the heads): per chunk of q
    rows, q(q+1)/2 (C.B) dot products of N; per head q(q+1)/2 P (scores
    times dt x), q N P (C against the state), N P q (the state update)
    multiply-adds.  Returns (the operations with x as one operand: the
    scores times x and the update; those of two f32 operands)."""
    b, s, h, p, n = shape
    with_x = f32 = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        tri = q * (q + 1) // 2
        with_x += 2 * b * h * (tri * p + q * n * p)
        f32 += 2 * b * tri * n + 2 * b * h * q * n * p
    return with_x, f32


def wkv_flops(shape, chunk: int) -> tuple[int, int]:
    """f32 operations of the chunked WKV6 form: per chunk of q rows and
    head, the q(q-1)/2 pair scores over K (three operations a channel:
    r k, times the decay, added) and the diagonal, the scores times v,
    r against the state and the state update (multiply-adds).  Returns
    (the operations with v as one operand: the scores times v and the
    update; those of two f32 operands)."""
    b, s, h, k, v = shape
    with_v = f32 = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        with_v += b * h * (q * (q + 1) * v + 2 * q * k * v)
        f32 += b * h * (3 * q * (q - 1) // 2 * k + 3 * q * k + 2 * q * k * v)
    return with_v, f32


def scan_bound(n_bytes: int, flops: tuple[int, int],
               dtype: torch.dtype) -> dict:
    """The least time of the work: the bytes at the memory rate against
    the f32-accurate products as TF32 passes (``flops`` = (those with a
    ``dtype`` input as one operand, those of two f32 operands)); the
    previous bound (all at the f32 FMA rate) beside it."""
    with_input, f32 = flops
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (TF32_PASSES[dtype] * with_input
             + TF32_PASSES[torch.float32] * f32) / TF32_FLOPS * 1e3
    t_fma = (with_input + f32) / PEAK_FLOPS[torch.float32] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops, fma_bound_ms=max(t_bytes, t_fma),
                n_bytes=n_bytes, flops=with_input + f32)


def scan_paths() -> dict:
    """Launches of B12 / B13 since the last count reset by the path each
    took: ``tc`` (tensor cores, 3xTF32) or ``fma``."""
    return {f"{name} / {path}": n
            for (name, path), n in sorted(kernel_guard().variants.items())
            if name in SCAN_KERNELS}


def on_path(fn, want: str, what: str):
    """``fn()`` launches one B12 / B13 kernel, on the path ``want``."""
    kernel_guard().variants.clear()
    out = fn()
    paths = scan_paths()
    check(len(paths) == 1 and next(iter(paths)).endswith(f"/ {want}"),
          f"{what}: launched on {paths}, expected the {want} path")
    return out


def scan_small_shapes() -> dict:
    """B12 and B13 against their plain versions at the CPU tests' shapes
    (and S a multiple of no chunk, odd widths), B13 at strong decay, and
    the FMA kernels' shapes, in f32, bf16 and f16; every launch on the
    path its shape should take.  Returns the worst max_abs_err by name."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain

    worst: dict = {}

    def hold(name, dn, what, got, want, strong=False):
        ok, err = scan_close(got, want)
        key = f"{dn} {name}"
        worst[key] = max(worst.get(key, 0.0), err)
        check(ok and (not strong or bool(torch.isfinite(got).all())),
              f"{what}: max_abs_err {err:.3e}")

    for dtype in SCAN_DTYPES:
        dn = str(dtype)[6:]
        paths = []
        for i, shape in enumerate(SSD_SMALL + SSD_FMA):
            path = "tc" if shape in SSD_SMALL else "fma"
            args = ssd_case(shape, dtype, 300 + i)
            got = on_path(lambda: ops.ssd_scan(*args, impl="cuda"), path,
                          f"B12 {shape} {dn}")
            hold("ssd_scan", dn, f"B12 at {shape} {dn}", got,
                 ssd_scan_plain(*args)[0])
            paths.append(f"B12 {shape}: {path}")
        for i, shape in enumerate(WKV_SMALL + WKV_FMA):
            path = "tc" if shape in WKV_SMALL else "fma"
            args = wkv_case(shape, dtype, 310 + i)
            got = on_path(lambda: ops.wkv6(*args, impl="cuda"), path,
                          f"B13 {shape} {dn}")
            hold("wkv6", dn, f"B13 at {shape} {dn}", got,
                 wkv6_plain(*args)[0])
            paths.append(f"B13 {shape}: {path}")
        # strong decay: w in [0.05, 0.2], a chunk of 64 sums log-decays to
        # about -190 at worst, past f32's exp range for the reference's form
        args = wkv_case((2, 256, 4, 64, 64), dtype, 320, lo=0.05, hi=0.2)
        got = on_path(lambda: ops.wkv6(*args, impl="cuda"), "tc",
                      f"B13 strong decay {dn}")
        hold("wkv6 strong decay", dn, f"B13 at strong decay {dn}", got,
             wkv6_plain(*args)[0], strong=True)
        paths.append("B13 (2, 256, 4, 64, 64) strong decay: tc")
        print(f"[10] {dn} launches by path: {'; '.join(paths)}")
    torch.cuda.synchronize()
    print(f"[10] B12 / B13 at the CPU tests' shapes, S = 999 and odd widths, "
          f"the FMA kernels' N / K = 96, and B13 at w in [0.05, 0.2] "
          f"(finite), f32, bf16 and f16, against the plain versions: worst "
          f"max_abs_err { {k: f'{e:.2e}' for k, e in worst.items()} }")
    return worst


def scan_timing(args, fn, plain, out, flops, *, plain_time=True) -> dict:
    """``fn(*args)`` timed by CUDA-graph replay over two input sets (71 /
    101 MB each in bf16, past the L2), beside its bounds and the plain
    version."""
    sets = [args, tuple(t.clone() for t in args)]
    ms = graph_ms(lambda i: fn(*sets[i % 2]), 2)
    plain_ms = time_ms(lambda i: plain(*sets[i % 2]), 2, warmup=1) \
        if plain_time else None
    del sets
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                **scan_bound(nbytes(*args, out), flops, args[0].dtype))


def print_scan_row(name, dn, r, card, tag="[10]") -> None:
    plain = (f"plain {r['plain_ms']:.4f} ms, " if r["plain_ms"] is not None
             else "")
    print(f"{tag}   {name} {dn}: {r['ms']:.4f} ms on the card (CUDA-graph "
          f"replay, 2 rotated input sets), {plain}library none (no one "
          f"PyTorch call computes it), bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']} (bytes {r['bytes_ms']:.4f}, TF32 products "
          f"{r['ops_ms']:.4f} in {TF32_PASSES[torch.float32]} passes, "
          f"{TF32_PASSES[getattr(torch, dn)]} on the {dn} operand; "
          f"{r['n_bytes']} bytes, {r['flops']} flops; bound / kernel = "
          f"{r['bound_ms'] / r['ms']:.1%}; the f32 FMA-rate bound "
          f"{r['fma_bound_ms']:.4f} ms, {r['fma_bound_ms'] / r['ms']:.1%}), "
          f"on {card}")


def scan_full_width(dtype, card: str, *, timed: bool, plain_time: bool,
                    tag: str = "[10]", paths_known: bool = True
                    ) -> tuple[dict, dict]:
    """B12 at zamba2's and B13 at rwkv6's full width in ``dtype``: one
    counted run of the library path, each launch on the tensor-core path
    (where ``paths_known``: a package whose B12 / B13 count launches by
    path), made twice and bit-equal, against the plain version; timed
    where ``timed``.  Returns (rows by kernel, launches of the run)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_plain

    dn = str(dtype)[6:]
    s_args = ssd_case(SSD_FULL, dtype, 330)
    w_args = wkv_case(WKV_FULL, dtype, 331)
    ops.reset_launch_counts()
    y_s = ops.ssd_scan(*s_args)
    y_w = ops.wkv6(*w_args)
    torch.cuda.synchronize()
    run, paths = ops.launch_counts(), scan_paths()
    want = {"ssd_scan": 1, "wkv6": 1}
    check(run == {k_: want.get(k_, 0) for k_ in run},
          f"phase 10 path launches {run}, expected {want}")
    check(paths == {"ssd_scan / tc": 1, "wkv6 / tc": 1} or not paths_known,
          f"full width {dn} off the tensor-core path: {paths}")
    again = (ops.ssd_scan(*s_args), ops.wkv6(*w_args))
    torch.cuda.synchronize()
    check(torch.equal(y_s, again[0]) and torch.equal(y_w, again[1]),
          f"B12 / B13 full width {dn} differ between launches")
    ops.reset_launch_counts()
    p_s = ops.ssd_scan(*s_args, impl="ref")
    p_w = ops.wkv6(*w_args, impl="ref")
    torch.cuda.synchronize()
    check(not any(ops.launch_counts().values()),
          f"impl='ref' launched kernels: {ops.launch_counts()}")
    res = {"ssd_scan": scan_close(y_s, p_s), "wkv6": scan_close(y_w, p_w)}
    for name, (ok, err) in res.items():
        check(ok, f"{name} full width {dn}: max_abs_err {err:.3e}")
    print(f"{tag} full width {dn}: B12 x {tuple(s_args[0].shape)} "
          f"(N {SSD_FULL[4]}), B13 r {tuple(w_args[0].shape)}: "
          f"max_abs_err { {n: f'{e:.2e}' for n, (_, e) in res.items()} } "
          f"(max-abs {float(p_s.float().abs().max()):.1f} / "
          f"{float(p_w.float().abs().max()):.1f}); launches by path {paths}, "
          f"each bit-equal to its relaunch")
    rows = {}
    if timed:
        for name, args, fn, plain, out, flops in (
                ("ssd_scan", s_args, ops.ssd_scan, ssd_scan_plain, y_s,
                 ssd_flops(SSD_FULL, SSD_FLOP_CHUNK)),
                ("wkv6", w_args, ops.wkv6, wkv6_plain, y_w,
                 wkv_flops(WKV_FULL, WKV_FLOP_CHUNK))):
            rows[name] = scan_timing(args, fn, plain, out, flops,
                                     plain_time=plain_time)
            rows[name]["max_abs_err"] = res[name][1]
            print_scan_row(name, dn, rows[name], card, tag)
    return rows, run


def phase_scan(card: str) -> dict:
    """Phase 10: the kernel library's B12 and B13 through ``ops`` at the
    CPU tests' shapes, the FMA kernels' shapes and at full width (zamba2's
    and rwkv6's) in f32, bf16 and f16, one counted run of the library
    path, each timed beside its bound and its plain version.  Returns the
    kernels line's two rows."""
    t0 = time.perf_counter()
    scan_small_shapes()
    rows, counts = {}, {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        r, run = scan_full_width(dtype, card, timed=True,
                                 plain_time=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            rows, counts = r, run
        torch.cuda.empty_cache()
    print(f"[10] ssd_scan and wkv6 in {time.perf_counter() - t0:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {name: dict(launches=counts[name],
                       **{k: rows[name][k] for k in keys})
            for name in SCAN_KERNELS}


def scan_readings(card: str) -> None:
    """``--scan``: phase 10's full-width readings alone, on the package
    this script was pointed at (``--src``): B12 and B13 in bf16 and f32,
    each against its plain version, timed beside the bounds.  Two
    checkouts' kernels compared by one script; a package whose B12 / B13
    have one path each (before the tensor-core paths) is taken as it
    is."""
    from repro_torch.kernels import ssd_scan as ssd_mod

    for dtype in (torch.bfloat16, torch.float32):
        scan_full_width(dtype, card, timed=True, plain_time=False,
                        tag="[scan]",
                        paths_known=hasattr(ssd_mod, "launch_geometry"))
        torch.cuda.empty_cache()


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
#: phase 11's depth in the whole script (zamba2: two shared_attention
#: positions), so that the script keeps within its time limit with phase
#: 13; ``--decode`` / ``--admit`` serve the full depth
ZOO_SERVE_LAYERS = {"zamba2-1.2b": 12, "rwkv6-1.6b": 4}
#: the tokens a request takes through phase 11's eager offloaded engine,
#: held against the captured one's first (the eager engine's host-bound
#: steps are the phase's longest part)
ZOO_EAGER_TOKENS = 16


def capture_logits(engine):
    """Wrap the engine's static-function runner and its decode step so
    that every admit's and every decode step's logits are kept (read from
    the fixed buffers the graphs write: a replay's too), with the slot ->
    request map of the step.  Returns the two lists and ``restore()``,
    which unwraps both."""
    prefills, steps = [], []
    run_static, run = engine._run_static, engine._run_decode_step

    def admit_or_control(key, fn, counter, **kw):
        run_static(key, fn, counter, **kw)
        if key[0] == "admit":
            prefills.append(engine._prefill_logits[0].float().clone())

    def decode():
        rid, active = engine._slot_rid.copy(), engine._state["active"].clone()
        run()
        steps.append((engine._logits.float().clone(), rid, active))

    def restore():
        # drops the cycle engine -> capture -> engine
        del engine._run_static, engine._run_decode_step

    engine._run_static = admit_or_control
    engine._run_decode_step = decode
    return prefills, steps, restore


def request_logits(prefills: list, steps: list, reqs) -> dict:
    """Each request's logits (``capture_logits``' lists; the requests
    admitted in their order), one row a token it emitted: its prompt's
    last, then its decode steps' while its slot was active."""
    out = {}
    for i, r in enumerate(reqs):
        out[r.rid] = [prefills[i]] + [
            lg[list(rid).index(r.rid)] for lg, rid, act in steps
            if r.rid in rid and bool(act[list(rid).index(r.rid)])]
    return out


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
    check(engine._graph is not None, f"{label}: decode step not captured")
    bf16 = engine.model.dtype == torch.bfloat16
    if bf16:
        f32_model = build_model(dataclasses.replace(cfg, dtype="float32"),
                                device="cuda")
        f32_params = cast_params(engine.params, torch.float32)
    stats, failed = {}, []
    per_request = request_logits(prefills, steps, reqs)
    for r in reqs:
        toks = done[r.rid].tokens
        check(len(toks) == new_tokens, f"{label} request {r.rid} short")
        got = torch.stack(per_request[r.rid][:new_tokens])
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


def zoo_offload(cfg, params, lens, plain: dict, tag: str = "[11]") -> None:
    """``Engine(offload=True)`` of a zamba2 / rwkv6 build, served as phase
    6 serves qwen3's: the decode step captured and planned once
    (seconds printed) and verified, zamba2's through the wrapper
    (``MPU_VERIFY_PLANS``); its CUDA translation unit built; every
    distinct segment of the plan against its plain version (each
    anchored one's path printed: the weight stream, or the FMA template
    where an operand is f32); the mix served captured (one plan, the
    launches a step the plan's) and, ``ZOO_EAGER_TOKENS`` a request,
    eagerly (the captured engine's first tokens); the captured engine's
    tokens against the plain engine's (``plain``), a differing token
    only as a tie of its logits (``only_ties``); the captured offloaded
    step's readings, and one step's logits and recurrent state against
    the plain model's (``offload_vs_eager``); the launchers' shared
    memory against the verifier's."""
    from repro_torch.core.offload import _matmul_gen

    label = f"{cfg.name} offload=True"
    wrapper = cfg.name == "zamba2-1.2b"
    prev = os.environ.get("MPU_VERIFY_PLANS")
    if wrapper:
        os.environ["MPU_VERIFY_PLANS"] = "1"
    try:
        off = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                     page_size=64, offload=True)
    finally:
        if prev is None:
            os.environ.pop("MPU_VERIFY_PLANS", None)
        else:
            os.environ["MPU_VERIFY_PLANS"] = prev
    t0 = time.perf_counter()
    plan = off.prepare_decode()
    st = off.offload_stats
    t1 = time.perf_counter()
    if plan.library:
        fm.finish_library(fm.start_library(plan.library))
    print(f"{tag} {label}: decode step captured in {st['capture_s']:.1f} s "
          f"and planned in {st['plan_s']:.1f} s ({t1 - t0:.1f} s), its CUDA "
          f"translation unit ({len(plan.library)} anchored segments) built "
          f"in {time.perf_counter() - t1:.1f} s; plans verified through the "
          f"wrapper (MPU_VERIFY_PLANS): "
          f"{off._decode_offload.verify_plans}")
    check(off._decode_offload.verify_plans == wrapper,
          f"{label}: MPU_VERIFY_PLANS not read by the wrapper")
    verify_plans(f"{label} decode", [plan], tag)
    rows = check_decode_segments({f"{cfg.name} bf16": plan}, tag,
                                 pinned=None)
    paths: dict = {}
    for (_, sym), (call, count, _) in rows.items():
        if call["kind"] == "matmul":
            path = gemm_path(_matmul_gen(call))
            paths[path] = paths.get(path, 0) + count
    n_grid = sum(seg.matmul is None for seg in plan.segments)
    n_mm = len(plan.segments) - n_grid
    print(f"{tag} {label}: B3 launches a decode step by path {paths} (the "
          f"weight stream takes bf16 x bf16 products, the FMA template any "
          f"with an f32 operand), B2 {n_grid} a step")
    eager = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                   page_size=64, offload=True, capture_decode=False)
    reqs = make_requests(cfg, lens, 64, 1)
    prefills, kept, restore = capture_logits(off)
    counts, done, _ = serve(off, reqs, f"{label} captured", tag)
    restore()
    check_captured(off, label, tag)
    check_admits(off, lens, label, tag)
    want = serve_eager(eager, make_requests(cfg, lens, ZOO_EAGER_TOKENS, 1),
                       label, tag)
    same_tokens({r: dataclasses.replace(c, tokens=c.tokens[:ZOO_EAGER_TOKENS])
                 for r, c in done.items()}, want,
                f"{label} captured vs eager (the first {ZOO_EAGER_TOKENS} "
                "tokens)", tag)
    steps = counts["decode_steps"]
    st = off.offload_stats
    print(f"{tag} {label}: launches in pass 1 "
          f"{ {k: v for k, v in counts.items() if v} }, offload_stats {st}")
    check(st["plan_misses"] == st["traces"] == 1 and st["plan_hits"] == 0,
          f"{label}: offload_stats {st}")
    check(counts["fused_segment_grid"] == steps * n_grid,
          f"{label}: grid launches != steps x {n_grid}")
    check(counts["fused_matmul_segment"] == steps * n_mm,
          f"{label}: anchored launches != steps x {n_mm}")
    only_ties(done, plain, request_logits(prefills, kept, reqs), label,
              "the plain engine", tag)
    del prefills, kept
    offload_vs_eager(off, f"{cfg.name} bf16", OFFLOAD_LOGIT_TOL,
                     OFFLOAD_LOGIT_MEAN_TOL, eager=eager, tag=tag)
    check_launched_smem([plan], tag)
    del off, eager


def phase_zoo(card: str) -> None:
    """Phase 11: zamba2-1.2b and rwkv6-1.6b at full width, cut to
    ``ZOO_SERVE_LAYERS``, random bf16 weights from seed 0, served through
    the paged Engine as phase 4 serves qwen3; a decode step profiled
    mid-flight; the engine's logits against full-sequence forwards (bf16,
    and f32 at ``ZOO_F32_LAYERS``).  ``--decode`` and ``--admit`` serve
    the full depth."""
    t0 = time.perf_counter()
    for arch in ZOO_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=ZOO_SERVE_LAYERS[arch])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gib = 2.0 ** 30
        before = torch.cuda.memory_allocated() / gib
        model = build_model(cfg, device="cuda")
        params = cast_params(model.init(0), model.dtype)
        n_params = sum({id(t): t.numel() for t in _leaves(params)}.values())
        kinds = layer_kinds(cfg)
        print(f"[11] {arch} full width, cut to {cfg.num_layers} layers "
              f"({ {k: kinds.count(k) for k in dict.fromkeys(kinds)} }), "
              f"d_model {cfg.d_model}, {n_params / 1e9:.2f} B parameters "
              f"in {model.dtype} (tied ones once); device memory "
              f"{before:.2f} GiB before, {torch.cuda.memory_allocated() / gib:.2f} "
              f"GiB with the bf16 weights, peak {torch.cuda.max_memory_allocated() / gib:.2f} "
              f"GiB while the f32 masters were cast")
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                        page_size=64)
        eager = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                       page_size=64, capture_decode=False)
        lens = np.random.default_rng(0).integers(16, 701, size=12)
        lens[0], lens[1] = 16, 700
        counts, plain = serve_twice(engine, eager, cfg, lens, 64, 1, arch,
                                    "[11]")
        launches = counts["paged_decode_attention"]
        n_attn = attention_layers(cfg)
        print(f"[11] {arch}: B1 launched {launches} times, "
              f"{n_attn} a decode step (its attention layers)")
        phase_full_width_check(engine, eager, arch, tag="[11]")
        print(f"[11] {arch} serving peak device memory "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (weights, "
              f"caches, prefill of 700 tokens, 8-slot decode)")
        del engine, eager
        zoo_offload(cfg, params, lens, plain)
        print(f"[11] {arch} peak device memory with the offloaded engine "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB")
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


#: the serving engines of the ``--decode`` / ``--admit`` readings
ENGINES = (("qwen3-1.7b", False), ("qwen3-1.7b", True),
           ("zamba2-1.2b", False), ("zamba2-1.2b", True),
           ("rwkv6-1.6b", False), ("rwkv6-1.6b", True))


def serving_weights(arch: str, held: dict) -> tuple:
    """The config and full-width bf16 serving weights of ``arch`` (seed
    0), kept in ``held`` for the next engine of the same arch; another
    arch's are dropped first."""
    cfg = get_config(arch)
    if arch not in held:
        held.clear()
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(cfg, device="cuda")
        held[arch] = cast_params(model.init(0), model.dtype)
    return cfg, held[arch]


# --- phase 12: durability and injected faults -------------------------------

#: steps of the durability runs and their checkpoint cadence: process A
#: trains steps 0-3 (checkpoints at 2 and 3), process B resumes at 3
DUR_STEPS, DUR_EVERY = 4, 2
#: the depth the durability runs train qwen3-1.7b at (full width): three
#: checkpoints of the full 28-layer state (24.4 GB each) exceed what one
#: call of the machine with the card may write to its disk (45 GiB, freed
#: blocks included); at 4 layers a checkpoint is ~9.9 GB.  The engines
#: serve the full depth
DUR_LAYERS = 4
#: the engine's requests in the durability and fault runs (prompt lengths)
DUR_LENS = (16, 200, 64, 500, 33, 700, 128, 300)
DUR_NEW_TOKENS = 16
#: the marker of a durability child's result line
DUR_MARK = "DURABILITY "


class RssPeak:
    """The process's peak resident set while the block runs, sampled
    from ``/proc/self/status`` every 5 ms (bytes; 0 where it cannot be
    read)."""

    def __enter__(self):
        import threading

        self.start = self.peak = self.now()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self.now())

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self.now())

    @staticmethod
    def now() -> int:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            pass
        return 0


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def engine_run(engine, reqs) -> tuple[dict, list]:
    """Serve ``reqs`` to the end, keeping every decode step's logits."""
    _, steps, restore = capture_logits(engine)
    try:
        done = engine.generate(reqs)
    finally:
        restore()
    return done, steps


def logit_agreement(steps_a: list, steps_b: list) -> tuple[float, int]:
    """The largest logit difference of two engines' decode steps over the
    steps before their greedy tokens first part (later steps decode other
    histories), and how many steps were compared."""
    worst, n = 0.0, 0
    for (la, ra, aa), (lb, rb, ab) in zip(steps_a, steps_b):
        if not (np.array_equal(ra, rb) and torch.equal(aa, ab)):
            break
        rows = aa.nonzero()[:, 0]
        worst = max(worst, max_err(la[rows], lb[rows]))
        n += 1
        if not torch.equal(la[rows].argmax(-1), lb[rows].argmax(-1)):
            break
    return worst, n


def injected_faults(cfg, params, unfaulted: dict, unfaulted_steps) -> dict:
    """The offloaded engine with every grid-segment launch faulted (bursts
    of 3, the guard's threshold): the first decode step's warm call
    demotes three launches to the plain version and quarantines
    ``fused_segment_grid``; the next step sees the epoch change, plans
    all_far and captures again (``kernel_replans``).  Returns what the
    parent checks and prints."""
    from repro_torch.serve import FaultConfig, FaultInjector

    inj = FaultInjector(FaultConfig(kernel_fail_rate=1.0, kernel_fail_burst=3,
                                    kernel_targets=("fused_segment_grid",)))
    guard = kernel_guard()
    epoch0 = guard.epoch
    eng = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                 page_size=64, offload=True, fault_injector=inj)
    t0 = time.perf_counter()
    done, steps = engine_run(eng, make_requests(cfg, DUR_LENS,
                                                DUR_NEW_TOKENS, seed=5))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    recaptured = [c[0] for c in eng._graph.launches.calls]
    same = total = 0
    for rid, c in done.items():
        want = unfaulted[rid]
        total += len(want)
        same += sum(a == b for a, b in zip(c.tokens, want))
    worst, n = logit_agreement(unfaulted_steps, steps)
    out = dict(statuses=sorted({c.status for c in done.values()}),
               guard=guard.stats(), epoch_moved=guard.epoch - epoch0,
               health=guard.health(), injector=dict(inj.counters),
               serve={k: eng.serve_counters[k] for k in
                      ("kernel_replans", "step_traces")},
               offload=eng.offload_stats,
               recaptured={k: recaptured.count(k) for k in set(recaptured)},
               same_tokens=same, tokens=total, max_logit_diff=worst,
               compared_steps=n, seconds=seconds)
    from repro_torch.core.artifacts import set_disk_injector

    guard.injector = None
    set_disk_injector(None)
    guard.reset()
    del eng
    return out


def durability_child(role: str, root: str) -> dict:
    """One process of phase 12 (run by ``phase_durability`` as
    ``chip_smoke.py --durability-child ROLE ROOT``, with ``MPU_PLAN_CACHE``
    set): ``train()`` of full-width qwen3-1.7b (offloaded, compiled,
    2 x 1,024 tokens) to step 3 with checkpoints every 2 steps under
    ROOT/ckpt — A from an empty checkpoint directory and plan store, B
    resuming — then an offloaded ``Engine`` on the same store (and, in B,
    the injected-fault engine).  Returns its readings."""
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core.offload import bwd_plan_stats
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.train import loop as loop_mod
    from repro_torch.train import train

    cfg = get_config("qwen3-1.7b")
    tcfg_model = dataclasses.replace(cfg, num_layers=DUR_LAYERS)
    ckpt_dir = os.path.join(root, "ckpt")
    out: dict = {"role": role, "save": [], "verify": [], "restore": []}
    clock = [time.perf_counter()]

    def timed(name, fn):
        def call(directory, step, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with RssPeak() as rss:
                res = fn(directory, step, *a, **kw)
            torch.cuda.synchronize()
            out[name].append(dict(
                step=step, s=time.perf_counter() - t0, peak_rss=rss.peak,
                start_rss=rss.start,
                bytes=dir_bytes(os.path.join(directory, f"step_{step}"))))
            clock[0] = time.perf_counter()
            return res
        return call

    init = loop_mod.init_train_state

    def timed_init(model, seed):
        state = init(model, seed)
        torch.cuda.synchronize()
        clock[0] = time.perf_counter()
        return state

    ckpt_mod.save = timed("save", ckpt_mod.save)
    ckpt_mod.restore = timed("restore", ckpt_mod.restore)
    ckpt_mod.verify_step = timed("verify", ckpt_mod.verify_step)
    loop_mod.init_train_state = timed_init
    steps, held = [], []

    def on_metrics(step, m):
        now = time.perf_counter()
        steps.append(dict(step=step, s=now - clock[0],
                          **{k: m[k] for k in ("loss", "grad_norm", "lr")}))
        clock[0] = now

    tcfg = TrainConfig(remat=False, offload=True, total_steps=DUR_STEPS,
                       checkpoint_every=DUR_EVERY, checkpoint_dir=ckpt_dir)
    shape = ShapeConfig("chip", *TRAIN_SHAPE)

    def plan_ahead(step):
        """What phase 7's ``plan_training`` does before the first step:
        the loss, every segment's backward and the update planned on a
        throwaway state of the step's shapes, and every CUDA translation
        unit built together, so that the planning seconds read apart from
        the first step's."""
        from repro_torch.train.step import device_batch, init_train_state

        held.append(step)
        t0 = time.perf_counter()
        st = init_train_state(step.model, 0)
        db = device_batch(SyntheticLM(make_data_config(
            tcfg_model, shape, tcfg.seed)).batch(0), "cuda")
        plans = [step.loss_fn.warm(st.params, db),
                 *step.loss_fn.warm_backward(st.params, db),
                 step.update_fn.warm(*update_args(st))]
        t1 = time.perf_counter()
        units = sorted({tuple(p.library) for p in plans if p.library})
        for h in [fm.start_library(u) for u in units]:
            fm.finish_library(h)
        del st, db
        torch.cuda.empty_cache()
        out["plan_ahead"] = dict(plan_s=t1 - t0,
                                 build_s=time.perf_counter() - t1,
                                 plans=len(plans), units=len(units))
        clock[0] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    state, _ = train(tcfg_model, shape, tcfg, device="cuda", log_every=0,
                     on_metrics=on_metrics, on_step=plan_ahead)
    torch.cuda.synchronize()
    step, graph = held[0], held[0].graph
    out.update(
        steps=steps, peak_device=torch.cuda.max_memory_allocated(),
        plans={"loss": step.stats.as_dict(),
               "update": step.update_stats.as_dict(),
               "bwd": bwd_plan_stats().as_dict()},
        graph=dict(seconds=graph.seconds, warm_seconds=graph.warm_seconds),
        sums=json.loads(open(os.path.join(
            ckpt_dir, f"step_{DUR_STEPS - 1}", "shard_0.sums.json")).read()
        )["tensors"])
    del state, step, graph, held
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda")
    params = cast_params(model.init(0), model.dtype)
    del model
    eng = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                 page_size=64, offload=True)
    t0 = time.perf_counter()
    done, dsteps = engine_run(eng, make_requests(cfg, DUR_LENS,
                                                 DUR_NEW_TOKENS, seed=5))
    torch.cuda.synchronize()
    tokens = {rid: c.tokens for rid, c in done.items()}
    out["engine"] = dict(tokens=tokens, offload=eng.offload_stats,
                         seconds=time.perf_counter() - t0,
                         statuses=sorted({c.status for c in done.values()}))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if role == "B":
        out["faults"] = injected_faults(cfg, params, tokens, dsteps)
    return out


def durability_run(role: str, root: str, env: dict) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--durability-child",
           role, root, "--src", _src_root()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(DUR_MARK)]
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-16000:], file=sys.stderr)
    check(proc.returncode == 0 and bool(lines),
          f"durability process {role} exited {proc.returncode} (its "
          "standard error above)")
    res = json.loads(lines[-1][len(DUR_MARK):])
    res["process_s"] = time.perf_counter() - t0
    return res


def gbps(r: dict) -> str:
    return (f"{r['s']:.1f} s, {r['bytes'] / 1e9:.2f} GB, "
            f"{r['bytes'] / r['s'] / 1e9:.2f} GB/s")


def print_durability(r: dict, card: str) -> None:
    first = r["steps"][0]
    pl, pa = r["plans"], r["plan_ahead"]
    print(f"[12] process {r['role']}: the loss, {pa['plans'] - 2} backward "
          f"plans and the update planned ahead in {pa['plan_s']:.1f} s, "
          f"{pa['units']} CUDA translation units built in "
          f"{pa['build_s']:.1f} s; card {card}")
    print(f"[12] process {r['role']}: steps "
          f"{[s['step'] for s in r['steps']]}, first step (step "
          f"{first['step']}) {first['s']:.1f} s (warm call "
          f"{r['graph']['warm_seconds']:.1f} + capture "
          f"{r['graph']['seconds'] - r['graph']['warm_seconds']:.1f}); "
          f"loss capture_s {pl['loss']['capture_s']:.1f} / plan_s "
          f"{pl['loss']['plan_s']:.1f}, backward plans capture_s "
          f"{pl['bwd']['capture_s']:.1f} / plan_s {pl['bwd']['plan_s']:.1f}"
          f", update capture_s {pl['update']['capture_s']:.1f} / plan_s "
          f"{pl['update']['plan_s']:.1f}; process {r['process_s']:.1f} s; "
          f"card {card}")
    for k in ("loss", "update", "bwd"):
        st = pl[k]
        print(f"[12] process {r['role']} {k} plans: plan_misses "
              f"{st['plan_misses']}, plan_hits {st['plan_hits']}, traces "
              f"{st['traces']}, disk_hits {st['disk_hits']}, disk_misses "
              f"{st['disk_misses']}, disk_corrupt {st['disk_corrupt']}")
    for name in ("save", "verify", "restore"):
        for x in r[name]:
            print(f"[12] process {r['role']} {name} step {x['step']}: "
                  f"{gbps(x)}, peak host RSS {x['peak_rss'] / 2**30:.2f} "
                  f"GiB ({x['start_rss'] / 2**30:.2f} at its start); card "
                  f"{card}")
    print(f"[12] process {r['role']}: peak device memory "
          f"{r['peak_device'] / 2**30:.2f} GiB; engine "
          f"{r['engine']['seconds']:.1f} s, decode plan "
          f"{r['engine']['offload']}")


def phase_durability(card: str, beside: str = "") -> None:
    """Phase 12: checkpoints and restart, the persistent plan store, and
    injected faults, at full width (training cut to ``DUR_LAYERS``
    layers).  Process A trains steps 0-3 with
    checkpoints every 2 steps from an empty plan store; step 3's
    checkpoint is then torn (renamed to ``step_3.tmp``, its shard cut);
    a fresh process B restores step 2 and trains step 3, bit-equal to A
    (metrics and every leaf's sha256), with every plan a disk hit.  Both
    then serve the same requests through an offloaded engine on the same
    store (B's decode plan a disk hit, the same greedy tokens), and B
    serves them once more with every grid-segment launch faulted."""
    import tempfile

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              num_layers=DUR_LAYERS)
    state_bytes = 12 * cfg.param_count()
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_durability_")
    try:
        free = shutil.disk_usage(root).free
        need = 2 * state_bytes + (4 << 30)
        print(f"[12] durability under {root}: {free / 2**30:.1f} GiB free, "
              f"the training state of qwen3-1.7b at full width and "
              f"{DUR_LAYERS} layers {state_bytes / 2**30:.1f} GiB"
              + (f"; its seconds are taken beside {beside}" if beside
                 else ""))
        check(free >= need,
              f"durability: {free / 2**30:.1f} GiB free under {root}; the "
              f"phase keeps two checkpoints of the {state_bytes / 2**30:.1f}"
              f" GiB training state and needs {need / 2**30:.1f} GiB (set "
              "TMPDIR to a larger disk)")
        env = {**os.environ, "MPU_PLAN_CACHE": os.path.join(root, "plans")}
        a = durability_run("A", root, env)
        print_durability(a, card)
        last = DUR_STEPS - 1
        ckpt = os.path.join(root, "ckpt")
        check(sorted(os.listdir(ckpt)) == [f"step_{DUR_EVERY}",
                                           f"step_{last}"],
              f"process A left {sorted(os.listdir(ckpt))}")
        torn = os.path.join(ckpt, f"step_{last}.tmp")
        os.rename(os.path.join(ckpt, f"step_{last}"), torn)
        with open(os.path.join(torn, "shard_0.npz"), "r+b") as f:
            f.truncate(1 << 20)
        b = durability_run("B", root, env)
        print_durability(b, card)
        check([s["step"] for s in b["steps"]] == [last],
              f"process B ran steps {[s['step'] for s in b['steps']]}, "
              f"not step {last} alone")
        check(len(b["restore"]) == 1 and b["restore"][0]["step"] == DUR_EVERY,
              f"process B restored {b['restore']}")
        keys = ("loss", "grad_norm", "lr")
        sa = {k: a["steps"][-1][k] for k in keys}
        sb = {k: b["steps"][-1][k] for k in keys}
        check(sa == sb, f"step {last} metrics differ: A {sa}, B {sb}")
        differ = [k for k in a["sums"] if a["sums"][k] != b["sums"].get(k)]
        check(a["sums"].keys() == b["sums"].keys() and not differ,
              f"step {last} leaves differ between A and B: {differ[:5]}")
        for k in ("loss", "update", "bwd"):
            st = b["plans"][k]
            check(st["plan_misses"] == 0 and st["disk_hits"] == st["traces"]
                  and st["disk_hits"] > 0,
                  f"process B {k} plans not all disk hits: {st}")
        print(f"[12] resume: process B's step {last} bit-equal to process "
              f"A's ({sb}; {len(b['sums'])} leaves, sha256 each), every "
              "loss / update / backward plan a disk hit; planning A "
              f"{a['plan_ahead']['plan_s']:.1f} s, B "
              f"{b['plan_ahead']['plan_s']:.1f} s; first step A "
              f"{a['steps'][0]['s']:.1f} s, B {b['steps'][0]['s']:.1f} s")
        ea, eb = a["engine"], b["engine"]
        check(ea["statuses"] == eb["statuses"] == ["ok"],
              f"engine statuses {ea['statuses']}, {eb['statuses']}")
        check(eb["offload"]["plan_misses"] == 0
              and eb["offload"]["disk_hits"] == 1,
              f"warm engine's decode plan not a disk hit: {eb['offload']}")
        check(ea["tokens"] == eb["tokens"],
              "the warm engine's greedy tokens differ from the cold one's")
        print(f"[12] engine warm restart: decode plan a disk hit "
              f"(plan_misses 0), greedy tokens of {len(eb['tokens'])} "
              f"requests identical to the cold engine's; cold "
              f"{ea['seconds']:.1f} s, warm {eb['seconds']:.1f} s")
        f = b["faults"]
        check(f["guard"]["quarantines"] == 1 and f["epoch_moved"] >= 1,
              f"no quarantine: guard {f['guard']}")
        check(f["serve"]["kernel_replans"] == 1,
              f"kernel_replans {f['serve']['kernel_replans']}, not 1")
        check(f["recaptured"].get("fused_segment_grid", 0) == 0,
              f"the re-captured step launches B2: {f['recaptured']}")
        check(f["statuses"] == ["ok"], f"faulted statuses {f['statuses']}")
        print(f"[12] injected faults (fused_segment_grid, rate 1, bursts of "
              f"3): guard {f['guard']}, health {f['health']}, injector "
              f"{f['injector']}, {f['serve']}, decode plans "
              f"{f['offload']}; the re-captured step launches "
              f"{f['recaptured']}; every request ok; "
              f"{f['same_tokens']}/{f['tokens']} tokens "
              f"({f['same_tokens'] / max(f['tokens'], 1):.1%}) match the "
              f"unfaulted engine's, largest logit difference "
              f"{f['max_logit_diff']:.4f} over {f['compared_steps']} decode "
              f"steps; {f['seconds']:.1f} s; card {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- phase 13: zamba2-1.2b and rwkv6-1.6b trained; queue C5's check -------

#: the fresh-process training runs of queue C5's check: full-width
#: qwen3-1.7b at these depths, 2 eager then 2 compiled steps each
C5_LAYERS = (4, 28)
#: the models phase 13 trains at full width and depth: the layers of
#: their f32 numerics build (zamba2 needs 12 for two shared_attention
#: positions) and ``remat`` (on where the step's peak with it off would
#: not fit in the card's 80 GB: PERF.md section 4)
ZOO_TRAIN = {"zamba2-1.2b": (12, False), "rwkv6-1.6b": (2, True)}
#: the models whose phase 13 process also takes the plain eager step in
#: f32 at the process's depth (``plain_f32_steps``): rwkv6's grad norm
#: at full depth grows
#: 1,796 -> 1,136 -> 1,155,378 over the offloaded bf16 steps (PR 28)
F32_STEPS = ("rwkv6-1.6b",)
TRAIN_MARK = "TRAIN_CHILD "
#: the seconds a training process may take, waiting included
CHILD_TIMEOUT = 900
#: the card's free memory (GiB) that a process started beside other work
#: needs: zamba2-1.2b's first eager step (36.9 GiB allocated at its peak)
#: beside phase 12's processes (21.7), and the 4-layer C5 process (21.8)
#: beside zamba2's segment checks and f32 build (PR 28's readings), each
#: with room for the caching allocator's slack
BESIDE_GIB = {"phase 12": 66.0, "zamba2 checks": 48.0}
#: phase 13 in the whole script: rwkv6-1.6b cut to 4 layers (its step
#: peaks at 18.4 GiB on an H100), started beside zamba2's checks and the
#: 4-layer C5 process where the card has this much free beyond
#: ``BESIDE_GIB["zamba2 checks"]``; queue C5's check at 4 layers alone.
#: The full depths (rwkv6's 24 layers, the 28-layer C5 process) run under
#: ``--zoo-train``: with them the whole script took 920-1,338 s on an
#: H100 80GB HBM3 at 700 W, over its 1,200 s limit on the slower hosts
WHOLE_RWKV6_LAYERS = 4
BESIDE_RWKV6_GIB = 22.0
#: the card's memory (GiB) outside this process's allocator that a
#: process started alone tolerates: the CUDA contexts
OTHERS_GIB = 2.0


def fresh_train(arch: str, layers: int, steps: int, full: bool,
                tag: str, remat: bool = False, two_units: bool = False,
                hold: str | None = None, signal: str | None = None) -> dict:
    """One fresh process's training run (``chip_smoke.py --train-child``):
    full-width ``arch`` at ``layers`` (0: its full depth), f32 masters,
    bf16 compute, ``TrainConfig(remat=remat, offload=True)``, 2 x 1,024
    tokens a step — ``steps`` eager steps of ``make_train_step`` as the
    first thing the process does, nothing planned or built ahead, then
    ``steps`` steps of ``compile_train_step`` from the same seed-0 state
    held against them (``train_compiled``; the compiled step looks its
    plans up in the eager step's wrappers).  With ``two_units``: one
    dlhs segment launched through a second unit as well
    (``shared_segment_check``).  With ``full``: the plans' node and
    segment counts, every distinct segment of the loss, its backward and
    the update against its plain version, and the f32 build of
    ``ZOO_TRAIN`` layers (remat off, planned and built ahead), offloaded
    against the plain eager step.  ``hold``: a file whose existence the
    process waits for after its first eager step (what shared the card
    with it until then is gone before its timed steps); ``signal``: a
    file it writes once its timed steps are over and their memory given
    back (what comes next may share the card).
    Returns its readings."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core.offload import bwd_plan_stats
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.models.transformer import Ties
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import device_batch

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    label = f"{arch} at {cfg.num_layers} layers" + ", remat" * remat
    tcfg = TrainConfig(remat=remat, offload=True)
    model = build_model(cfg, device=DEVICE)
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip",
                                                         *TRAIN_SHAPE)))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    step = make_train_step(model, tcfg)
    state = init_train_state(model, 0)
    n_params = sum(t.numel() for t in Ties(state.params).unique(state.params))
    ops.reset_launch_counts()
    eager = dict(times=[], losses=[], gnorms=[], lrs=[], per_step=[])
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        before, copies = ops.launch_counts(), sum(fe.COPIES.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch(i))
        torch.cuda.synchronize()
        eager["times"].append(time.perf_counter() - t0)
        after = ops.launch_counts()
        eager["per_step"].append({k: after[k] - before[k] for k in after
                                  if after[k] - before[k]})
        eager["per_step"][-1]["grid operand copies"] = \
            sum(fe.COPIES.values()) - copies
        for k, key in (("losses", "loss"), ("gnorms", "grad_norm"),
                       ("lrs", "lr")):
            eager[k].append(float(m[key]))
        check(np.isfinite(eager["losses"][-1]) and
              np.isfinite(eager["gnorms"][-1]), f"{label}: non-finite step")
        if i == 0 and hold is not None:
            t_hold = time.perf_counter()
            while not os.path.exists(hold):
                check(time.perf_counter() - t_hold < CHILD_TIMEOUT,
                      f"{label}: not released after its first step")
                time.sleep(0.2)
            eager["held_s"] = time.perf_counter() - t_hold
    eager["step_ms"] = sum(eager["times"][1:]) / (steps - 1) * 1e3
    eager["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    lst, bst = step.stats, bwd_plan_stats()
    gen = [n for n in _build.BUILD_SECONDS if n.startswith("gen-")]
    first = dict(seconds=eager["times"][0],
                 capture_s=lst.capture_s + bst.capture_s,
                 plan_s=lst.plan_s + bst.plan_s,
                 build_s=sum(_build.BUILD_SECONDS[n] for n in gen),
                 units=len(gen), bwd_plans=bst.traces)
    print(f"{tag} {label} ({n_params / 1e9:.3f} B parameters), the "
          f"process's first {steps} eager steps, nothing planned ahead: "
          f"{[round(t, 3) for t in eager['times']]} s by the host clock; "
          f"the first: loss and backward capture {first['capture_s']:.1f} s,"
          f" plan {first['plan_s']:.1f} s ({first['bwd_plans']} backward "
          f"plans), {first['units']} CUDA translation units built at their "
          f"first launch in {first['build_s']:.1f} s; losses "
          f"{eager['losses']}, grad norms {eager['gnorms']}; peak "
          f"{eager['peak']:.2f} GiB; launches a step {eager['per_step'][-1]}")
    out = dict(arch=arch, layers=cfg.num_layers, params=n_params,
               remat=remat, first=first, eager=eager)
    plans = None
    if two_units:
        dbatch = device_batch(data.batch(0), DEVICE)
        shared_segment_check(step.loss_fn.backward_plans_for(state.params,
                                                             dbatch), tag)
        del dbatch
    if full:
        dbatch = device_batch(data.batch(0), DEVICE)
        fplan = step.loss_fn.plan_for(state.params, dbatch)
        bplans = step.loss_fn.backward_plans_for(state.params, dbatch)
        uplan = step.update_fn.plan_for(*update_args(state))
        plans = [fplan, *bplans, uplan]
        out["plans"] = dict(
            forward=(len(fplan.eqns), len(fplan.segments)),
            backward=(len(bplans), sum(len(p.eqns) for p in bplans),
                      sum(len(p.segments) for p in bplans)),
            update=(len(uplan.eqns), len(uplan.segments)))
        print(f"{tag} {label} plans (nodes, segments): forward "
              f"{out['plans']['forward']}, {len(bplans)} backward plans "
              f"{out['plans']['backward'][1:]}, update "
              f"{out['plans']['update']}")
        del dbatch
    # the eager steps' final state, to hold the compiled steps' against:
    # the zoo's kept on the device (both states fit), queue C5's check
    # compares the metrics alone.  The compiled steps look their plans up
    # in the eager step's wrappers (planned once in the process)
    host = [t.detach() for t in state_leaves(state)] if full else None
    plans_of = step
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    out["compiled"] = train_compiled(model, tcfg, data, tokens, eager, host,
                                     label, tag=tag, steps=steps,
                                     plans_of=plans_of, profile=False)
    check(out["compiled"]["bit_equal"],
          f"{label}: the compiled steps are not bit-equal to the eager ones")
    if not full:
        print(f"{tag} {label}: compiled steps' losses, grad norms and lr "
              f"bit-equal to the eager steps'")
    del host, plans_of
    gc.collect()
    torch.cuda.empty_cache()
    if signal is not None:
        open(signal, "w").close()
    if not full:
        return out
    out["segments"] = len(train_segments(plans))
    check_train_segments(plans, torch.bfloat16, "", timed=False, tag=tag)
    out["verified"] = verify_plans(f"{label} training plans", plans, tag)
    out["smem_checked"] = check_launched_smem(plans, tag)
    del plans, model
    gc.collect()
    torch.cuda.empty_cache()
    layers32 = ZOO_TRAIN[arch][0]
    cfg32 = dataclasses.replace(get_config(arch), num_layers=layers32,
                                dtype="float32")
    tcfg = dataclasses.replace(tcfg, remat=False)
    model32 = build_model(cfg32, device=DEVICE)
    state32 = init_train_state(model32, 0)
    step32 = make_train_step(model32, tcfg)
    host_batch32 = SyntheticLM(make_data_config(cfg32, ShapeConfig(
        "chip", *TRAIN_SHAPE))).batch(0)
    batch32 = device_batch(host_batch32, DEVICE)
    label32 = f"f32 {layers32}-layer {arch}"
    # planned and built ahead, together, as phase 7 builds its f32 step
    plan_training(step32, state32, host_batch32, label32, tag=tag,
                  copied_bmm=False)
    train_numerics(model32, step32, state32, batch32, tcfg,
                   f"{label32} offloaded vs plain", f32=True, tag=tag)
    if arch in F32_STEPS:
        del model32, state32, step32, batch32
        gc.collect()
        torch.cuda.empty_cache()
        out["f32_gnorms"] = plain_f32_steps(arch, layers, steps, remat,
                                            eager, tag)
    return out


def plain_f32_steps(arch: str, layers: int, steps: int, remat: bool,
                    eager: dict, tag: str) -> list[float]:
    """``steps`` steps of the plain eager step (no offload) in f32 at full
    width and ``layers`` (0: the full depth) from the seed-0 state, on
    phase 13's batches: their grad norms beside the offloaded bf16 steps'
    (``eager``), to tell what the model does from what the port's
    offloaded bf16 path does."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.train import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, device=DEVICE)
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip",
                                                         *TRAIN_SHAPE)))
    step = make_train_step(model, TrainConfig(remat=remat, offload=False))
    state, out, losses = init_train_state(model, 0), [], []
    for i in range(steps):
        state, m = step(state, data.batch(i))
        out.append(float(m["grad_norm"]))
        losses.append(float(m["loss"]))
    print(f"{tag} {arch} at {cfg.num_layers} layers: the plain eager step "
          f"in f32 (no offload, remat "
          f"{'on' if remat else 'off'}), {steps} steps from the seed-0 "
          f"state: losses {losses}, grad norms {out}; the offloaded bf16 "
          f"steps: losses {eager['losses']}, grad norms {eager['gnorms']}")
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shared_segment_check(plans, tag: str) -> None:
    """Queue C5's cause, directly: a bf16 dlhs segment that its plan's
    unit already launched, instantiated again in a translation unit of its
    own and launched through it in the same process — before
    ``-fno-gnu-unique`` the second unit's launcher found the first's
    once-only guard set and launched its own kernel without the
    shared-memory attribute (refused: ``invalid argument``).  Both
    launches must run and agree bit for bit."""
    from repro_torch.core.offload import (
        _matmul_gen,
        _segment_kernel,
        segment_call,
        segment_programs,
    )

    for plan in plans:
        for seg in plan.segments:
            if seg.matmul is None or seg.matmul.form != "dlhs":
                continue
            gen = _matmul_gen(segment_call(plan.eqns, seg))
            if gen.get("path") != "sm90" or not all(gen["tma"]):
                continue
            name = gen["name"]
            call = functools.partial(_segment_kernel(
                seg, segment_programs(plan.eqns, seg), impl="cuda"),
                alias=False)
            vals = seg_operands(seg, 7)
            first = call(*vals)
            own = _build.start_generated(fm.translation_unit([name]) +
                                         "// the segment in a unit of its "
                                         "own\n")
            lib, held = _build.finish_generated(*own), fm._LIB_OF[name]
            fm._LIB_OF[name] = lib[0]
            try:
                again = call(*vals)
                torch.cuda.synchronize()
            finally:
                fm._LIB_OF[name] = held
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            print(f"{tag} dlhs segment {name} launched through its plan's "
                  f"unit and through a second unit of its own in this "
                  f"process: both ran, bit-equal {same}")
            check(same, f"{name}: the two units' launches differ")
            return
    check(False, "no bf16 sm90 dlhs segment with both operands by TMA")


class TrainChild:
    """``fresh_train`` in a subprocess of its own (``chip_smoke.py
    --train-child``), started at once; its output goes to files until it
    ends.  ``hold``: it waits after its first eager step until
    ``release()``; ``signal``: ``wait_timed()`` returns once its timed
    steps are over and their memory given back.  So the whole script runs
    a child's first step beside other work and its timed steps alone."""

    def __init__(self, arch: str, layers: int, steps: int, full: bool,
                 tag: str, *, remat: bool = False, two_units: bool = False,
                 hold: bool = False, signal: bool = False):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
        self.hold = os.path.join(self.dir, "release") if hold else None
        self.signal = os.path.join(self.dir, "timed") if signal else None
        self.label = f"{arch} at {layers or 'full'} layers"
        spec = dict(arch=arch, layers=layers, steps=steps, full=full,
                    tag=tag, remat=remat, two_units=two_units,
                    hold=self.hold, signal=self.signal)
        cmd = [sys.executable, os.path.abspath(__file__), "--train-child",
               json.dumps(spec), "--src", _src_root()]
        self.out = open(os.path.join(self.dir, "stdout"), "w+")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=self.out, stderr=self.err,
                                     text=True)

    def release(self) -> None:
        if self.hold is not None:
            open(self.hold, "w").close()

    def wait_timed(self) -> None:
        while not os.path.exists(self.signal) and self.proc.poll() is None:
            check(time.perf_counter() - self.t0 < CHILD_TIMEOUT,
                  f"{self.label}: its timed steps did not end within "
                  f"{CHILD_TIMEOUT} s")
            time.sleep(0.2)

    def finish(self) -> dict:
        """Waits for the process; prints its lines, returns its
        readings."""
        try:
            self.proc.wait(timeout=max(
                1.0, CHILD_TIMEOUT - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.stop()
        process_s = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        lines, err = self.out.read().splitlines(), self.err.read()
        self.stop()
        for ln in lines:
            if not ln.startswith(TRAIN_MARK):
                print(ln)
        marked = [ln for ln in lines if ln.startswith(TRAIN_MARK)]
        if self.proc.returncode != 0 or not marked:
            print(err[-16000:], file=sys.stderr)
        check(self.proc.returncode == 0 and bool(marked),
              f"{self.label}: the training process exited "
              f"{self.proc.returncode} (its standard error above)")
        res = json.loads(marked[-1][len(TRAIN_MARK):])
        res["process_s"] = process_s
        return res

    def stop(self) -> None:
        """Ends the process if it still runs; removes its files."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in (self.out, self.err):
            f.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def card_to_itself(timeout: float = 300.0) -> None:
    """Waits until no process but this one holds the card's memory, as a
    process started alone needs (a process that ended may give its memory
    back late); prints the wait, and the card's processes, when there
    was one."""
    t0 = time.perf_counter()

    def others() -> float:
        free, total = torch.cuda.mem_get_info()
        return (total - free - torch.cuda.memory_reserved()) / 2 ** 30

    apps, first = None, others()
    held = first
    while held > OTHERS_GIB and time.perf_counter() - t0 < timeout:
        if apps is None:
            apps = run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader"]).replace("\n", "; ")
        time.sleep(1.0)
        held = others()
    if apps is not None:
        print(f"[13] {first:.2f} GiB of the card held outside this "
              f"process's allocator (its processes: {apps or 'none listed'}"
              f"); {held:.2f} after {time.perf_counter() - t0:.1f} s")


def c5_line(r: dict, beside: str = "") -> None:
    print(f"[c5] qwen3-1.7b at {r['layers']} layers: the process's first "
          f"steps ran, {r['process_s']:.1f} s in all (first eager step "
          f"{r['first']['seconds']:.1f} s, first compiled step "
          f"{r['compiled']['first_s']:.1f} s), compiled bit-equal to "
          f"eager" + (f"; beside {beside}" if beside else ""))


def c5_child(layers: int) -> TrainChild:
    """Queue C5's check at ``layers``: a fresh process's first offloaded
    steps with ``remat=False``, nothing planned ahead; the smaller
    process also launches a dlhs segment through a second unit."""
    return TrainChild("qwen3-1.7b", layers, 2, False, "[c5]",
                      two_units=layers == C5_LAYERS[0])


def zoo_child(arch: str, layers: int = 0, **kw) -> TrainChild:
    return TrainChild(arch, layers, 3, True, "[13]",
                      remat=ZOO_TRAIN[arch][1], **kw)


def zoo_line(r: dict, card: str, launches: dict, beside: str = "",
             along: str = "") -> None:
    """Phase 13's checks and summary line of one model's process:
    ``beside`` ran beside its first eager step, ``along`` beside the
    whole process."""
    arch, remat, c = r["arch"], r["remat"], r["compiled"]
    launches[arch] = c["launches"]
    check(all(c["launches"].get(k, 0) > 0 for k in (
        "fused_segment_grid", "fused_matmul_segment",
        "fused_matmul_dlhs_segment", "fused_matmul_drhs_segment")),
          f"{arch}: a step launched no B2, B3, B4 or B6: {c['launches']}")
    held = r["eager"].get("held_s")
    print(f"[13] {arch}: {r['layers']} layers, {r['params'] / 1e9:.3f} B"
          f" parameters, remat {'on' if remat else 'off'}; a replay "
          f"{c['host_ms']:.3f} ms by the host clock, {c['replay_ms']:.3f} ms"
          f" on the device (CUDA events), idle {c['idle']:.1%}, "
          f"{c['tokens_s']:.0f} tokens/s (eager "
          f"{TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / r['eager']['step_ms'] * 1e3:.0f}"
          f"); first eager step {r['first']['seconds']:.1f} s (capture "
          f"{r['first']['capture_s']:.1f}, plan {r['first']['plan_s']:.1f}"
          f", {r['first']['units']} units built {r['first']['build_s']:.1f}"
          + (f"; beside {beside}" if beside else "")
          + f"), first compiled step {c['first_s']:.1f} s (warm "
          f"{c['warm_s']:.1f}, capture {c['capture_s']:.1f}); plans "
          f"{r['plans']}; {r['segments']} distinct segments held against "
          f"their plain versions; peak {c['peak']:.2f} GiB, graph pool "
          f"{c['pool']} bytes; {c['tied']} tied places, {c['unique']} "
          f"unique state tensors; launches a step {c['launches']}; "
          f"train_traces 1; {r['process_s']:.1f} s in all"
          + (f" ({held:.1f} of them waiting after the first step)"
             if held is not None else "")
          + (f", beside {along}" if along else "") + f" on {card}")


def beside_main(fn, *args, **kw):
    """Runs ``fn`` on a thread of this process; returns the call that
    waits for it and raises what it raised (a failed check too)."""
    raised = []

    def run() -> None:
        try:
            fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            raised.append(e)

    thread = threading.Thread(target=run)
    thread.start()

    def wait() -> None:
        thread.join()
        if raised:
            raise raised[0]
    return wait


def durability_and_zoo_train(card: str, t0: float, untimed=None) -> dict:
    """Phases 12 and 13 and queue C5's check in the whole script, their
    processes overlapped where the card's memory allows: zamba2-1.2b's
    process (full depth) starts beside phase 12 and takes its first eager
    step there, then waits for phase 12's end before its timed steps;
    the 4-layer C5 process and rwkv6-1.6b's at ``WHOLE_RWKV6_LAYERS``
    run beside zamba2's untimed checks (its segments, the f32 build).
    Each overlap is taken only where the card has ``BESIDE_GIB`` (and
    ``BESIDE_RWKV6_GIB``) free for it at its start, else the processes
    run one after the other.  Phase 12's seconds, zamba2's first step
    and the C5 and rwkv6 processes' readings are taken beside that other
    work (``--durability`` / ``--zoo-train`` give them alone, at full
    depth).  ``untimed``: checks that time nothing, run by this process
    while phase 12's processes run.  Returns the zoo models' launches a
    step by kernel."""
    launches, children = {}, []

    def free_gib() -> float:
        return torch.cuda.mem_get_info()[0] / 2 ** 30

    def start(child: TrainChild) -> TrainChild:
        children.append(child)
        return child

    def rwkv6() -> TrainChild:
        return start(zoo_child("rwkv6-1.6b", WHOLE_RWKV6_LAYERS))

    torch.cuda.empty_cache()
    free = free_gib()
    beside = free >= BESIDE_GIB["phase 12"]
    print(f"[12] {free:.2f} GiB of the card free (this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f}): zamba2-1.2b's "
          f"process starts {'beside phase 12' if beside else 'after it'}")
    try:
        zamba = start(zoo_child("zamba2-1.2b", hold=True, signal=True)) \
            if beside else None
        others = ["phase 13's zamba2-1.2b process (its start and first "
                  "eager step)"] * beside + \
            ["phase 7's sm90 variants"] * (untimed is not None)
        durability = beside_main(phase_durability, card,
                                 beside=" and ".join(others))
        try:
            if untimed is not None:
                untimed()
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            durability()
        print(f"[time] phase 12 ended at {time.perf_counter() - t0:.1f} s")
        if zamba is None:
            zamba = start(zoo_child("zamba2-1.2b", signal=True))
        zamba.release()
        zamba.wait_timed()
        free = free_gib()
        need = BESIDE_GIB["zamba2 checks"]
        small = start(c5_child(C5_LAYERS[0])) if free >= need \
            else None
        rwkv = rwkv6() if small and free >= need + BESIDE_RWKV6_GIB \
            else None
        print(f"[13] {free:.2f} GiB of the card free after zamba2-1.2b's "
              f"timed steps: the 4-layer C5 process starts "
              f"{'beside its checks' if small else 'after them'}, "
              f"rwkv6-1.6b's at {WHOLE_RWKV6_LAYERS} layers "
              f"{'beside them too' if rwkv else 'after them'}")
        checks = "zamba2-1.2b's segment checks and f32 build"
        zoo_line(zamba.finish(), card, launches,
                 beside="phase 12" if beside else "")
        if small is None:
            card_to_itself()
            c5_line(start(c5_child(C5_LAYERS[0])).finish())
        else:
            c5_line(small.finish(), beside=checks)
        if rwkv is None:
            card_to_itself()
            zoo_line(rwkv6().finish(), card, launches)
        else:
            zoo_line(rwkv.finish(), card, launches, along=checks +
                     " and the 4-layer C5 process")
        card_to_itself(60.0)
    finally:
        for child in children:
            child.stop()
    print(f"[time] phase 13 and queue C5's check ended at "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def zoo_alone(card: str) -> dict:
    """``--zoo-train``: queue C5's check and phase 13, each process alone
    on the card.  Returns the launches a step by kernel of each zoo
    model (its compiled step's replay)."""
    launches = {}
    for layers in C5_LAYERS:
        c5_line(c5_child(layers).finish())
    for arch in ZOO_TRAIN:
        zoo_line(zoo_child(arch).finish(), card, launches)
    return launches


def decode_alone(card: str) -> None:
    """``--decode``: the decode readings of phases 5, 6 and 11 alone
    (``decode_readings``: qwen3-1.7b, zamba2-1.2b and rwkv6-1.6b, each
    plain and offloaded; full width and depth, random bf16 weights from
    seed 0),
    on the package under ``--src`` where given.  A package whose
    ``Engine`` has no ``capture_decode`` (before the compiled step) gives
    the eager readings alone: one call compares two checkouts."""
    import inspect

    import repro_torch

    captures = "capture_decode" in inspect.signature(Engine).parameters
    print(f"[d] decode readings of {os.path.dirname(repro_torch.__file__)} "
          f"({'captured and eager' if captures else 'eager only: its Engine has no capture_decode'}); "
          f"card {card}")
    held = {}
    for arch, offload in ENGINES:
        cfg, params = serving_weights(arch, held)
        kw = dict(device="cuda", slots=8, max_len=2048, page_size=64,
                  offload=offload)
        try:
            eager = Engine(cfg, params, **kw,
                           **({"capture_decode": False} if captures else {}))
        except NotImplementedError as e:   # an older package: refused
            print(f"[d] {arch} offload={offload}: not in this package ({e})")
            continue
        engine = Engine(cfg, params, **kw) if captures else None
        label = f"{arch}{' offload=True' if offload else ''}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if offload:
            t0 = time.perf_counter()
            plan = eager.prepare_decode()
            t1 = time.perf_counter()
            if plan.library:
                fm.finish_library(fm.start_library(plan.library))
            st = eager.offload_stats
            print(f"[d] {label}: decode step captured {st['capture_s']:.1f} s"
                  f" and planned {st['plan_s']:.1f} s ({t1 - t0:.1f} s), "
                  f"{len(plan.segments)} fused segments "
                  f"({sum(g.matmul is None for g in plan.segments)} grid), "
                  f"{sum(not d.fused for d in plan.decisions)} declined; its "
                  f"CUDA translation unit ({len(plan.library)} anchored "
                  f"segments) built in {time.perf_counter() - t1:.1f} s")
        t0 = time.perf_counter()
        decode_readings(engine, eager, "[d]", label)
        for eng in (engine, eager):
            if eng is not None:
                drain(eng)
        print(f"[d] {label}: {time.perf_counter() - t0:.1f} s; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              "(the bf16 weights, both engines' caches, 8-slot decode)")
        del engine, eager


def admit_alone(card: str) -> None:
    """``--admit``: the admit readings of phases 4, 6 and 11 alone
    (``serve_twice``: qwen3-1.7b, zamba2-1.2b and rwkv6-1.6b, each plain
    and offloaded; full width and depth, random bf16 weights from seed 0; the
    12-request mix through ``capture_decode=False``, then twice through
    the captured engine, every admit bucket replayed against its eager
    call), on the package under ``--src`` where given.  A package whose
    ``Engine`` has no ``admit_traces`` (before the compiled admit) serves
    the mix twice through its own engine, whose admits are eager: one call
    compares two checkouts."""
    import repro_torch

    lens = np.random.default_rng(0).integers(16, 701, size=12)
    lens[0], lens[1] = 16, 700
    held, compiled = {}, None
    for arch, offload in ENGINES:
        cfg, params = serving_weights(arch, held)
        kw = dict(device="cuda", slots=8, max_len=2048, page_size=64,
                  offload=offload)
        try:
            engine = Engine(cfg, params, **kw)
        except NotImplementedError as e:   # an older package: refused
            print(f"[a] {arch} offload={offload}: not in this package ({e})")
            continue
        if compiled is None:
            compiled = "admit_traces" in engine.serve_counters
            print(f"[a] admit readings of "
                  f"{os.path.dirname(repro_torch.__file__)} ("
                  f"{'compiled admits' if compiled else 'eager admits: its Engine has no admit_traces'}"
                  f"); card {card}")
        if offload:
            plan = engine.prepare_decode()
            if plan.library:
                fm.finish_library(fm.start_library(plan.library))
        label = f"{arch}{' offload=True' if offload else ''}"
        t0 = time.perf_counter()
        if compiled:
            eager = Engine(cfg, params, **kw, capture_decode=False)
            serve_twice(engine, eager, cfg, lens, 64, 1, label, "[a]")
            del eager
        else:
            runs = []
            for n in (1, 2):
                _, r = timed_generate(engine, make_requests(cfg, lens, 64,
                                                            seed=1))
                print(f"[a] {label} pass {n}: {admit_line(r)}")
                runs.append(r)
            print_passes(*runs, label, "[a]")
        print(f"[a] {label}: {time.perf_counter() - t0:.1f} s")
        del engine


def train_alone(card: str) -> None:
    """``--train``: phase 7's training readings alone, on the package
    under ``--src`` where given: full-width qwen3-1.7b (bf16 compute, f32
    masters, offload on, remat off, 2 x 1,024 tokens) planned and built,
    3 eager steps (``train_steps``), then 3 steps of
    ``compile_train_step`` held against them (``train_compiled``) and the
    2-layer f32 build (``train_small_compiled``).  A package without
    ``compile_train_step`` (before the compiled step) gives the eager
    step alone: one call compares two checkouts."""
    import repro_torch
    import repro_torch.train as train_mod
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.train import init_train_state, make_train_step

    compiled = hasattr(train_mod, "compile_train_step")
    print(f"[t] training readings of {os.path.dirname(repro_torch.__file__)}"
          f" ({'compiled and eager' if compiled else 'eager only: no compile_train_step'}"
          f"); card {card}")
    cfg = get_config("qwen3-1.7b")
    tcfg = TrainConfig(remat=False, offload=True)
    model = build_model(cfg, device=DEVICE)
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip",
                                                         *TRAIN_SHAPE)))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    step = make_train_step(model, tcfg)
    held = [init_train_state(model, 0)]
    plans = plan_training(step, held[0], data.batch(0), "bf16")
    state, _, eager = train_steps(step, held, data, tokens, plans)
    host = host_state(state) if compiled else None
    del state, step, plans
    gc.collect()
    torch.cuda.empty_cache()
    if compiled:
        train_compiled(model, tcfg, data, tokens, eager, host,
                       "bf16 full width", tag="[t]")
        del host
        train_small_compiled(tag="[t]")


def donation_alone(card: str) -> None:
    """``--donation``: the in-place checks of phases 6 and 7 alone — the
    full-width decode plan's donating weight-stream segment, then
    full-width qwen3-1.7b at phase 7's depth: planned and built, 3 eager
    steps, the donating update's and the fwd / dlhs / drhs in-place
    launches, and 3 steps of ``compile_train_step`` held against the
    eager ones (the write-back's copies, the graph pool, the peak)."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data import SyntheticLM, make_data_config
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config("qwen3-1.7b")
    params = build_model(cfg, device=DEVICE).init(0)
    off = Engine(cfg, params, device="cuda", slots=8, max_len=2048,
                 page_size=64, offload=True)
    plan16 = off.prepare_decode()
    verify_plans("qwen3-1.7b decode plan (bf16)", [plan16], "[6]")
    donation_checks([plan16], ["stream"], card, "[6]")
    del off, params, plan16
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(remat=False, offload=True)
    model = build_model(cfg, device=DEVICE)
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip",
                                                         *TRAIN_SHAPE)))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    step = make_train_step(model, tcfg)
    held = [init_train_state(model, 0)]
    plans = plan_training(step, held[0], data.batch(0), "bf16",
                          layers=TRAIN_LAYERS)
    state, _, eager = train_steps(step, held, data, tokens, plans)
    update_donation(state, tcfg, card)
    donation_checks(plans, ["fwd", "dlhs", "drhs"], card, "[7]")
    host = host_state(state)
    del state, step, plans
    gc.collect()
    torch.cuda.empty_cache()
    train_compiled(model, tcfg, data, tokens, eager, host,
                   f"bf16 {TRAIN_LAYERS} layers")


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
    if "--durability-child" in sys.argv:
        i = sys.argv.index("--durability-child")
        print(DUR_MARK + json.dumps(durability_child(*sys.argv[i + 1:i + 3])))
        return 0
    if "--train-child" in sys.argv:
        i = sys.argv.index("--train-child")
        res = fresh_train(**json.loads(sys.argv[i + 1]))
        print(TRAIN_MARK + json.dumps(res))
        return 0
    if "--kernels-a-call" in sys.argv:
        print(json.dumps(kernels_a_call()))
        return 0
    t0 = time.perf_counter()
    card = phase_environment()
    if "--decode-segments" in sys.argv:
        phase_decode_segments(card)
        return 0
    if "--norm" in sys.argv:
        norm_readings(card)
        return 0
    if "--scan" in sys.argv:
        scan_readings(card)
        return 0
    if "--decode" in sys.argv:
        decode_alone(card)
        return 0
    if "--admit" in sys.argv:
        admit_alone(card)
        return 0
    if "--train" in sys.argv:
        train_alone(card)
        return 0
    if "--durability" in sys.argv:
        phase_durability(card)
        return 0
    if "--zoo-train" in sys.argv:
        zoo_alone(card)
        return 0
    if "--zoo-serve" in sys.argv:
        phase_zoo(card)
        return 0
    if "--donation" in sys.argv:
        donation_alone(card)
        return 0
    phase_build()
    kernel = phase_kernel(card)
    print(f"[time] phases 1-3 ended at {time.perf_counter() - t0:.1f} s")
    engine, eager, launches = phase_engine()
    phase_full_width_check(engine, eager, "qwen3-1.7b")
    print(f"[time] phases 4-5 ended at {time.perf_counter() - t0:.1f} s")
    params = engine.params
    del engine, eager
    timed, counts = phase_offload(params, card)
    print(f"[time] phase 6 ended at {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    train_rows, train_counts, b8, _ = phase_train(card)
    print(f"[time] phase 7 ended at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    b5, b7 = phase_flash(card)
    print(f"[time] phase 8 ended at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    lib = phase_library(card)
    print(f"[time] phase 9 ended at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    scan = phase_scan(card)
    print(f"[time] phase 10 ended at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase_zoo(card)
    print(f"[time] phase 11 ended at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    durability_and_zoo_train(card, t0, untimed=sm90_variants)
    print(f"[14] static plan verifier: {VERIFIED.pop('plans', 0)} plans of "
          f"this process verified, findings by rule {VERIFIED or 'none'}, "
          f"no error (phase 13's processes verify their own, above)")
    print(f"[14] total {time.perf_counter() - t0:.1f} s")
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
