"""Serving engine: continuous batching over a paged KV cache.

The counterpart of ``repro/serve/engine.py``'s ``Engine``.  It keeps a
fixed pool of B batch rows ("slots") and a global page pool for
attention KV (``serve.kv_pool``).  Requests are admitted per step into
free slots, their prompt KV is scattered into block-table-indexed pages,
and one decode step advances every active slot; finished slots free
their pages immediately, so KV memory tracks *live tokens* rather than
``slots * max_len``.

What carries over unchanged: pow2 prompt bucketing, page accounting
(``pool.used_pages`` follows the JAX engine step for step), chunked
prefill interleaved with decode (``prefill_chunk=N``), page growth at
page boundaries, preemption by recompute (exact for greedy decoding),
deadlines, NaN-logits abort, pause/resume on transient page-alloc
faults, bounded-queue backpressure.

The engine's functions are compiled as the JAX engine compiles them
(``jax.jit`` with donation): each is a *static function* that reads and
writes only fixed buffers, every one written **in place**.

* The decode step reads and writes the slot state (pos/tok/budget/temp/
  active), a ``[slots, table_width]`` block-table buffer, a ``[slots]``
  poison mask, a ``[slots, vocab]`` Gumbel-noise buffer, the page pools
  and recurrent state rows, and a ``[4, slots]`` emit buffer.
* Admit (prefill, scatter into the slot's pages and state rows, and
  activate), the prefill chunk, and the slot controls (activate after the
  last chunk, deactivate, reactivate) read their per-request values from
  one int32 input buffer — the control words (slot, tokens cached before,
  tokens added, budget, the temperature's f32 bits), the slot's
  block-table row and the prompt tokens, a bucket's ``[1, s_b]`` or the
  chunk's ``[1, prefill_chunk]`` view of one ``[1, max_len]`` buffer —
  and leave the prompt's last logits in a ``[1, vocab]`` buffer.  The
  lengths reach the model as 0-d device tensors (``model.prefill``'s
  ``length``, ``prefill_chunk``'s ``ctx_len`` / ``n_valid``), never read
  on the host.

On a CUDA device a function runs eagerly once on a side stream at its
first call (a real call, whose results stand: it builds every kernel it
launches), then is captured as ONE CUDA graph (``StepGraph``) that every
later call replays: the decode step once, admit once per pow2 prompt
bucket, the chunk once, each control once.  Inputs are copied in from
pinned host buffers before a replay; a decode step reads the emit buffer
back — one host sync per decode step.  The admit, chunk and control
graphs share one memory pool (``_prefill_pool``): each one's only lasting
effect is its writes into the fixed buffers, allocated outside the pool,
so the pool is bounded by the largest bucket.  A failed capture raises;
``capture_decode=False`` runs every static function eagerly on the card,
as the CPU always does, with the same counters.  ``serve_counters`` has
the JAX engine's trace counts, counting builds (captures on a card):
``step_traces`` (1 at steady state whatever the admission churn, plus
one for each kernel-guard epoch change, ``kernel_replans``, which drops
the decode graph as the JAX engine re-jits its step; the other graphs
stay, as the JAX engine keeps its other functions), ``admit_traces``
(one per prompt shape), ``chunk_traces`` (1) and ``control_traces`` (one
per control function used).  Where admit bucketing is off (recurrent
stacks, ``bucket_prompts=False``), a graph keyed on an exact prompt
length would be captured and almost never replayed: the same static
admit runs eagerly on the card, and ``admit_traces`` counts one build
per distinct prompt length, the JAX engine's trace count.

What differs, because PyTorch runs eagerly:

* greedy decoding matches the JAX engine token for token; sampled rows
  (``temperature > 0``) take the Gumbel-max draw ``argmax(logits / T +
  G)`` over noise ``G = -log(E)``, ``E ~ Exp(1)``, drawn from the
  engine's ``torch.Generator`` before each step (an exact draw from
  ``softmax(logits / T)``), and cannot match ``jax.random`` bit for bit;
* code that wraps the model's ``prefill`` / ``decode_step_paged`` sees
  only the warm call and the capture of a function that is replayed:
  read ``_prefill_logits`` and ``_logits`` (the graphs' outputs)
  instead.

``offload=True`` (or an ``offload_policy``) runs the paged decode step
through the offload compiler (``repro_torch.core.offload.mpu_offload``),
wrapped where the JAX engine wraps it: the plan is looked up once for the
pool's decode signature and bound to the fixed buffers (``bind``), and
the static step runs it — fused segments as single kernel launches,
everything else as its op.  ``offload_stats`` shows the plan cache: the
JAX engine's zero-retrace steady state, ``plan_misses == traces == 1``
and ``plan_hits == 0``; ``explain_decode()`` the per-segment decisions.

Recurrent stacks (zamba2's mamba2 layers, rwkv6) keep one state row per
slot: admit writes the prompt's final state into the slot's row, a
decode step keeps the new state of the active slots only.  Prompt
bucketing and chunked prefill stay off for them, as in the JAX engine.
``offload=True`` serves them as it serves the dense stacks: the planner
captures the recurrent decode (each layer's state written back in place
after every read of the old state) and the tied shared-attention block,
whose one parameter set plans as one input at each of its positions.

``fault_injector`` (a ``repro_torch.serve.faults.FaultInjector``, or
anything duck-typed alike: ``page_alloc()``, ``slow_step()``,
``poison_slots(active)``) drives the step-time faults (NaN logits, page
faults, slow steps); as in the JAX engine it is also installed on the
kernel guard and the artifact layer for the engine's lifetime, so an
injected kernel fault demotes a call to its plain version (a quarantine
bumps the guard epoch: the step is captured again with all_far plans,
``kernel_replans``) and disk faults reach the plan store.
``verify_paged_tables()`` proves the live block tables in bounds
(``repro_torch.analysis``).  ``FixedSlotEngine`` is the reference's
dense-cache baseline engine.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import StepGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels.guard import kernel_guard
from repro_torch.models import build_model
from repro_torch.models.layers import cast_params
from repro_torch.models.transformer import Cache, attention_only_pattern
from repro_torch.serve.kv_pool import PagePool, bucket_length, ceil_pow2

if TYPE_CHECKING:
    from repro_torch.core.policy import OffloadPolicy


#: the control words at the head of the engine's input buffer: the slot,
#: the tokens cached before the call, the tokens it adds, the decode
#: budget, and the temperature's f32 bits
CTRL = 5


def _mirrored(shape: tuple, dtype: torch.dtype, dev: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A fixed device buffer and its host mirror (pinned on a card, so
    that a copy in is asynchronous), both zeroed."""
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, pin_memory=dev.type == "cuda"))


def _next_tokens(logits: torch.Tensor, noise: torch.Tensor,
                 temps: torch.Tensor) -> torch.Tensor:
    """Each row's next token (int32): its greedy argmax, or where
    ``temps > 0`` the Gumbel-max draw ``argmax(logits / T + noise)``."""
    x = logits.float()
    greedy = torch.argmax(x, -1)
    sampled = torch.argmax(torch.addcdiv(
        noise, x, torch.clamp(temps[:, None], min=1e-3)), -1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


class _DecodeStep:
    """The decode step both engines share: a static function over fixed
    buffers (``_static_step``, reading ``_decode_args()``), optionally
    through the offload compiler — its plan looked up once and bound to
    the buffers — run eagerly or, on a card, captured once as a CUDA graph
    and replayed; and the Gumbel noise the sampled rows draw from the
    engine's generator."""

    def _init_decode(self, decode_fn, offload: bool,
                     offload_policy: "OffloadPolicy | None",
                     capture_decode: bool) -> None:
        # ``offload_policy`` implies offload
        self._decode_fn = decode_fn
        self.offload = offload or offload_policy is not None
        self.offload_policy = offload_policy
        self._decode_offload = None
        if self.offload:
            from repro_torch.core.offload import mpu_offload
            self._decode_offload = mpu_offload(decode_fn,
                                               policy=offload_policy)
        self._decode_run = None    # the offloaded plan, bound to the buffers
        #: the last decode step's logits; once captured, the graph's own
        #: output tensor, which each replay rewrites
        self._logits: torch.Tensor | None = None
        self._capture = capture_decode and self.device.type == "cuda"
        self._step_built = False
        self._graph: StepGraph | None = None

    def _decode(self) -> torch.Tensor:
        """The decode on the fixed buffers, through the bound plan where
        offload is on; its logits are kept as ``_logits``."""
        run = self._decode_fn if self._decode_run is None else \
            self._decode_run
        self._logits, _ = run(*self._decode_args())
        return self._logits

    def _run_decode_step(self) -> None:
        """Run the static step: replay its graph, or build the step
        first (``step_traces``): bind the offloaded plan to the fixed
        buffers and, on a card, warm up and capture."""
        if self._graph is not None:
            self._graph.replay()
            return
        if not self._step_built:
            if self._decode_offload is not None and self._decode_run is None:
                self.prepare_decode()
            self._step_built = True
            self.serve_counters["step_traces"] += 1
            if self._capture:
                self._graph = StepGraph(self._static_step, self.device)
                return
        self._static_step()

    def _draw_noise(self) -> None:
        """Fresh Gumbel noise ``-log(E)``, ``E ~ Exp(1)``, into the fixed
        noise buffer, from the engine's generator."""
        self._noise.exponential_(generator=self.rng).log_().neg_()

    @property
    def offload_stats(self) -> dict | None:
        """Plan-cache counters of the offloaded decode step (None when
        offload is off) and the kernel guard's.  The plan is looked up
        when the static step is built, not per decode step, so the steady
        state is the JAX engine's: ``plan_misses == traces == 1`` and
        ``plan_hits == 0`` whatever the churn."""
        if self._decode_offload is None:
            return None
        return {**self._decode_offload.stats.as_dict(),
                **kernel_guard().stats()}

    def _on_decode_signature(self, method: str):
        """``method`` of the offloaded decode step (``explain`` /
        ``warm`` / ``plan_for``) on the engine's current decode inputs;
        None when offload is off."""
        if self._decode_offload is None:
            return None
        return getattr(self._decode_offload, method)(*self._decode_args())

    def explain_decode(self):
        """The offload DecisionReport of the decode step for the engine's
        signature (None when offload is off): which chains fused, which
        candidates were declined and why."""
        return self._on_decode_signature("explain")

    def prepare_decode(self):
        """Capture and plan the decode step now and bind the plan to the
        fixed buffers (what the first decode step would do); returns the
        plan (None when offload is off)."""
        if self._decode_offload is None:
            return None
        self._decode_run = self._decode_offload.bind(*self._decode_args())
        return self._decode_run.plan

    def decode_plan(self):
        """The OffloadPlan of the decode step (None when offload is off),
        looked up without counting."""
        return self._on_decode_signature("plan_for")


@dataclass
class Request:
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0
    deadline_s: float = 0.0       # relative budget; 0 = no deadline
    deadline_at: float = 0.0      # absolute monotonic; stamped at submit/admit
    preempts: int = 0             # times preempted (bounded by max_preempts)


#: Completion.status values — "ok" is the only one with a full token
#: stream; the others are terminal non-success outcomes.
STATUSES = ("ok", "cancelled", "aborted", "rejected")


@dataclass
class Completion:
    rid: int
    tokens: list[int] = field(default_factory=list)
    status: str = "ok"
    reason: str = ""              # e.g. "deadline", "nan_logits", "queue_full"


class Engine(_DecodeStep):
    """Continuous-batching engine over a paged KV cache.

    ``capture_decode`` governs all five static functions (the decode
    step, admit, the prefill chunk and the slot controls): on a CUDA
    device each is captured as a CUDA graph, or with False runs eagerly
    (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 512, seed: int = 0, offload: bool = False,
                 page_size: int = 64, num_pages: int | None = None,
                 prefill_chunk: int = 0, bucket_prompts: bool = True,
                 max_preempts: int = 3, max_queue: int = 0,
                 fault_injector: Any = None,
                 offload_policy: "OffloadPolicy | None" = None,
                 capture_decode: bool = True,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        # the serving copy: cast once into the compute dtype (no copy of
        # a tree that is cast already)
        self.params = cast_params(params, self.model.dtype, self.device)
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        w = cfg.sliding_window
        # logical per-request cache capacity (rolling window for SWA)
        self.kv_capacity = min(max_len, w) if w > 0 else max_len
        pages_per_req = -(-self.kv_capacity // page_size)
        self.table_width = ceil_pow2(pages_per_req)
        if num_pages is None:
            # page 0 is scratch; default sizes the pool for full residency
            num_pages = 1 + slots * pages_per_req
        self.num_pages = num_pages
        self.pool = PagePool(num_pages, page_size, self.table_width, slots)
        self.cache: Cache = self.model.init_paged_cache(
            slots, num_pages, page_size)

        # device-side slot state, updated in place by step/admit — ONE
        # host sync per decode step (the emit tuple read back)
        dev = self.device
        self._state = {
            "pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "tok": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "budget": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "temp": torch.zeros((slots,), dtype=torch.float32, device=dev),
            "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
        }
        # the static decode step's other fixed buffers (see the module
        # docstring); the tables and the poison mask are staged in pinned
        # host memory and copied in before each step
        self._tables, self._tables_host = _mirrored(
            (slots, self.table_width), torch.int32, dev)
        self._poison, self._poison_host = _mirrored((slots,), torch.bool,
                                                    dev)
        self._noise = torch.zeros((slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self._emit = torch.zeros((4, slots), dtype=torch.int32, device=dev)
        # the admit / chunk / control functions' inputs (see the module
        # docstring), staged through a pinned mirror in one copy a call;
        # ``_staged`` marks the last copy out of the mirror
        tw = self.table_width
        self._inputs, self._inputs_host = _mirrored(
            (CTRL + tw + max_len,), torch.int32, dev)
        self._staged = torch.cuda.Event() if dev.type == "cuda" else None
        self._ctrl = self._inputs[:CTRL]
        self._temp = self._inputs[CTRL - 1:CTRL].view(torch.float32)
        self._row = self._inputs[CTRL:CTRL + tw]
        self._prompt = self._inputs[CTRL + tw:][None]      # [1, max_len]
        #: the last admitted prompt's (or prefill chunk's) last logits
        self._prefill_logits = torch.zeros((1, cfg.vocab_size),
                                           dtype=torch.float32, device=dev)
        #: the admit / chunk / control graphs by key, the keys built, and
        #: the memory pool the graphs share
        self._graphs: dict[tuple, StepGraph] = {}
        self._built: set[tuple] = set()
        self._prefill_pool = None

        # host mirrors (slot occupancy / page-growth bookkeeping)
        self._host_active = np.zeros((slots,), bool)   # occupied (incl. prefilling)
        self._decode_active = np.zeros((slots,), bool)  # decoding
        self._host_pos = np.zeros((slots,), np.int32)
        self._slot_rid = np.full((slots,), -1, np.int32)
        self._slot_req: list[Request | None] = [None] * slots
        self._slot_emitted: list[list[int]] = [[] for _ in range(slots)]
        self._slot_seq = np.zeros((slots,), np.int64)  # admit order (preempt youngest)
        self._admit_seq = 0
        self._prefilling: dict[int, dict] = {}  # slot -> {req, prompt, ctx}
        self._requeue: list[Request] = []
        # robustness state: submit() queue (bounded by max_queue),
        # terminal events for pop_finished(), slots paused on transient
        # page-alloc faults, and the kernel-guard epoch last seen
        self.max_preempts = max_preempts
        self.max_queue = max_queue
        self._injector = fault_injector
        self._queue: list[Request] = []
        self._events: list[Completion] = []
        self._paused = np.zeros((slots,), bool)
        self._transient_fault = False
        self._guard_epoch = kernel_guard().epoch

        # sampling draws from an explicit generator on the engine's device
        self.rng = torch.Generator(device=dev)
        self.rng.manual_seed(seed)
        # pow2 admit bucketing is exact only when no recurrent state or
        # MoE capacity can see the pad tokens
        self.bucket_prompts = (bucket_prompts and attention_only_pattern(cfg)
                               and cfg.moe is None)
        # chunked prefill: dense causal attention scattering straight
        # into pages — no SWA rolling, no recurrent state
        self.prefill_chunk = prefill_chunk
        self._chunkable = (prefill_chunk > 0 and w == 0
                           and attention_only_pattern(cfg))

        # the hot path: with offload on, the paged decode step goes
        # through the offload compiler, planned once for the pool's decode
        # signature
        model = self.model

        def paged_decode(params, cache, tok, pos, tables, active):
            return model.decode_step_paged(params, cache, tok, pos, tables,
                                           active, max_len=max_len)

        self._init_decode(paged_decode, offload, offload_policy,
                          capture_decode)
        if self._capture:
            self._prefill_pool = torch.cuda.graph_pool_handle()

        if fault_injector is not None:
            # kernel dispatch and durable-artifact IO see the injector
            # the step-time fault classes use
            from repro_torch.core.artifacts import set_disk_injector
            from repro_torch.kernels.guard import set_injector
            set_injector(fault_injector)
            set_disk_injector(fault_injector)

        self.decode_steps = 0
        self.serve_counters = {"admit_traces": 0, "step_traces": 0,
                               "chunk_traces": 0, "control_traces": 0,
                               "preemptions": 0, "preemption_retries": 0,
                               "preempt_vetoes": 0, "deadline_cancels": 0,
                               "nan_aborts": 0, "page_faults": 0,
                               "alloc_stalls": 0, "kernel_replans": 0,
                               "reject_queue_full": 0, "reject_deadline": 0}

    # -- static admit, chunk and controls -----------------------------------
    def _stage(self, slot: int, ctx: int = 0, n: int = 0, budget: int = 0,
               temp: float = 0.0, tokens: np.ndarray | None = None,
               width: int = 0) -> None:
        """One call's inputs into the fixed input buffer, outside any
        graph: the control words and, with ``tokens``, the slot's
        block-table row and the tokens right-padded with zeros to
        ``width``, in one copy from the pinned mirror.  The mirror is
        rewritten only once the previous copy out of it has run."""
        if self._staged is not None:
            self._staged.synchronize()
        h = self._inputs_host.numpy()
        h[:CTRL] = (slot, ctx, n, budget, np.float32(temp).view(np.int32))
        end = CTRL
        if tokens is not None:
            t0 = CTRL + self.table_width
            h[CTRL:t0] = self.pool.tables[slot]
            h[t0:t0 + tokens.shape[0]] = tokens
            h[t0 + tokens.shape[0]:t0 + width] = 0
            end = t0 + width
        self._inputs[:end].copy_(self._inputs_host[:end], non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def _run_static(self, key: tuple, fn, counter: str, *,
                    capture: bool = True) -> None:
        """Run an admit / chunk / control function: replay its graph, or
        build it first (``counter`` counts the build) and, on a card,
        warm it up and capture it into the pool these graphs share —
        unless ``capture`` is off (an unbucketed admit: eager)."""
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        if key not in self._built:
            self._built.add(key)
            self.serve_counters[counter] += 1
            if self._capture and capture:
                self._graphs[key] = StepGraph(fn, self.device,
                                              pool=self._prefill_pool)
                return
        fn()

    @torch.no_grad()
    def _static_admit(self, width: int) -> torch.Tensor:
        """Admit the staged prompt, padded to ``width`` tokens (its pow2
        bucket, or its length where bucketing is off): prefill, scatter
        the cache into the slot's first pages and state rows, activate
        the slot.  Returns the prompt's last logits (a fixed buffer)."""
        cap = self.kv_capacity
        n_pr = self.pool.pages_for(
            cap if self.cfg.sliding_window > 0 else min(width, cap))
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": self._prompt[:, :width]}, self.max_len,
            self._ctrl[2])
        self._prefill_logits.copy_(logits)
        _scatter_admit(self.cache, cache1, self._row,
                       self._ctrl[0:1].long(), page=self.page_size,
                       n_pr=n_pr)
        return self._static_activate()

    @torch.no_grad()
    def _static_chunk(self) -> torch.Tensor:
        """One staged prompt chunk into the slot's pages; its last real
        token's logits into ``_prefill_logits``, which it returns."""
        c = self._ctrl
        logits, _ = self.model.prefill_chunk(
            self.params, self.cache, self._prompt[:, :self.prefill_chunk],
            self._row, c[1], c[2])
        return self._prefill_logits.copy_(logits)

    @torch.no_grad()
    def _static_activate(self) -> torch.Tensor:
        """Start decoding in the staged slot at position ctx + n: its
        first token is the argmax of the prompt's last logits."""
        st, c = self._state, self._ctrl
        slot = c[0:1].long()
        st["pos"].index_copy_(0, slot, c[1:2] + c[2:3])
        st["tok"].index_copy_(0, slot, torch.argmax(
            self._prefill_logits, -1).to(torch.int32))
        st["budget"].index_copy_(0, slot, c[3:4])
        st["temp"].index_copy_(0, slot, self._temp)
        st["active"].index_fill_(0, slot, True)
        return self._prefill_logits

    # pausing/resuming only flips ``active``: pos/tok/budget are
    # untouched, so resuming continues token-exact
    @torch.no_grad()
    def _static_deactivate(self) -> torch.Tensor:
        return self._state["active"].index_fill_(
            0, self._ctrl[0:1].long(), False)

    @torch.no_grad()
    def _static_reactivate(self) -> torch.Tensor:
        return self._state["active"].index_fill_(
            0, self._ctrl[0:1].long(), True)

    def _set_active(self, slot: int, on: bool):
        self._stage(slot)
        name = "reactivate" if on else "deactivate"
        self._run_static((name,), getattr(self, f"_static_{name}"),
                         "control_traces")

    @torch.no_grad()
    def _static_step(self) -> torch.Tensor:
        """One decode for every slot, on the fixed buffers only: the
        slot state advances in place and the emit buffer receives
        (emitted token, was_active, done, bad) — what the CUDA graph
        captures.  Every row computes its greedy and its sampled token;
        ``temp > 0`` picks, as in the JAX engine.  Returns the logits."""
        st, max_len = self._state, self.max_len
        logits = self._decode()
        # chaos: poisoned rows get non-finite logits (an all-False mask
        # without an injector leaves them as they are)
        logits = torch.where(self._poison[:, None], torch.nan, logits)
        # a poisoned row must not kill the batch: detect non-finite
        # logits per row, sample that row from neutral logits, and
        # report the mask so the host aborts just that request
        was_active = st["active"]
        bad = was_active & ~torch.isfinite(logits).all(-1)
        safe = torch.where(bad[:, None], 0.0, logits)
        nxt = _next_tokens(safe, self._noise, st["temp"])
        one = was_active.to(torch.int32)
        st["pos"].add_(one)
        st["budget"].sub_(one)
        done = was_active & ((st["budget"] < 0) | (st["pos"] >= max_len - 1))
        self._emit.copy_(torch.stack([st["tok"], one, done.to(torch.int32),
                                      bad.to(torch.int32)]))
        st["tok"].copy_(torch.where(was_active, nxt, st["tok"]))
        st["active"].copy_(was_active & ~done)
        return self._logits

    def _stage_inputs(self, poison: np.ndarray | None) -> None:
        """This step's inputs into the fixed buffers, outside the graph:
        the block tables (and the poison mask) from pinned host buffers,
        and fresh Gumbel noise while a slot samples."""
        self._tables_host.numpy()[:] = self.pool.tables
        self._tables.copy_(self._tables_host, non_blocking=True)
        if poison is not None:
            self._poison_host.numpy()[:] = poison
            self._poison.copy_(self._poison_host, non_blocking=True)
        if self._sampling:
            self._draw_noise()

    def _decode_args(self) -> tuple:
        st = self._state
        return (self.params, self.cache, st["tok"], st["pos"], self._tables,
                st["active"])

    @property
    def _sampling(self) -> bool:
        """True while any decoding slot asked for a temperature > 0."""
        return any(r is not None and r.temperature > 0
                   for r in self._slot_req)

    # -- introspection ------------------------------------------------------
    @property
    def serve_stats(self) -> dict:
        """Serving-side counters plus live page-pool occupancy, decode
        steps taken, kernel launches and kernel-guard health."""
        return {
            **self.serve_counters,
            **kernel_guard().stats(),
            "decode_steps": self.decode_steps,
            "kernel_launches": kops.launch_counts(),
            "pages_used": self.pool.used_pages,
            "pages_free": self.pool.free_pages,
            "page_size": self.page_size,
            "table_width": self.table_width,
        }

    def verify_paged_tables(self) -> list:
        """Static bounds proof of the paged decode's block tables
        (``repro_torch.analysis.verify_paged_decode``): every entry,
        padding included, names a real page, and no slot's position
        exceeds what its table row addresses.  Returns the findings
        (empty when the tables prove out)."""
        from repro_torch.analysis import verify_paged_decode
        return verify_paged_decode(
            self.pool.tables, self._state["pos"].cpu().numpy(),
            num_pages=self.num_pages, page_size=self.page_size)

    # -- slot management ----------------------------------------------------
    def _free_slot(self) -> int | None:
        idx = np.where(~self._host_active)[0]
        return int(idx[0]) if idx.size else None

    def _occupy(self, slot: int, req: Request, pos0: int):
        self._host_active[slot] = True
        self._host_pos[slot] = pos0
        self._slot_rid[slot] = req.rid
        self._slot_req[slot] = req
        self._slot_emitted[slot] = []
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1

    def _release(self, slot: int):
        self.pool.free_slot(slot)
        self._host_active[slot] = False
        self._decode_active[slot] = False
        self._paused[slot] = False
        self._slot_req[slot] = None
        self._slot_rid[slot] = -1
        self._prefilling.pop(slot, None)

    def _finish(self, slot: int, status: str = "ok", reason: str = ""):
        """Terminal transition: record the completion event (drained by
        ``pop_finished``) and free the slot + its pages immediately."""
        self._events.append(Completion(
            int(self._slot_rid[slot]), list(self._slot_emitted[slot]),
            status, reason))
        self._release(slot)

    def _preempt(self, slot: int):
        """Evict by recompute: requeue the request's prompt + emitted
        tokens (exact for greedy; sampled requests resample the tail).
        The requeued request carries its preemption count (victim
        eligibility bound) and its absolute deadline."""
        req = self._slot_req[slot]
        req.preempts += 1
        if slot in self._prefilling:
            self._requeue.append(req)   # nothing emitted yet
        else:
            emitted = self._slot_emitted[slot]
            remaining = req.max_new_tokens - len(emitted)
            if remaining > 0:
                prompt = np.concatenate([
                    np.asarray(req.prompt, np.int32),
                    np.asarray(emitted, np.int32)])
                self._requeue.append(Request(
                    prompt, remaining, req.temperature, req.rid,
                    deadline_s=req.deadline_s, deadline_at=req.deadline_at,
                    preempts=req.preempts))
                self.serve_counters["preemption_retries"] += 1
            self._set_active(slot, False)
        self._release(slot)
        self.serve_counters["preemptions"] += 1

    def _preempt_for_pages(self, protect: int) -> bool:
        """Free pages by preempting the youngest *eligible* decoding
        slot other than ``protect``.  Eligibility is the anti-starvation
        bound: a request preempted ``max_preempts`` times is exempt from
        further eviction, so two oversized requests can no longer
        preempt each other forever — the aged one keeps its pages and
        the other waits for completions.  Returns True if a victim was
        evicted."""
        candidates = [s for s in range(self.slots)
                      if self._decode_active[s] and s != protect]
        victims = [s for s in candidates
                   if self._slot_req[s].preempts < self.max_preempts]
        if not victims:
            if candidates:
                self.serve_counters["preempt_vetoes"] += 1
            return False
        self._preempt(max(victims, key=lambda s: self._slot_seq[s]))
        return True

    # -- admission ----------------------------------------------------------
    def _pool_ensure(self, slot: int, need: int) -> tuple[bool, bool]:
        """``pool.ensure`` with fault injection: returns (ok, injected).
        The injector is only consulted when the call would actually
        allocate (growth), so already-satisfied ensures never fault; an
        injected failure is transient — the caller stalls/pauses and
        retries instead of preempting."""
        if need > self.pool.allocated(slot) and self._injector is not None \
                and self._injector.page_alloc():
            self.serve_counters["page_faults"] += 1
            self._transient_fault = True
            return False, True
        return self.pool.ensure(slot, need), False

    def _stamp_deadline(self, req: Request):
        if req.deadline_s > 0 and req.deadline_at == 0.0:
            req.deadline_at = time.monotonic() + req.deadline_s

    def admit(self, req: Request) -> bool:
        """Admit a request into a free slot (prefill now, or start a
        chunked prefill).  Returns False when no slot/pages are free."""
        slot = self._free_slot()
        if slot is None:
            return False
        self._stamp_deadline(req)
        toks = np.asarray(req.prompt, np.int32).reshape(-1)
        s = toks.shape[0]
        if self._chunkable and s > self.prefill_chunk:
            need = self.pool.pages_for(min(self.prefill_chunk, s))
            if not self._pool_ensure(slot, need)[0]:
                return False
            self._occupy(slot, req, pos0=s)
            self._prefilling[slot] = {"req": req, "prompt": toks, "ctx": 0}
            return True
        s_b = bucket_length(s, self.max_len) if self.bucket_prompts else s
        swa = self.cfg.sliding_window > 0
        need = self.pool.pages_for(
            self.kv_capacity if swa else min(s_b, self.kv_capacity))
        if not self._pool_ensure(slot, need)[0]:
            return False
        self._stage(slot, 0, s, req.max_new_tokens - 1, req.temperature,
                    toks, s_b)
        self._run_static(("admit", s_b),
                         functools.partial(self._static_admit, s_b),
                         "admit_traces", capture=self.bucket_prompts)
        self._occupy(slot, req, pos0=s)
        self._decode_active[slot] = True
        return True

    def _advance_prefill(self):
        """Run ONE prompt chunk for the oldest prefilling slot —
        interleaved with decode so long prompts don't stall the batch."""
        slot = next(iter(self._prefilling))
        info = self._prefilling[slot]
        prompt, ctx, c = info["prompt"], info["ctx"], self.prefill_chunk
        n_valid = min(c, prompt.shape[0] - ctx)
        need = self.pool.pages_for(ctx + n_valid)
        while True:
            ok, injected = self._pool_ensure(slot, need)
            if ok:
                break
            if injected:
                return  # transient fault: retry this chunk next step
            if not self._preempt_for_pages(protect=slot):
                if not self._decode_active.any():
                    raise RuntimeError(
                        "paged KV pool too small to prefill request "
                        f"{info['req'].rid}: need {need} pages, "
                        f"free {self.pool.free_pages}")
                return  # stall: decode completions will free pages
        req = info["req"]
        self._stage(slot, ctx, n_valid, req.max_new_tokens - 1,
                    req.temperature, prompt[ctx:ctx + n_valid], c)
        self._run_static(("chunk",), self._static_chunk, "chunk_traces")
        ctx += n_valid
        if ctx >= prompt.shape[0]:
            self._run_static(("activate",), self._static_activate,
                             "control_traces")
            del self._prefilling[slot]
            self._decode_active[slot] = True
            self._host_pos[slot] = ctx
        else:
            info["ctx"] = ctx

    # -- decode -------------------------------------------------------------
    def _slot_page_need(self, s: int) -> int:
        write_idx = min(int(self._host_pos[s]), self.kv_capacity - 1)
        return write_idx // self.page_size + 1

    def _pause_slot(self, s: int):
        """Transient page-alloc fault mid-decode: park the slot instead
        of preempting.  Its device state freezes (active=False) and its
        pages stay owned, so resuming later continues token-exact."""
        self._set_active(s, False)
        self._decode_active[s] = False
        self._paused[s] = True
        self.serve_counters["alloc_stalls"] += 1

    def _resume_paused(self):
        """Retry the page growth that paused each parked slot; on
        success flip the slot live again."""
        for s in np.flatnonzero(self._paused):
            ok, _ = self._pool_ensure(int(s), self._slot_page_need(int(s)))
            if ok:
                self._paused[s] = False
                self._decode_active[s] = True
                self._set_active(int(s), True)

    def _check_deadlines(self):
        """Cancel every occupied slot whose absolute deadline has
        passed: pages are reclaimed immediately and the completion
        carries the tokens emitted so far.  Queued/requeued requests
        expire the same way (see ``_pump``)."""
        now = time.monotonic()
        for s in range(self.slots):
            if not self._host_active[s]:
                continue
            req = self._slot_req[s]
            if req.deadline_at > 0 and now > req.deadline_at:
                if self._decode_active[s]:
                    self._set_active(s, False)
                self._finish(s, "cancelled", "deadline")
                self.serve_counters["deadline_cancels"] += 1

    def _check_guard_epoch(self):
        """A change of kernel health drops the static step — its graph
        and its bound plan — so that the next decode step rebuilds it,
        as the JAX engine re-jits its step (``kernel_replans``).  The
        admit, chunk and control graphs stay: they launch no kernel of
        the library, and the JAX engine rebuilds only its step."""
        if kernel_guard().epoch != self._guard_epoch:
            self._guard_epoch = kernel_guard().epoch
            self.serve_counters["kernel_replans"] += 1
            self._graph = None
            self._decode_run = None
            self._step_built = False

    def _grow_pages(self):
        """Before a decode step, make sure every active slot owns the
        page its next write lands in (dense caches grow with ``pos``;
        SWA slots are fully allocated at admit).  Injected alloc faults
        pause the slot (transient); real exhaustion preempts a victim
        or — with no eligible victim and nothing running — raises."""
        if self.cfg.sliding_window > 0:
            return
        for s in np.where(self._decode_active)[0]:
            need = self._slot_page_need(int(s))
            while self._decode_active[s]:
                ok, injected = self._pool_ensure(int(s), need)
                if ok:
                    break
                if injected:
                    self._pause_slot(int(s))
                    break
                if not self._preempt_for_pages(protect=int(s)):
                    others = [o for o in range(self.slots)
                              if o != s and self._decode_active[o]]
                    if others or self._prefilling:
                        # every candidate victim is preemption-exempt:
                        # park this slot until their completions free
                        # pages (resumed by _resume_paused)
                        self._pause_slot(int(s))
                        break
                    raise RuntimeError(
                        "paged KV pool too small for a single request: "
                        f"need {need} pages, width {self.table_width}, "
                        f"free {self.pool.free_pages}")

    def step(self) -> list[tuple[int, int]]:
        """One engine step: sweep deadlines, resume paused slots,
        advance at most one prefill chunk, then one decode for all
        active slots.  Returns [(rid, token)]."""
        if self._injector is not None:
            self._injector.slow_step()
        self._check_deadlines()
        self._resume_paused()
        self._check_guard_epoch()
        if self._prefilling:
            self._advance_prefill()
        if not self._decode_active.any():
            return []
        self._grow_pages()
        if not self._decode_active.any():
            return []
        poison = None
        if self._injector is not None:
            poison = self._injector.poison_slots(self._decode_active)
        self._stage_inputs(poison)
        self._run_decode_step()
        self.decode_steps += 1
        # the single host sync of the step
        em, wa, dn, bd = self._emit.cpu().numpy()
        out = []
        for s in range(self.slots):
            if not wa[s]:
                continue
            tok = int(em[s])
            out.append((int(self._slot_rid[s]), tok))
            self._slot_emitted[s].append(tok)
            self._host_pos[s] += 1
            if bd[s]:
                # non-finite logits: this step's emit (computed from the
                # previous step's finite logits) stands, the NEXT token
                # would be garbage — abort just this request
                if not dn[s]:
                    self._set_active(s, False)
                self._finish(s, "aborted", "nan_logits")
                self.serve_counters["nan_aborts"] += 1
            elif dn[s]:
                self._finish(s)
        return out

    # -- submission / lifecycle --------------------------------------------
    def submit(self, req: Request) -> str:
        """Queue a request with admission control.  Returns "queued", or
        a typed rejection reason — "rejected_queue_full" when the
        backlog is at ``max_queue`` (backpressure; 0 = unbounded), or
        "rejected_deadline" when the deadline already passed.  Rejected
        requests also surface as Completion events (``pop_finished``)."""
        self._stamp_deadline(req)
        if self.max_queue > 0 and \
                len(self._queue) + len(self._requeue) >= self.max_queue:
            self.serve_counters["reject_queue_full"] += 1
            self._events.append(Completion(
                req.rid, [], "rejected", "queue_full"))
            return "rejected_queue_full"
        if req.deadline_at > 0 and time.monotonic() > req.deadline_at:
            self.serve_counters["reject_deadline"] += 1
            self._events.append(Completion(
                req.rid, [], "rejected", "deadline"))
            return "rejected_deadline"
        self._queue.append(req)
        return "queued"

    def pop_finished(self) -> list[Completion]:
        """Drain terminal events (ok / cancelled / aborted / rejected)
        accumulated since the last call."""
        out, self._events = self._events, []
        return out

    def _pump(self) -> bool:
        """Admit as many queued requests as slots/pages allow — aged
        (preempted) requests first so re-queueing can never starve them
        behind fresh arrivals.  Expired queue entries are cancelled
        without occupying a slot.  Returns True if anything moved."""
        moved = False
        now = time.monotonic()
        for queue in (self._requeue, self._queue):
            while queue:
                head = queue[0]
                if head.deadline_at > 0 and now > head.deadline_at:
                    queue.pop(0)
                    self._events.append(Completion(
                        head.rid, [], "cancelled", "deadline"))
                    self.serve_counters["deadline_cancels"] += 1
                    moved = True
                    continue
                if not self.admit(head):
                    # a blocked aged head also blocks fresh admissions:
                    # a fresh request must not steal the slot/pages the
                    # aged one is waiting on
                    return moved
                queue.pop(0)
                moved = True
        return moved

    def generate(self, requests: list[Request]) -> dict[int, Completion]:
        """Run a request list to completion with continuous batching
        (per-step admission; preempted requests re-queue internally).
        Completions carry a terminal ``status``: "ok", "cancelled"
        (deadline), "aborted" (non-finite logits), or "rejected"
        (backpressure) — tokens are whatever was emitted before the
        terminal transition."""
        done: dict[int, Completion] = {
            r.rid: Completion(r.rid) for r in requests}

        def drain():
            for ev in self.pop_finished():
                done[ev.rid].status = ev.status
                done[ev.rid].reason = ev.reason

        for r in requests:
            self.submit(r)
        stalls = 0
        while self._queue or self._requeue or self._host_active.any():
            moved = self._pump()
            made = self.step()
            for rid, tok in made:
                done[rid].tokens.append(tok)
            drain()
            if made or moved:
                stalls = 0
                continue
            # nothing moved this iteration: transient injected faults
            # and pages-in-flight (prefill stall, paused slots) deserve
            # bounded patience; an empty engine that cannot admit its
            # head request is stuck for good
            stalls += 1
            stuck_empty = not (self._prefilling or self._host_active.any()
                               or self._transient_fault)
            self._transient_fault = False
            if stuck_empty or stalls >= 10_000:
                raise RuntimeError(
                    "no progress: request cannot be admitted "
                    f"(free pages {self.pool.free_pages}, "
                    f"page_size {self.page_size})")
        drain()
        return done


class FixedSlotEngine(_DecodeStep):
    """The reference's previous engine: a dense ``[slots, max_len]`` KV
    cache (``model.init_cache``) with per-slot host bookkeeping, kept as
    the serving baseline of the paged ``Engine``.

    Each request is prefilled eagerly at admit, once per prompt length
    (``admit_traces``: the reference retraces its prefill per length),
    and its cache rows written into its slot.  The decode step is a
    static function over fixed buffers (the dense cache, updated in
    place, and one int32 ``[3, slots]`` input buffer: last token,
    position, the temperature's f32 bits, staged from a pinned mirror),
    captured on a CUDA device as ONE CUDA graph (``StepGraph``) at its
    first call and replayed after (``step_traces``), as the reference
    jits its step with the cache donated; ``capture_decode=False`` runs
    it eagerly.  Every slot decodes every step, as in the reference; an
    idle slot's rows are rewritten whole at its next admit.

    ``offload=True`` (or an ``offload_policy``) runs ``model.decode_step``
    through ``mpu_offload``, its plan looked up once and bound to the
    fixed buffers: ``offload_stats`` reads ``plan_misses == traces == 1``
    and ``plan_hits == 0`` at steady state.  Greedy tokens equal the
    reference's; sampled rows take the paged engine's Gumbel-max draw
    from the engine's own generator."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 512, seed: int = 0, offload: bool = False,
                 offload_policy: "OffloadPolicy | None" = None,
                 capture_decode: bool = True,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.model = build_model(cfg, device=dev)
        self.params = cast_params(params, self.model.dtype, dev)
        self.slots = slots
        self.max_len = max_len
        self.cache: Cache = self.model.init_cache(slots, max_len)
        self.pos = np.zeros((slots,), np.int32)
        self.active = np.zeros((slots,), bool)
        self.budget = np.zeros((slots,), np.int32)
        self.rid = np.full((slots,), -1, np.int32)
        self.last_token = np.zeros((slots,), np.int32)
        self.temps = np.zeros((slots,), np.float32)
        self.rng = torch.Generator(device=dev)
        self.rng.manual_seed(seed)

        self._inputs, self._inputs_host = _mirrored((3, slots), torch.int32,
                                                    dev)
        self._temp = self._inputs[2].view(torch.float32)
        self._noise = torch.zeros((slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self._next = torch.zeros((slots,), dtype=torch.int32, device=dev)
        #: the last admitted prompt's last logits
        self._prefill_logits: torch.Tensor | None = None
        self._admitted: set[int] = set()
        self.decode_steps = 0
        self.serve_counters = {"admit_traces": 0, "step_traces": 0}
        self._init_decode(self.model.decode_step, offload, offload_policy,
                          capture_decode)

    def _decode_args(self) -> tuple:
        return self.params, self.cache, self._inputs[0], self._inputs[1]

    # -- slot management ----------------------------------------------------
    def _free_slot(self) -> int | None:
        idx = np.where(~self.active)[0]
        return int(idx[0]) if idx.size else None

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot. Returns False if full."""
        slot = self._free_slot()
        if slot is None:
            return False
        toks = np.asarray(req.prompt, np.int32).reshape(1, -1)
        if toks.shape[1] not in self._admitted:
            self._admitted.add(toks.shape[1])
            self.serve_counters["admit_traces"] += 1
        logits, cache1 = self.model.prefill(self.params, {"tokens": toks},
                                            self.max_len)
        self._prefill_logits = logits
        _merge_slot(self.cache, cache1, slot)
        self.pos[slot] = toks.shape[1]
        self.active[slot] = True
        self.budget[slot] = req.max_new_tokens - 1
        self.rid[slot] = req.rid
        self.last_token[slot] = int(torch.argmax(logits[0]))
        self.temps[slot] = req.temperature
        return True

    # -- decode -------------------------------------------------------------
    @torch.no_grad()
    def _static_step(self) -> torch.Tensor:
        """One decode of every slot on the fixed buffers: the cache in
        place, the next tokens into ``_next``.  Returns the logits."""
        logits = self._decode()
        self._next.copy_(_next_tokens(logits, self._noise, self._temp))
        return self._logits

    def step(self) -> list[tuple[int, int]]:
        """One decode step for all slots.  Returns [(rid, token)] emitted
        this step by the active ones."""
        if not self.active.any():
            return []
        h = self._inputs_host.numpy()
        h[0], h[1], h[2] = self.last_token, self.pos, self.temps.view(np.int32)
        self._inputs.copy_(self._inputs_host, non_blocking=True)
        if (self.temps[self.active] > 0).any():
            self._draw_noise()
        self._run_decode_step()
        self.decode_steps += 1
        nxt = self._next.cpu().numpy()          # the step's one host sync
        out = []
        for s in range(self.slots):
            if not self.active[s]:
                continue
            out.append((int(self.rid[s]), int(self.last_token[s])))
            self.pos[s] += 1
            self.last_token[s] = nxt[s]
            self.budget[s] -= 1
            if self.budget[s] < 0 or self.pos[s] >= self.max_len - 1:
                self.active[s] = False
        return out

    def generate(self, requests: list[Request]) -> dict[int, Completion]:
        """Run a request list to completion with continuous batching."""
        pending = list(requests)
        done: dict[int, Completion] = {
            r.rid: Completion(r.rid) for r in requests}
        while pending or self.active.any():
            while pending and self.admit(pending[0]):
                pending.pop(0)
            for rid, tok in self.step():
                done[rid].tokens.append(tok)
        return done


def _merge_slot(cache: Cache, cache1: Cache, slot: int) -> None:
    """Write a single-request dense cache into row ``slot`` of every
    leaf, in place (every leaf of the dense cache has the batch row on
    axis 0)."""
    for pool_layer, one in zip(cache, cache1):
        for name, t in one.items():
            dst = pool_layer[name]
            if t.shape[0] != 1 or t.shape[1:] != dst.shape[1:]:
                raise ValueError(f"cannot merge cache leaf {name!r} "
                                 f"{tuple(t.shape)} -> {tuple(dst.shape)}")
            dst[slot].copy_(t[0])


def _fit_len(x: torch.Tensor, length: int) -> torch.Tensor:
    """Slice or zero-pad ``x`` [T, ...] to ``length`` along axis 0."""
    t = x.shape[0]
    if t >= length:
        return x[:length]
    return torch.cat([x, x.new_zeros((length - t,) + x.shape[1:])])


#: the leaves of a recurrent layer's cache, each with the batch (slot)
#: row on axis 0 (``models.ssm.init_mamba2_cache``,
#: ``models.rwkv.init_rwkv6_cache``)
RECURRENT_LEAVES = ("ssm", "conv", "wkv", "tshift", "cshift")


def _scatter_admit(cache: Cache, cache1: Cache, table_row: torch.Tensor,
                   slot: torch.Tensor, *, page: int, n_pr: int) -> None:
    """Merge a single-request prefill cache into the paged pools, in
    place: each attention layer's K/V ``[1, T, NK, H]`` scatters its
    first ``n_pr`` pages through the slot's block-table row; each
    recurrent leaf writes the slot's state row (``slot``: a ``[1]`` long
    tensor on the device).  A leaf of another name raises."""
    ids = table_row[:n_pr].long()
    for pool_layer, one in zip(cache, cache1):
        for name, t in one.items():
            if name in ("k", "v"):
                x = _fit_len(t[0], n_pr * page)
                _, nk, h = x.shape
                x = x.reshape(n_pr, page, nk, h).permute(0, 2, 1, 3)
                pool_layer[name][ids] = x.to(pool_layer[name].dtype)
            elif name in RECURRENT_LEAVES and \
                    t.shape[1:] == pool_layer[name].shape[1:]:
                pool_layer[name].index_copy_(
                    0, slot, t.to(pool_layer[name].dtype))
            else:
                raise ValueError(f"cannot merge cache leaf {name!r} "
                                 f"{tuple(t.shape)} into the paged cache")
