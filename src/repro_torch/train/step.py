"""The training step: loss -> grads -> clip -> AdamW.

With ``offload=True`` (or ``tcfg.offload``) the step runs through the
offload compiler (``repro_torch.core.offload``) on both sides of the
gradient: the *un-differentiated* loss is wrapped, so the backward flows
through the fused segments' planned backwards — each segment's
cotangent program is re-planned by the same planner, and the gradient
contractions (dx = g @ w^T, dw = x^T @ g) anchor the dlhs and drhs
kernels (B4, B6) instead of running unfused.  The optimizer update
(clip + AdamW elementwise math) is offloaded as its own program.
``tcfg.offload_policy`` selects the decision backend; None resolves the
active ``with offload_policy(...):`` scope at call time.

Gradient accumulation over microbatches is a Python loop summing f32
gradients.  ``make_train_step``'s step is functional: it returns a new
``TrainState`` and leaves the one it was given as it was.

``compile_train_step`` is to the port what ``jax.jit(make_train_step(
...), donate_argnums=(0,))`` is to the reference (``repro/train/
loop.py``): a static step over the donated state's own storage and fixed
batch buffers.  On a CUDA device it runs eagerly once a batch signature,
then is captured as ONE CUDA graph (``core.graph.StepGraph``) that every
later step of that signature replays: forward, planned backward and
update, no host walk of the runner.  See ``CompiledTrainStep``.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import TrainConfig
from repro_torch.core.graph import StepGraph
from repro_torch.core.offload import mpu_offload, repeated_lookups
from repro_torch.kernels.guard import kernel_guard
from repro_torch.models.model import Model
from repro_torch.models.transformer import Ties
from repro_torch.optim import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    init_state,
    warmup_cosine,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _offloaded(fn, tcfg: TrainConfig):
    return mpu_offload(fn, policy=tcfg.resolved_offload_policy())


def _use_offload(tcfg: TrainConfig, offload: bool | None) -> bool:
    """Whether the step is offloaded: ``offload``, default
    ``tcfg.offload``."""
    return tcfg.offload if offload is None else offload


def _loss_fn(model: Model, tcfg: TrainConfig, use_offload: bool):
    def loss_fn(params, batch):
        return model.loss_fn(params, batch, remat=tcfg.remat)
    return _offloaded(loss_fn, tcfg) if use_offload else loss_fn


def update_program(tcfg: TrainConfig):
    """``update_fn(params, grads, opt) -> (params, opt, grad_norm, lr)``:
    clip, schedule, AdamW.  The step calls it on the unique leaves
    (``_unique_opt``), so that a capture, which traces every leaf as an
    input of its own, still sees a tied block once.  It returns the
    parameters and moments it takes, in the order it takes them: with
    them donated (``donate_argnums=(0, 2)``), each offloaded leaf's new
    values land in its own buffers (``core.offload.donation_places``)."""
    def update_fn(params, grads, opt):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = warmup_cosine(tcfg, opt.step)
        params, opt = apply_updates(params, grads, opt, tcfg, lr)
        return params, opt, gnorm, lr
    return update_fn


#: the update's arguments a compiled step donates: parameters, moments
UPDATE_DONATE = (0, 2)


def _update_fn(tcfg: TrainConfig, use_offload: bool, *,
               donate: bool = False):
    """The update (``update_program``), offloaded where ``use_offload``;
    ``donate`` donates the parameters and moments (``UPDATE_DONATE``), as
    the compiled step does and the functional one does not."""
    fn = update_program(tcfg)
    if not use_offload:
        return fn
    return mpu_offload(fn, policy=tcfg.resolved_offload_policy(),
                       donate_argnums=UPDATE_DONATE if donate else ())


def init_train_state(model: Model, seed: int = 0) -> TrainState:
    params = model.init(seed)
    return TrainState(params, init_state(params))


def _unique_opt(ties: Ties, opt: AdamWState) -> AdamWState:
    return AdamWState(opt.step, ties.unique(opt.m), ties.unique(opt.v))


def _tied_opt(ties: Ties, opt: AdamWState) -> AdamWState:
    return AdamWState(opt.step, ties.tree(opt.m), ties.tree(opt.v))


def device_batch(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig, *,
                    offload: bool | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``offload`` (default: ``tcfg.offload``) routes the loss and the
    update through the offload compiler.  The step exposes
    ``compute_grads(params, batch) -> (loss, metrics, grads)`` and, when
    offloaded, ``loss_fn`` / ``update_fn`` (the wrappers), ``stats`` /
    ``update_stats`` (their plan-cache counters) and ``explain_loss`` /
    ``explain_update`` (their decision reports).  Gradients are taken
    with respect to the parameters' unique tensors (``Ties``): a tied
    block's gradient is the sum over its positions, and the returned
    state holds one updated tensor (and one pair of moments) for it at
    every position."""
    use_offload = _use_offload(tcfg, offload)
    loss_fn = _loss_fn(model, tcfg, use_offload)

    def grads_of(params, batch, ties):
        leaves = [p.detach().requires_grad_() for p in ties.unique(params)]
        loss, metrics = loss_fn(ties.tree(leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def unique_grads(params, batch, ties):
        """(loss, metrics, one gradient a unique leaf)."""
        batch = device_batch(batch, model.device)
        if tcfg.microbatches <= 1:
            return grads_of(params, batch, ties)
        n = tcfg.microbatches
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in ties.unique(params)]
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, _, grads = grads_of(params, mb, ties)
            acc = [a + g for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss
        inv = 1.0 / n
        return loss_sum * inv, {"loss": loss_sum * inv}, \
            [g * inv for g in acc]

    def compute_grads(params, batch):
        ties = Ties(params)
        loss, metrics, grads = unique_grads(params, batch, ties)
        return loss, metrics, ties.tree(grads)

    update_fn = _update_fn(tcfg, use_offload)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        ties = Ties(state.params)
        loss, metrics, grads = unique_grads(state.params, batch, ties)
        with torch.no_grad():
            params, opt, gnorm, lr = update_fn(
                ties.unique(state.params), grads, _unique_opt(ties, state.opt))
        metrics = {**metrics, "grad_norm": gnorm, "lr": lr,
                   "loss": metrics.get("loss", loss)}
        return TrainState(ties.tree(params), _tied_opt(ties, opt)), metrics

    train_step.compute_grads = compute_grads
    if use_offload:
        train_step.loss_fn = loss_fn
        train_step.update_fn = update_fn
        train_step.stats = loss_fn.stats
        train_step.update_stats = update_fn.stats
        train_step.explain_loss = loss_fn.explain
        train_step.explain_update = update_fn.explain
    return train_step


def compile_train_step(model: Model, tcfg: TrainConfig, *,
                       offload: bool | None = None,
                       capture: bool = True) -> "CompiledTrainStep":
    """``train_step(state, batch) -> (state, metrics)`` compiled as the
    reference jits it with its state donated: see ``CompiledTrainStep``.
    ``offload`` as in ``make_train_step``; ``capture=False`` runs the
    same static step eagerly on the card (as the CPU always does)."""
    return CompiledTrainStep(model, tcfg, offload=offload, capture=capture)


class _Build:
    """What the compiled step keeps for one batch signature: the batch's
    fixed device buffers, views of one flat byte buffer that one
    non-blocking copy fills from a pinned host mirror (``staged`` marks
    the last copy out of the mirror); the plans looked up for it; the
    metrics buffer; and its graph."""

    def __init__(self, batch: dict, device: torch.device):
        pinned = device.type == "cuda"
        self.layout: dict[str, tuple] = {}
        nbytes = 0
        for k in sorted(batch):
            shape, dtype = _leaf_meta(batch[k])
            n = int(np.prod(shape)) * dtype.itemsize
            self.layout[k] = (nbytes, n, shape, dtype)
            nbytes += -(-n // 16) * 16          # 16-byte aligned views
        self.flat = torch.zeros((nbytes,), dtype=torch.uint8, device=device)
        self.host = torch.zeros((nbytes,), dtype=torch.uint8,
                                pin_memory=pinned)
        self.staged = torch.cuda.Event() if pinned else None
        # in the caller's key order, as ``make_train_step`` hands the
        # batch to the loss: both then look up one plan
        self.batch = {k: self._view(self.flat, k) for k in batch}
        self.host_views = {k: self._view(self.host, k).numpy()
                           for k in self.layout}
        self.graph: StepGraph | None = None
        self.built = False
        self.runs = 0
        self.loss_run = self.update_run = None
        #: the state slots the last write-back copied (``write_back``)
        self.copied: list[int] = []
        self.metrics: torch.Tensor | None = None
        self.keys: list[str] = []

    def _view(self, flat: torch.Tensor, k: str) -> torch.Tensor:
        off, n, shape, dtype = self.layout[k]
        return flat[off:off + n].view(dtype).view(shape)

    def stage(self, batch: dict) -> None:
        """The batch into the fixed buffers, outside any graph: host data
        in one copy from the pinned mirror, which is rewritten only once
        the previous copy out of it has run; a tensor already on the
        device copied across."""
        if self.staged is not None:
            self.staged.synchronize()
        on_device = {}
        for k, view in self.host_views.items():
            v = batch[k]
            if isinstance(v, torch.Tensor) and v.device == self.flat.device:
                on_device[k] = v
            else:
                view[...] = v.numpy() if isinstance(v, torch.Tensor) else v
        self.flat.copy_(self.host, non_blocking=True)
        if self.staged is not None:
            self.staged.record()
        for k, v in on_device.items():
            self.batch[k].copy_(v)


def write_back(slots: list[torch.Tensor], values: list[torch.Tensor]
               ) -> list[int]:
    """Put each new value of the donated state into its slot: a value the
    offloaded update wrote in place (it is the slot: same ``data_ptr``,
    shape and strides) stays; the rest (the leaves the update left far,
    and every leaf of a step that is not offloaded) are copied.  Raises
    ``RuntimeError`` where a value lives in the storage of a slot that is
    not its own — copying it would read a buffer an earlier copy may have
    overwritten; the planner never places one there.  Returns the
    indices of the copied slots."""
    owner = {s.untyped_storage().data_ptr(): i for i, s in enumerate(slots)}
    copied = []
    for i, (dst, src) in enumerate(zip(slots, values)):
        if src.data_ptr() == dst.data_ptr() and src.shape == dst.shape and \
                src.stride() == dst.stride():
            continue
        k = owner.get(src.untyped_storage().data_ptr())
        if k is not None:
            raise RuntimeError(
                f"the update's value for state leaf {i} lives in the "
                f"storage of leaf {k}: a donated buffer holds another "
                "leaf's value")
        dst.copy_(src)
        copied.append(i)
    return copied


def _leaf_meta(v) -> tuple[tuple, torch.dtype]:
    """(shape, torch dtype) of a batch leaf: a tensor or host array."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    a = np.asarray(v)
    return a.shape, torch.from_numpy(np.empty((0,), a.dtype)).dtype


class CompiledTrainStep:
    """``step(state, batch) -> (state, metrics)``, compiled as the
    reference's loop compiles its step: ``jax.jit(make_train_step(...),
    donate_argnums=(0,))``.

    * **Donated state.**  The first call takes over the ``TrainState``
      it is given: its parameters and moments become the step's fixed
      buffers (the parameter leaves get ``requires_grad`` once; the
      optimizer step stays a device tensor).  Each step updates them in
      place and returns that same ``TrainState``: the offloaded update
      is bound with the parameters and moments donated
      (``UPDATE_DONATE``), so each of its fused segments writes a leaf's
      new values into the leaf's own storage, and ``write_back`` copies
      only the rest (the leaves the update leaves far, the optimizer
      step, every leaf of a step that is not offloaded;
      ``last_copied`` lists them).  A later call with any other state raises
      ``ValueError``, as a donated buffer is invalid in the reference.
      A tied block's tensors are donated, differentiated and written
      once (``Ties``).
    * **Batch staging.**  A batch (host arrays, or tensors) goes into
      fixed device buffers by one non-blocking copy from a pinned mirror
      (``_Build.stage``); microbatches are views of those buffers, their
      gradients summed into fixed f32 buffers.
    * **One build a batch signature** (the leaves' shapes and dtypes and
      which keys are present), as ``jax.jit`` traces once a signature:
      the first step of a signature looks the offloaded loss and update
      plans up once (``bind``) and, on a CUDA device, runs the static
      step eagerly and captures it as ONE CUDA graph (``StepGraph``; the
      graphs of every signature share one memory pool); later steps
      replay it.
      ``counters["train_traces"]`` counts the builds (the jitted
      function's cache size).  A capture that fails raises.
    * **Counters as under jit.**  ``stats`` / ``update_stats`` (offloaded)
      show ``plan_misses == traces == 1`` and ``plan_hits == 0`` at a
      steady state; the capture, the replays and every microbatch past
      the first add nothing to ``bwd_plan_stats()``
      (``repeated_lookups``); launches are counted per replay.
    * **Guard epoch.**  A kernel-guard epoch change drops every graph and
      looked-up plan; the next step builds again (``train_traces``,
      ``kernel_replans``), as the reference re-jits.
    * **Metrics** (``loss``, ``grad_norm``, ``lr`` and, without
      microbatches, the loss's own ``moe_aux`` / ``tokens``) are 0-d
      device tensors copied out of the step's metrics buffer, so the
      next replay does not overwrite them.

    On a CPU device, or with ``capture=False``, the same static step
    runs eagerly every call, with the same counters."""

    def __init__(self, model: Model, tcfg: TrainConfig, *,
                 offload: bool | None = None, capture: bool = True):
        use_offload = _use_offload(tcfg, offload)
        self.model, self.tcfg = model, tcfg
        self.device = model.device
        self._capture = capture and self.device.type == "cuda"
        self.loss_fn = _loss_fn(model, tcfg, use_offload)
        self.update_fn = _update_fn(tcfg, use_offload, donate=True)
        self.offload = use_offload
        self.counters = {"train_traces": 0, "kernel_replans": 0}
        self._state: TrainState | None = None
        self._ties: Ties | None = None
        self._builds: dict[tuple, _Build] = {}
        self._acc: list[torch.Tensor] | None = None
        self._pool = None
        self._graph: StepGraph | None = None
        self._last: _Build | None = None
        self._guard_epoch = kernel_guard().epoch
        if use_offload:
            self.stats = self.loss_fn.stats
            self.update_stats = self.update_fn.stats

    @property
    def graph(self) -> StepGraph | None:
        """The graph the last step replayed or captured (None eager)."""
        return self._graph

    @property
    def last_copied(self) -> list[int]:
        """The state slots (``_unique_state`` order: parameters, step,
        moments) the last built step copied its update's values into;
        the others were written in place."""
        return list(self._last.copied) if self._last is not None else []

    # -- the donated state ------------------------------------------------
    def _take(self, state: TrainState) -> None:
        if self._state is None:
            leaves = pytree.tree_leaves(state)
            bad = [t.device for t in leaves
                   if t.device.type != self.device.type]
            if bad:
                raise ValueError(f"the state must lie on {self.device}; "
                                 f"leaves on {bad[0]}")
            self._ties = Ties(state.params)
            for p in self._ties.unique(state.params):
                p.requires_grad_(True)
            self._state = state
            return
        if state is self._state:
            return
        if not isinstance(state, TrainState) or any(
                a is not b for a, b in zip(pytree.tree_leaves(state),
                                           pytree.tree_leaves(self._state))):
            raise ValueError(
                "this compiled step owns the state it was first given "
                "(donated, as in the reference's jitted step): pass the "
                "state it returned")

    def _unique_state(self, state: TrainState) -> list[torch.Tensor]:
        """The state's unique tensors: parameters, step, moments."""
        return [*self._ties.unique(state.params),
                *pytree.tree_leaves(_unique_opt(self._ties, state.opt))]

    def _fixed_buffers(self) -> list[torch.Tensor]:
        """Every buffer a static step writes, each once."""
        out = [t.data for t in self._unique_state(self._state)]
        out += [b.metrics for b in self._builds.values()
                if b.metrics is not None]
        return out + list(self._acc or [])

    # -- the static step --------------------------------------------------
    def _grads(self, b: _Build, params, batch):
        """(loss, metrics, one gradient a unique leaf) of one
        (micro)batch: the loss plan looked up at the build's first run."""
        if b.loss_run is None:
            b.loss_run = (self.loss_fn.bind(params, batch) if self.offload
                          else self.loss_fn)
        loss, metrics = b.loss_run(params, batch)
        grads = torch.autograd.grad(loss, self._ties.unique(params))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def _static_step(self, b: _Build) -> torch.Tensor:
        """One training step on the fixed buffers only (what the graph
        captures): gradients of the staged batch, the update written into
        the state's storage, the metrics into ``b.metrics`` (returned).
        Mirrors ``make_train_step``'s arithmetic op for op."""
        repeat = repeated_lookups() if b.runs else nullcontext()
        b.runs += 1
        st, n = self._state, self.tcfg.microbatches
        with repeat:
            if n <= 1:
                loss, metrics, grads = self._grads(b, st.params, b.batch)
            else:
                if self._acc is None:
                    self._acc = [torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                                 for p in self._ties.unique(st.params)]
                loss_sum = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
                for a in self._acc:
                    a.zero_()
                for i in range(n):
                    mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                          for k, v in b.batch.items()}
                    with repeated_lookups() if i else nullcontext():
                        loss, _, g = self._grads(b, st.params, mb)
                    with torch.no_grad():
                        for a, gi in zip(self._acc, g):
                            a.add_(gi)
                    loss_sum = loss_sum + loss
                inv = 1.0 / n
                grads = [a * inv for a in self._acc]
                loss = loss_sum * inv
                metrics = {"loss": loss}
            with torch.no_grad():
                args = (self._ties.unique(st.params), grads,
                        _unique_opt(self._ties, st.opt))
                if b.update_run is None:
                    b.update_run = (self.update_fn.bind(*args)
                                    if self.offload else self.update_fn)
                params, opt, gnorm, lr = b.update_run(*args)
                b.copied = write_back(self._unique_state(st),
                                      [*params, *pytree.tree_leaves(opt)])
                metrics = {**metrics, "grad_norm": gnorm, "lr": lr,
                           "loss": metrics.get("loss", loss)}
                if b.metrics is None:
                    b.keys = list(metrics)
                    b.metrics = torch.zeros((len(b.keys),),
                                            dtype=torch.float32,
                                            device=self.device)
                b.metrics.copy_(torch.stack([metrics[k].float().reshape(())
                                             for k in b.keys]))
        return b.metrics

    # -- calls ------------------------------------------------------------
    def _check_guard_epoch(self) -> None:
        """A change of kernel health drops every graph and looked-up
        plan, so that each signature builds again, as the reference
        re-jits (``kernel_replans``)."""
        if kernel_guard().epoch != self._guard_epoch:
            self._guard_epoch = kernel_guard().epoch
            self.counters["kernel_replans"] += 1
            for b in self._builds.values():
                b.graph, b.built, b.runs = None, False, 0
                b.loss_run = b.update_run = None
            self._graph = self._pool = None

    def __call__(self, state: TrainState, batch: dict
                 ) -> tuple[TrainState, dict]:
        self._take(state)
        self._check_guard_epoch()
        key = tuple((k, *_leaf_meta(batch[k])) for k in sorted(batch))
        b = self._builds.get(key)
        if b is None:
            b = self._builds[key] = _Build(batch, self.device)
        b.stage(batch)
        if b.graph is not None:
            b.graph.replay()
        elif not b.built:
            self.counters["train_traces"] += 1
            if self._capture:
                if self._pool is None and self.device.type == "cuda":
                    self._pool = torch.cuda.graph_pool_handle()
                b.graph = StepGraph(functools.partial(self._static_step, b),
                                    self.device, pool=self._pool)
            else:
                self._static_step(b)
            b.built = True
        else:
            self._static_step(b)
        self._graph, self._last = b.graph, b
        values = b.metrics.clone()
        return self._state, dict(zip(b.keys, values.unbind()))


def make_eval_step(model: Model, tcfg: TrainConfig, *,
                   offload: bool | None = None):
    """Returns ``eval_step(params, batch) -> metrics`` (no gradients)."""
    def eval_step(params, batch):
        _, metrics = model.loss_fn(params, batch, remat=False)
        return metrics

    fn = _offloaded(eval_step, tcfg) if _use_offload(tcfg, offload) \
        else eval_step

    @torch.no_grad()
    def run(params, batch):
        return fn(params, device_batch(batch, model.device))
    return run
