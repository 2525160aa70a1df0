"""The capture driver of the port's compiled functions: one static
function as ONE CUDA graph.

The serving engine's static functions (the decode step, admit a prompt
bucket, the prefill chunk, the slot controls) and the compiled training
step (``train.step.compile_train_step``) are each built by ``StepGraph``:
a warm eager call whose results stand, then a capture that every later
call replays.  A static function reads and writes fixed buffers only, so
the addresses frozen into the graph stay right at every replay.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels.guard import kernel_guard


class StepGraph:
    """A static function as ONE CUDA graph.  ``fn`` runs once eagerly on
    a side stream (a real call, whose results stand: it builds and loads
    every kernel the function launches), then is captured, which runs
    nothing; ``replay()`` launches every captured kernel and counts the
    launches the capture recorded (``kernel_guard().recording()``).
    ``fn`` returns its output tensor: a captured one, which each replay
    rewrites, holds the warm call's values until the first replay.
    ``memory`` holds ``max_memory_allocated`` / ``memory_reserved``
    before and after the capture (the growth of the reserved bytes is
    what the graph added to its pool: a private one, or ``pool``, a
    handle shared with other graphs), ``seconds`` the host time of the
    warm call and the capture, ``warm_seconds`` that of the warm call."""

    def __init__(self, fn, device: torch.device, pool=None):
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm = fn()
        torch.cuda.current_stream(device).wait_stream(side)
        # what the capture does on entry, so that ``before`` counts no
        # cached block the capture would release
        torch.cuda.synchronize(device)
        self.warm_seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        before = (torch.cuda.max_memory_allocated(device),
                  torch.cuda.memory_reserved(device))
        self.graph = torch.cuda.CUDAGraph()
        with kernel_guard().recording() as self.launches, \
                torch.cuda.graph(self.graph, pool=pool,
                                 capture_error_mode="global"):
            out = fn()
        if out is not warm:
            out.copy_(warm)
        self.memory = {
            "max_allocated": (before[0],
                              torch.cuda.max_memory_allocated(device)),
            "reserved": (before[1], torch.cuda.memory_reserved(device))}
        self.seconds = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replay()
