"""Tracing and profiling (port of haff_tpu/utils/profiling.py).

The reference has no tracing beyond per-step second counters (SURVEY.md
section 5.1). Here: `torch.profiler` traces of the host and the card to
a Chrome-trace file, named scopes that show in those traces and, on the
card, as NVTX ranges, and a per-step wall timer that synchronizes the
card before it reads the clock.

JAX's `start_profiler_server` (a live capture endpoint for TensorBoard)
has no PyTorch counterpart and raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def start_profiler_server(port: int = 9999) -> None:
    """Not available: torch has no live profiler server; capture a trace
    with `trace` instead."""
    raise NotImplementedError(
        "start_profiler_server: PyTorch has no live profiler server to "
        "connect TensorBoard to; capture a trace with "
        "haff_tpu_torch.utils.profiling.trace(log_dir) instead")


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None
          ) -> Iterator[torch.profiler.profile]:
    """Capture a host (and, with `cuda`, card) trace of the enclosed
    block into log_dir/trace.json (Chrome trace format):

        with trace("runs/exp/trace") as prof:
            step(...)
            torch.cuda.synchronize()
        prof.key_averages()

    `cuda` defaults to whether a card is present."""
    os.makedirs(log_dir, exist_ok=True)
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named scope visible in traces (`record_function`) and, on the card,
    as an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Per-step wall timing; `tick` synchronizes the card (when one is in
    use) before reading the clock, since PyTorch returns before the device
    finishes."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.total = 0.0

    def tick(self, sync: bool = True) -> float:
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.steps += 1
        self.total += dt
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.steps, 1)
