"""Tracing (port of haff_tpu/utils/profiling.py).

The reference has no tracing beyond per-step second counters (SURVEY.md
section 5.1). Here: `torch.profiler` traces of the host and the card to
a Chrome-trace file (`trace`), and the program's spans (`span`), named
ranges at its layer boundaries that show in those traces.

A span is a `record_function` range while a profiler collects, and
nothing otherwise. The trace is its only record: ranges nest, so a
span's parent is the range that encloses it, and Kineto stamps host
ranges and the card's activity on one clock, so a span can be set
against what the card was doing. Under
`torch.autograd.profiler.emit_nvtx()` every span is an NVTX range too.
JAX's `start_profiler_server` (a live capture endpoint for TensorBoard)
has no PyTorch counterpart.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the enclosed host work `name` in a
    profiler's trace. With no profiler collecting it is one shared no-op
    context: one flag read, no range opened."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


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
