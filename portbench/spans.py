"""The benchmark's own spans around calls into the program's layers, set
from outside the program: wrappers on instance attributes and forward
hooks. Each span is a `torch.profiler.record_function` range (so a trace
names what the host was doing) and, where asked, a pair of CUDA events
(device time of what the span enqueued) and a host clock reading.
Spans are kept in memory and read when the window has closed.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled = enabled
        self.cuda = cuda  # CUDA events and synchronizes only on the card
        self.host = defaultdict(list)     # name -> [(request, seconds)]
        self._events = defaultdict(list)  # name -> [(start, end, per)]
        self.request_index = 0

    def wrap(self, obj, attr: str, name: str, device: bool = False,
             sync: bool = False, per: float = 1.0):
        """Replace obj.<attr> by a wrapper that opens a span around each
        call: a range named `name`, the host seconds of the call (with
        `sync`, ending in a synchronize, so the call's device work is
        inside), and with `device` CUDA events around it, their time
        divided by `per`."""
        if not self.enabled:
            return
        inner = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            with record_function(name):
                ev = self._open(device)
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                self._close(name, ev, per)
                if sync and self.cuda:
                    torch.cuda.synchronize()
                self.host[name].append((self.request_index,
                                        time.perf_counter() - t0))
            return out

        setattr(obj, attr, wrapper)

    def hook(self, module: torch.nn.Module, name: str):
        """Forward hooks on `module`: a range named `name` around each
        forward."""
        if not self.enabled:
            return
        state = {}

        def pre(mod, args):
            state["rf"] = record_function(name)
            state["rf"].__enter__()

        def post(mod, args, out):
            state["rf"].__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    def _open(self, device: bool):
        if not (device and self.cuda):
            return None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        return ev

    def _close(self, name, ev, per):
        if ev is not None:
            ev[1].record()
            self._events[name].append((ev[0], ev[1], per))

    def device_ms(self, name: str):
        """Per-call device milliseconds of span `name` (divided by its
        `per`), read once the window has closed."""
        if not self.cuda:
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / per for a, b, per in self._events[name]]
