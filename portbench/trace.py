"""Reading a torch.profiler trace of the traced window.

From the profiler's raw events (no per-event Python objects beyond one
tuple each): device operations (kernels, copies, sets), the host's
runtime calls, its operator and annotation ranges. Device busy time is
the union of the device operations' intervals, so operations that
overlap on several streams count once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

LAUNCH = ("LaunchKernel", "LaunchCooperativeKernel")


class Trace:
    def __init__(self, prof, window: str):
        """`window`: the name of the annotation that spans the traced
        requests."""
        # (t0, t1, name, correlation id): a kernel shares its launch's id; the
        # kernels of one graph replay share the graph launch's.
        self.device: List[Tuple[int, int, str, int]] = []
        self.runtime: List[Tuple[int, int, str, int, int]] = []  # (+ tid)
        self.ops: List[Tuple[int, int, str, int, list]] = []
        self.spans: List[Tuple[int, int, str, int]] = []
        for e in prof.profiler.kineto_results.events():
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation() and e.duration_ns() > 0:
                    self.device.append((t0, t1, name, e.correlation_id()))
            elif e.is_user_annotation():
                self.spans.append((t0, t1, name, e.start_thread_id()))
            elif name.startswith(("cuda", "cu")) and "::" not in name:
                self.runtime.append((t0, t1, name, e.correlation_id(),
                                     e.start_thread_id()))
            else:
                self.ops.append((t0, t1, name, e.start_thread_id(),
                                 e.shapes()))
        wins = [s for s in self.spans if s[2] == window]
        if not wins:
            raise RuntimeError(f"trace has no {window!r} range")
        self.t0 = min(s[0] for s in wins)
        self.t1 = max(s[1] for s in wins)
        self.device.sort()
        self.by_corr = defaultdict(list)
        for ev in self.device:
            self.by_corr[ev[3]].append(ev)
        self._launches = sorted(r for r in self.runtime
                                if any(k in r[2] for k in LAUNCH))
        self._launch_t = [r[0] for r in self._launches]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Union of the device operations' intervals, clipped to the
        window."""
        out: List[List[int]] = []
        for t0, t1, _, _ in self.device:
            t0, t1 = max(t0, self.t0), min(t1, self.t1)
            if t1 <= t0:
                continue
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_launches(self) -> int:
        """Kernel launches the host issued in the window (graph launches
        and copies not counted)."""
        return sum(1 for t0, _, name, _, _ in self.runtime
                   if self.t0 <= t0 <= self.t1
                   and any(k in name for k in LAUNCH))

    def top_device_ops(self, n: int = 10):
        sums: Dict[str, float] = defaultdict(float)
        for t0, t1, name, _ in self.device:
            if self.t0 <= t0 <= self.t1:
                sums[name] += (t1 - t0) / 1e9
        return sorted(([k, v] for k, v in sums.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The n longest gaps between device operations in the window,
        each named by the innermost annotation open at its start."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = sorted(s for s in self.spans if s[2] != "")
        starts = [s[0] for s in spans]
        out = []
        for a, b in gaps[:n]:
            k = bisect.bisect_right(starts, a)
            label = "none"
            for s in reversed(spans[max(0, k - 64):k]):
                if s[1] >= a:
                    label = s[2]
                    break
            out.append([label, (b - a) / 1e9])
        return out

    def _launched_s(self, t0, t1, tid) -> float:
        """Device seconds of what thread `tid` launched between t0 and t1."""
        lo = bisect.bisect_left(self._launch_t, t0)
        hi = bisect.bisect_right(self._launch_t, t1)
        return sum((k[1] - k[0]) / 1e9
                   for r in self._launches[lo:hi] if r[4] == tid
                   for k in self.by_corr.get(r[3], ()))

    def op_kernels(self, op_names) -> List[Tuple[str, list, float]]:
        """Each call of the named operators in the window with its input
        shapes and the device seconds of the kernels it launched."""
        return [(name, shapes, self._launched_s(t0, t1, tid))
                for t0, t1, name, tid, shapes in self.ops
                if name in op_names and self.t0 <= t0 <= self.t1]

    def span_kernels(self, name: str) -> List[float]:
        """The device seconds of the kernels launched inside each range
        named `name` in the window, whenever they ran."""
        return [self._launched_s(t0, t1, tid)
                for t0, t1, n, tid in self.spans
                if n == name and self.t0 <= t0 <= self.t1]
