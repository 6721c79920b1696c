"""The program's own spans (`haff_tpu_torch.utils.profiling.span`: the
`predictor.*` and `evaluate.*` ranges) read from the traced window's
trace: their host time, and the device-idle time they hold. Only
`Trace`'s public attributes are read, so a program that opens no such
span gives None, not an error.

Idle time is the window less the union of the device's intervals; the
idle under a set of spans is its intersection with the union of their
intervals, so a gap that runs from one request's post-processing into
the next one's collate is split between the two at the span's edge.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Interval = Tuple[int, int]


def named(trace, names: Iterable[str]) -> List[Interval]:
    """The union of the ranges named in `names` that start in the window,
    clipped to it, in order."""
    names = set(names)
    ivs = sorted((max(t0, trace.t0), min(t1, trace.t1))
                 for t0, t1, name, _ in trace.spans
                 if name in names and trace.t0 <= t0 <= trace.t1)
    out: List[List[int]] = []
    for t0, t1 in ivs:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        elif t1 > t0:
            out.append([t0, t1])
    return [tuple(x) for x in out]


def idle(trace) -> List[Interval]:
    """The window's intervals with no device operation running."""
    out, t = [], trace.t0
    for a, b in trace.busy_intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        out.append((t, trace.t1))
    return out


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _per_request(ctx, ns):
    return 1e-6 * ns / len(ctx.traced)


def host_ms_per_req(ctx, name: str):
    """Host ms a traced request spends inside the ranges named `name`."""
    if ctx.trace is None or not ctx.traced:
        return None
    ivs = named(ctx.trace, [name])
    return _per_request(ctx, sum(b - a for a, b in ivs)) if ivs else None


def idle_ms_per_req(ctx, names: Iterable[str]):
    """Device-idle ms a traced request spends under the ranges named in
    `names`."""
    if ctx.trace is None or not ctx.traced:
        return None
    ivs = named(ctx.trace, names)
    return _per_request(ctx, overlap_ns(ivs, idle(ctx.trace))) if ivs else None
