"""One reader a metric: `read(ctx) -> float or None`. `ctx` is what one
run gathered (harness.py): the window's latencies and answered requests,
set-up seconds, the peak memory, the benchmark's spans, the traced
sub-window's trace, the analytic operations a request and the peaks. A
reader that finds nothing to read returns None, and the metric is left
out of the line.
"""


def untraced(ctx):
    """(request, latency seconds) of the answered requests outside the
    traced sub-window."""
    return [(i, s) for i, s in zip(ctx.done, ctx.latencies_s)
            if i not in ctx.traced]
