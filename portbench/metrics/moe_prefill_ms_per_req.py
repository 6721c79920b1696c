"""Device ms of the routed experts of the prefill a traced request: the
kernels launched inside the program's `moe.experts` spans (the sort by
expert, the grouped products, the weighted sum), summed from the trace,
so time they spend queued behind other work is not in it. The decode's
experts replay from the graph and open no span."""


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    secs = ctx.trace.span_kernels("moe.experts")
    return 1e3 * sum(secs) / len(ctx.traced) if secs else None
