"""Device ms of the MPT prefill a traced request: the kernels launched
inside the program's `evaluate.prefill` span, summed from the trace, so
time they spend queued behind other work is not in it."""


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    secs = ctx.trace.span_kernels("evaluate.prefill")
    return 1e3 * sum(secs) / len(ctx.traced) if secs else None
