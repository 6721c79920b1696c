"""Kernel launches the host issued outside graph replays, a request of
the traced sub-window (the profiler's runtime launch calls)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    return ctx.trace.kernel_launches() / len(ctx.traced)
