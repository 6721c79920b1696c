"""Device ms of the SAM image encoder an image: the kernels launched
inside the encoder's forward range (a forward hook), summed from the
trace, so time the launches spend queued behind other work is not in
it."""


def read(ctx):
    if ctx.trace is None:
        return None
    secs = ctx.trace.span_kernels("sam_encoder")
    return 1e3 * sum(secs) / len(secs) if secs else None
