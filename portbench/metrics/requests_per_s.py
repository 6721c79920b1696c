"""Requests answered over the whole window (the window ends with the
last answer)."""


def read(ctx):
    return len(ctx.done) / ctx.window_s if ctx.done else None
