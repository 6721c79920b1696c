"""Seconds from the process's start to the window's: imports, the
kernels' load (their build in a checkout's first run), the seeded
weights, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
