"""The whole step's share of the card's peak: the model operations of
the answered requests outside the traced sub-window (the analytic count
from the configuration, flops/), over their seconds and the published
989 TFLOP/s (bf16, dense). %."""

from . import untraced


def read(ctx):
    rows = untraced(ctx)
    secs = sum(s for _, s in rows)
    if not rows or secs <= 0 or not ctx.flops_per_request:
        return None
    return 100.0 * ctx.flops_per_request * len(rows) / secs / ctx.peak_flops
