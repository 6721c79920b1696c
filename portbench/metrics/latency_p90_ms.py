"""90th percentile of every answered request's time from send to
result, in ms (numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_s) * 1e3, 90))
