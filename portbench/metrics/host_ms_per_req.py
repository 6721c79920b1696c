"""Host ms a request spends in the entry call outside its inner device
calls (the driver's `inner_spans`, each ending in a synchronize while
traced): collate, preprocessing, post-processing, copies. Requests
outside the profiled sub-window."""

from . import untraced


def read(ctx):
    inner = {}
    for name in ctx.driver.inner_spans:
        for req, secs in ctx.spans.host.get(name, ()):
            inner[req] = inner.get(req, 0.0) + secs
    rows = [lat - inner[i] for i, lat in untraced(ctx) if i in inner]
    return 1e3 * sum(rows) / len(rows) if rows else None
