"""Device ms of one step of the graphed decode: CUDA events around each
replay of the decode graph, divided by its steps."""


def read(ctx):
    ms = ctx.spans.device_ms("decode_replay") if ctx.spans.enabled else []
    return sum(ms) / len(ms) if ms else None
