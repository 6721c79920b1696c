"""Share of their roofline that the SAM rel-pos attention calls reach:
the sum over the traced calls of the `haff::sam_window_relpos_attn` and
`haff::sam_global_relpos_attn` operators of the bound time, max(bytes /
peak bytes/s, operations / peak FLOP/s) counted from each call's
shapes by flops/sam_relpos_attn.py, over the device time of the kernels
the calls launched. %."""

from ..registry import flops

OPS = ("haff::sam_window_relpos_attn", "haff::sam_global_relpos_attn")


def read(ctx):
    if ctx.trace is None:
        return None
    count = flops("sam_relpos_attn").count
    bound = secs = 0.0
    for _, shapes, s in ctx.trace.op_kernels(OPS):
        b, l, nh, d = shapes[0]
        h, w = (shapes[3][0] + 1) // 2, (shapes[4][0] + 1) // 2
        c = count(b, l, nh, d, h, w)
        bound += max(c["bytes"] / ctx.peak_bytes_per_s,
                     c["flops"] / ctx.peak_flops)
        secs += s
    return 100.0 * bound / secs if secs > 0 else None
