"""Share of its roofline that the routed-expert decode kernel reaches:
the `moe_decode` kernels in the traced window's device trace (inside the
decode graph's replays, matched by kernel name) against the bound
max(bytes / peak bytes/s, operations / peak FLOP/s) of every launch the
traced requests replayed, counted by flops/moe_decode.py from the
experts the program chose at each step and layer (the driver's record
of `GenerateResult.expert_ids`) and the shared experts, which the same
launch computes. %."""

from ..registry import flops

KERNEL = "moe_decode"


def launches(ctx):
    """(experts, B, k) of each launch the traced requests replayed: every
    fed step of every MoE layer. None without the routing record."""
    out = []
    for i in sorted(ctx.traced):
        rows = getattr(ctx.driver, "outputs", {}).get(i)
        if not rows or not isinstance(rows, list) or "decode_experts" not in rows[0]:
            return None
        ids = [r["decode_experts"] for r in rows]   # (T, layers, k) each
        steps, layers, k = ids[0].shape
        for t in range(steps - 1):                  # the last feeds nothing
            for j in range(layers):
                chosen = {int(e) for r in ids for e in r[t, j]}
                out.append((len(chosen), len(rows), k))
    return out


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    calls = launches(ctx)
    secs = sum(t1 - t0 for t0, t1, name, _ in ctx.trace.device
               if KERNEL in name and ctx.trace.t0 <= t0 <= ctx.trace.t1) / 1e9
    if not calls or secs <= 0:
        return None
    cfg = ctx.cfg
    count = flops("moe_decode").count
    bound = 0.0
    for experts, b, k in calls:
        c = count(experts, b, k, cfg["moe_intermediate_size"], cfg["hidden_size"],
                  cfg["n_shared_experts"])
        bound += max(c["bytes"] / ctx.peak_bytes_per_s, c["flops"] / ctx.peak_flops)
    return 100.0 * bound / secs
