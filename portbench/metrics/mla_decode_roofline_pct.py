"""Share of its roofline that the MLA decode kernel reaches: the
`mla_decode_attn` kernels in the traced window's device trace (inside
the decode graph's replays, matched by kernel name) against the bound
max(bytes / peak bytes/s, operations / peak FLOP/s) of every launch the
traced requests replayed, counted by flops/mla_decode_attn.py from the
live latent slots: row r at fed step t holds its prompt, the tokens fed
before and the new one, the count stopping where the row served EOS. %."""

from ..registry import flops

KERNEL = "mla_decode_attn"


def launches(ctx):
    """(live slots, B, lmax) of each launch the traced requests
    replayed, or None without the driver's record."""
    cfg = ctx.cfg
    steps = cfg["lisa"]["max_new_tokens"]
    out = []
    for i in sorted(ctx.traced):
        rows = getattr(ctx.driver, "outputs", {}).get(i)
        if not rows or not isinstance(rows, list) or "prompt_len" not in rows[0]:
            return None
        lmax = rows[0]["prompt_experts"].shape[0] + steps
        for t in range(steps - 1):
            live = sum(r["prompt_len"] + min(t, len(r["served"]) - 1) + 1
                       for r in rows)
            out.extend([(live, len(rows), lmax)] * cfg["num_hidden_layers"])
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
    count = flops("mla_decode_attn").count
    width = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    bound = 0.0
    for live, b, lmax in calls:
        c = count(live, b, lmax, cfg["num_attention_heads"], width,
                  cfg["kv_lora_rank"])
        bound += max(c["bytes"] / ctx.peak_bytes_per_s, c["flops"] / ctx.peak_flops)
    return 100.0 * bound / secs
