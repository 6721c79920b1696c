"""SAM ViT image encoder at its canvas: patch embedding, the blocks
(windowed blocks over the zero-padded window grid, as the model pads),
and the neck."""

import importlib


def count(enc: dict, batch: int = 1) -> dict:
    attn = importlib.import_module(__package__ + ".sam_relpos_attn").count
    c, ps = enc["embed_dim"], enc["patch_size"]
    g = enc["image_size"] // ps
    nh, hd = enc["num_heads"], enc["embed_dim"] // enc["num_heads"]
    m = int(c * enc["mlp_ratio"])
    ws = enc["window_size"]
    gp = -(-g // ws) * ws  # the padded grid of the windowed blocks
    total = 2 * g * g * c * 3 * ps * ps
    for i in range(enc["depth"]):
        if i in enc["global_attn_indexes"]:
            tokens = g * g
            a = attn(1, g * g, nh, hd, g, g)["flops"]
        else:
            tokens = gp * gp
            a = attn((gp // ws) ** 2, ws * ws, nh, hd, ws, ws)["flops"]
        total += 2 * tokens * c * 3 * c + a + 2 * g * g * (c * c + 2 * c * m)
    oc = enc["out_chans"]
    total += 2 * g * g * (c * oc + 9 * oc * oc)
    return {"flops": batch * total}
