"""Both 2HandedAfforder mask decoders on one prompt set: the two-way
transformer over the g x g embedding and `tokens` output + prompt
tokens, the upscaling, the hypernetworks, the IoU head and the left
decoder's taxonomy head."""


def _attn(nq, nk, d, inner):
    return 2 * (nq * d * inner + 2 * nk * d * inner + nq * inner * d) \
        + 2 * 2 * nq * nk * inner


def count(enc: dict, dec: dict, prompt_tokens: int, batch: int = 1) -> dict:
    d = dec["prompt_embed_dim"]
    g = enc["image_size"] // enc["patch_size"]
    n = dec["num_multimask_outputs"] + 1
    t = 1 + n + prompt_tokens
    hw = g * g
    di = d // dec["attention_downsample_rate"]
    mlp = dec["transformer_mlp_dim"]
    layer = (_attn(t, t, d, d) + _attn(t, hw, d, di) + 2 * 2 * t * d * mlp
             + _attn(hw, t, d, di))
    two_way = dec["transformer_depth"] * layer + _attn(t, hw, d, di)
    up = 2 * hw * d * (d // 4) * 4 + 2 * 4 * hw * (d // 4) * (d // 8) * 4
    hyper = n * 2 * (2 * d * d + d * (d // 8))
    masks = 2 * n * (d // 8) * 16 * hw
    h = dec["iou_head_hidden_dim"]
    iou = 2 * (d * h + (dec["iou_head_depth"] - 2) * h * h + h * n)
    one = two_way + up + hyper + masks + iou
    tax = 2 * ((d * n) ** 2 * 2 + d * n * dec["taxonomy_classes"])
    return {"flops": batch * (2 * one + tax)}
