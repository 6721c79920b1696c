"""One DeepSeek-V3 forward (the configuration's published keys) over
`positions` new tokens that attend to `context` keys each on average,
with the untied LM head over `lm_positions` tokens. Active parameters
only: each MoE layer counts its router, `num_experts_per_tok` routed
experts and the shared experts. The prefill's MLA decompresses k and v
(`kv_b_proj` a position, scores over nope + rope, values of v_head_dim);
a decode step (`absorbed`) folds W_UK into the query and W_UV into the
output, and scores and sums the latent slots (kv_lora_rank + rope,
kv_lora_rank)."""


def count(cfg: dict, positions: int, context: float, lm_positions: int,
          absorbed: bool = False) -> dict:
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rp, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    proj = d * nh * (nope + rp) + d * (rank + rp) + nh * vd * d
    if absorbed:
        proj += nh * (nope * rank + vd * rank)
        attn = nh * context * ((rank + rp) + rank)
    else:
        proj += rank * nh * (nope + vd)
        attn = nh * context * ((nope + rp) + vd)
    dense = 3 * d * cfg["intermediate_size"]
    moe = (d * cfg["n_routed_experts"]
           + 3 * d * cfg["moe_intermediate_size"]
           * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]))
    first = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    macs = positions * (layers * (proj + attn) + first * dense
                        + (layers - first) * moe)
    return {"flops": 2 * (macs + lm_positions * d * cfg["vocab_size"])}
