"""One MPT forward over `positions` new tokens that attend to `context`
keys each on average (causal prefill: (positions + 1) / 2; a decode step:
the live slots), with the tied LM head over `lm_positions` tokens."""


def count(mpt: dict, positions: int, context: float, lm_positions: int) -> dict:
    d = mpt["d_model"]
    f = mpt["expansion_ratio"] * d
    dense = 2 * positions * (4 * d * d + 2 * d * f)
    attn = 2 * 2 * positions * context * d
    head = 2 * lm_positions * d * mpt["vocab_size"]
    return {"flops": mpt["n_layers"] * (dense + attn) + head}
