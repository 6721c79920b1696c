"""Greedy generation with DeepSeek-V3: the prefill over `prompt`
positions (all of them through the LM head), then one absorbed decode
forward a token for the `steps - 1` tokens fed back, each over the live
slots."""

import importlib


def count(cfg: dict, prompt: int, steps: int) -> dict:
    fwd = importlib.import_module(__package__ + ".deepseek_v3_forward").count
    total = fwd(cfg, prompt, (prompt + 1) / 2, prompt)["flops"]
    for t in range(1, steps):
        total += fwd(cfg, 1, prompt + t, 1, absorbed=True)["flops"]
    return {"flops": total}
