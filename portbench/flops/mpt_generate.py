"""Greedy generation with MPT: the prefill over `prompt` positions (all
of them through the LM head, as a forward pass computes them), then one
forward a token for the `steps - 1` tokens fed back (the last emitted
token is fed to nothing), each over the live slots."""

import importlib


def count(mpt: dict, prompt: int, steps: int) -> dict:
    fwd = importlib.import_module(__package__ + ".mpt_forward").count
    total = fwd(mpt, prompt, (prompt + 1) / 2, prompt)["flops"]
    for t in range(1, steps):
        total += fwd(mpt, 1, prompt + t, 1)["flops"]
    return {"flops": total}
