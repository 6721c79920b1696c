"""Greedy autoregressive generation with hidden-state capture (port of
haff_tpu/infer/generate.py `greedy_generate`).

A Python loop over decode steps on a ragged per-row KV cache: each step
yields the emitted token and the post-final-norm hidden state that
emitted it, which is what the [SEG] gather needs. Right-padded prompts
are supported; each row writes its cache at its own length, and a row
that has emitted EOS keeps emitting EOS and stops growing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.config import LlamaConfig
from ..nn.quant import QuantArray


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # (B, T) emitted tokens (EOS-padded)
    hiddens: torch.Tensor   # (B, T, E) hidden state that emitted each token
    lengths: torch.Tensor   # (B,) tokens emitted before EOS (<= T)


@torch.inference_mode()
def greedy_generate(cfg: LlamaConfig, embed_fn: Callable, llm_fn: Callable,
                    prompt_embeds, prompt_positions, prompt_segment_ids,
                    prompt_lengths, max_new_tokens: int, eos_id: int,
                    cache_dtype=torch.bfloat16,
                    kv_cache_8bit: bool = False) -> GenerateResult:
    """embed_fn(tokens (B, 1)) -> (B, 1, E); llm_fn(embeds, positions,
    segment_ids, kv_caches, cache_index, cache_kv_segment_ids) ->
    (logits, hidden, kv_caches). prompt_*: spliced prompt (B, L, ...);
    prompt_lengths (B,) real token counts. The caches are updated in
    place. The cache dtype defaults to bfloat16 as in the JAX package;
    `kv_cache_8bit` stores it as int8 with per token-head float32 scales
    (nn/quant.QuantArray) instead."""
    b, l, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    max_len = l + max_new_tokens
    shape = (b, max_len, cfg.num_kv_heads, cfg.head_dim)

    def one_cache():
        if kv_cache_8bit:
            return QuantArray(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                           device=dev))
        return torch.zeros(shape, dtype=cache_dtype, device=dev)

    caches = [(one_cache(), one_cache()) for _ in range(cfg.num_layers)]
    lengths = prompt_lengths.long()
    logits, hidden, caches = llm_fn(
        prompt_embeds, prompt_positions, prompt_segment_ids, caches,
        torch.zeros((b,), dtype=torch.long, device=dev), None)
    rows = torch.arange(b, device=dev)
    last = (lengths - 1).clamp(min=0)
    last_logits, last_hidden = logits[rows, last], hidden[rows, last]

    slots = torch.arange(max_len, device=dev)[None, :]
    kv_seg = (slots < lengths[:, None]).to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tokens, hiddens, was_done = [], [], []
    for step in range(max_new_tokens):
        token = torch.argmax(last_logits, dim=-1)
        token = torch.where(done, torch.full_like(token, eos_id), token)
        tokens.append(token)
        hiddens.append(last_hidden)
        was_done.append(done)
        new_done = done | (token == eos_id)
        if step == max_new_tokens - 1:
            break  # the last step's forward would feed no later token
        kv_seg = torch.where(slots == lengths[:, None], 1, kv_seg)
        logits, hidden, caches = llm_fn(
            embed_fn(token[:, None]), lengths[:, None], None, caches,
            lengths, kv_seg)
        lengths = torch.where(new_done, lengths, lengths + 1)
        last_logits, last_hidden = logits[:, 0], hidden[:, 0]
        done = new_done
    was_done = torch.stack(was_done, dim=1)
    return GenerateResult(tokens=torch.stack(tokens, dim=1).to(torch.int32),
                          hiddens=torch.stack(hiddens, dim=1),
                          lengths=(~was_done).sum(dim=1).to(torch.int32))
