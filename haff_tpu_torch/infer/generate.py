"""Greedy autoregressive generation with hidden-state capture (port of
haff_tpu/infer/generate.py `greedy_generate`).

Decode steps on a ragged per-row KV cache: each step yields the emitted
token and the post-final-norm hidden state that emitted it, which is what
the [SEG] gather needs. Right-padded prompts are supported; each row
writes its cache at its own length, and a row that has emitted EOS keeps
emitting EOS and stops growing.

The work is split in three so that the decode loop can be captured in a
CUDA graph (infer/evaluate.py make_jitted_evaluate): `DecodeState`
allocates every tensor the loop touches, `prefill` fills it from the
prompt, and `decode_loop` reads and writes only those tensors, in place,
with no host synchronisation. `greedy_generate` runs the three eagerly.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from ..core.config import LlamaConfig
from ..nn.quant import QuantArray


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # (B, T) emitted tokens (EOS-padded)
    hiddens: torch.Tensor   # (B, T, E) hidden state that emitted each token
    lengths: torch.Tensor   # (B,) tokens emitted before EOS (<= T)


class DecodeState:
    """Every tensor the decode loop reads or writes, allocated once for a
    (batch, prompt length, new tokens, cache kind) bucket: the KV caches
    (bfloat16 tensors by default, as in the JAX package, or int8
    QuantArrays with per token-head float32 scales), the rows' lengths,
    the live-slot mask `kv_seg`, the `done` flags, the last step's logits
    and hidden state, and the emitted tokens, hidden states and done
    flags of every step. The logits and hidden-state buffers take the
    dtype of the first prefill's outputs."""

    def __init__(self, cfg: LlamaConfig, batch: int, prompt_len: int,
                 max_new_tokens: int, device, cache_dtype=torch.bfloat16,
                 kv_cache_8bit: bool = False):
        b, t = batch, max_new_tokens
        self.max_len = prompt_len + t
        shape = (b, self.max_len, cfg.num_kv_heads, cfg.head_dim)

        def one_cache():
            if kv_cache_8bit:
                return QuantArray(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                               device=device))
            return torch.zeros(shape, dtype=cache_dtype, device=device)

        self.caches: List = [(one_cache(), one_cache())
                             for _ in range(cfg.num_layers)]
        new = lambda *s, dtype: torch.zeros(s, dtype=dtype,  # noqa: E731
                                            device=device)
        self.lengths = new(b, dtype=torch.long)
        self.kv_seg = new(b, self.max_len, dtype=torch.int32)
        self.done = new(b, dtype=torch.bool)
        self.last_logits = self.last_hidden = self.hiddens = None
        self.tokens = new(b, t, dtype=torch.long)
        self.was_done = new(b, t, dtype=torch.bool)
        self.slots = torch.arange(self.max_len, device=device)[None, :]

    def reset_caches(self) -> None:
        """Zero the caches (unit scales), as a freshly allocated state."""
        for pair in self.caches:
            for c in pair:
                if isinstance(c, QuantArray):
                    c.values.zero_()
                    c.scales.fill_(1.0)
                else:
                    c.zero_()

    def result(self) -> GenerateResult:
        return GenerateResult(
            tokens=self.tokens.to(torch.int32), hiddens=self.hiddens,
            lengths=(~self.was_done).sum(dim=1).to(torch.int32))


def prefill(state: DecodeState, llm_fn: Callable, prompt_embeds,
            prompt_positions, prompt_segment_ids, prompt_lengths) -> None:
    """Run the prompt through `llm_fn`, writing its k/v into the state's
    caches, and set the rows' lengths, live slots, last logits and hidden
    state; no row is done."""
    b = prompt_embeds.shape[0]
    dev = prompt_embeds.device
    lengths = prompt_lengths.long()
    logits, hidden, _ = llm_fn(
        prompt_embeds, prompt_positions, prompt_segment_ids, state.caches,
        torch.zeros((b,), dtype=torch.long, device=dev), None)
    rows = torch.arange(b, device=dev)
    last = (lengths - 1).clamp(min=0)
    if state.last_logits is None:
        t = state.tokens.shape[1]
        state.last_logits = logits.new_empty((b, logits.shape[-1]))
        state.last_hidden = hidden.new_empty((b, hidden.shape[-1]))
        state.hiddens = hidden.new_empty((b, t, hidden.shape[-1]))
    state.last_logits.copy_(logits[rows, last])
    state.last_hidden.copy_(hidden[rows, last])
    state.lengths.copy_(lengths)
    state.kv_seg.copy_(state.slots < lengths[:, None])
    state.done.zero_()


def decode_loop(state: DecodeState, embed_fn: Callable, llm_fn: Callable,
                max_new_tokens: int, eos_id: int) -> None:
    """The greedy steps after `prefill`, in place on `state`: each step
    emits the argmax of the last logits (EOS for a done row), records it
    with the hidden state that emitted it, and, but for the last step,
    feeds it through `llm_fn` at the row's length. Reads and writes only
    the state's tensors and never waits for the device."""
    eos = torch.full_like(state.lengths, eos_id)
    for step in range(max_new_tokens):
        token = torch.where(state.done, eos,
                            torch.argmax(state.last_logits, dim=-1))
        state.tokens[:, step] = token
        state.hiddens[:, step] = state.last_hidden
        state.was_done[:, step] = state.done
        new_done = state.done | (token == eos_id)
        if step == max_new_tokens - 1:
            break  # the last step's forward would feed no later token
        lengths = state.lengths
        state.kv_seg.masked_fill_(state.slots == lengths[:, None], 1)
        logits, hidden, _ = llm_fn(
            embed_fn(token[:, None]), lengths[:, None], None, state.caches,
            lengths, state.kv_seg)
        lengths.copy_(torch.where(new_done, lengths, lengths + 1))
        state.last_logits.copy_(logits[:, 0])
        state.last_hidden.copy_(hidden[:, 0])
        state.done.copy_(new_done)


@torch.inference_mode()
def greedy_generate(cfg: LlamaConfig, embed_fn: Callable, llm_fn: Callable,
                    prompt_embeds, prompt_positions, prompt_segment_ids,
                    prompt_lengths, max_new_tokens: int, eos_id: int,
                    cache_dtype=torch.bfloat16,
                    kv_cache_8bit: bool = False) -> GenerateResult:
    """embed_fn(tokens (B, 1)) -> (B, 1, E); llm_fn(embeds, positions,
    segment_ids, kv_caches, cache_index, cache_kv_segment_ids) ->
    (logits, hidden, kv_caches), the caches updated in place.
    prompt_*: spliced prompt (B, L, ...); prompt_lengths (B,) real token
    counts. The cache dtype defaults to bfloat16 as in the JAX package;
    `kv_cache_8bit` stores it as int8 with per token-head float32 scales
    (nn/quant.QuantArray) instead."""
    b, l, _ = prompt_embeds.shape
    state = DecodeState(cfg, b, l, max_new_tokens, prompt_embeds.device,
                        cache_dtype, kv_cache_8bit)
    prefill(state, llm_fn, prompt_embeds, prompt_positions,
            prompt_segment_ids, prompt_lengths)
    decode_loop(state, embed_fn, llm_fn, max_new_tokens, eos_id)
    return state.result()
