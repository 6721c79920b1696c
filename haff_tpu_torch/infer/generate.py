"""Greedy and speculative generation with hidden-state capture (port of
haff_tpu/infer/generate.py: `greedy_generate`, `make_lookup_corpus`,
`answer_template_corpus`, `speculative_generate`).

Decode steps on a ragged per-row KV cache: each step yields the emitted
token and the post-final-norm hidden state that emitted it, which is what
the [SEG] gather needs. Right-padded prompts are supported; each row
writes its cache at its own length, and a row that has emitted EOS keeps
emitting EOS and stops growing. Each decoder drives it: the caches take
the LLaMA config's kv heads, or MPT's (1 with multi-query attention, else
every head; MPT ignores the positions, ALiBi); the deepseek_v3 decoder's
MLA keeps a latent cache instead, one (B, L, kv_lora_rank + rope) tensor
a layer, and the greedy state records the experts its MoE layers chose
at every prompt position and decode step (`GenerateResult.expert_ids`):
the decoder returns them as the fourth item of a forward asked
`with_aux`, and the prefill and each step copy them into static buffers.

The work is split so that the decode can be captured in a CUDA graph
(infer/evaluate.py make_jitted_evaluate): a state object allocates every
tensor the loop touches, `prefill` fills it from the prompt, and the loop
reads and writes only those tensors, in place, with no host
synchronisation. Greedy: `DecodeState` and `decode_loop` (all the steps;
one graph). Speculative: `SpeculativeState` and `verify_step` (one draft,
verify and accept step; one graph replayed while a row is live, JAX's
`while_loop` read on the host). `greedy_generate` and
`speculative_generate` run them eagerly.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from ..nn.quant import QuantArray
from ..utils.profiling import span


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # (B, T) emitted tokens (EOS-padded)
    hiddens: torch.Tensor   # (B, T, E) hidden state that emitted each token
    lengths: torch.Tensor   # (B,) tokens emitted before EOS (<= T)
    # decode forwards taken (a scalar; speculative_generate only: tokens
    # emitted / steps is the speculation's speed-up)
    steps: torch.Tensor = None
    # The deepseek_v3 decoder's routing, greedy only (else None): the
    # experts each MoE layer chose, int16, (prompt (B, L, layers, k),
    # decode (B, T, layers, k)); decode step t is the forward that fed
    # token t, and the last step, which feeds nothing, reads -1.
    expert_ids: tuple = None
    # The deepseek_v3 decoder's latent caches as the decode left them
    # (one tensor a layer, greedy only, else None): a caller may read what each
    # layer cached for every prompt position and fed token.
    latent_caches: list = None


def latent_cache_dim(cfg):
    """Values a token a layer of a latent (MLA) cache, or None for a
    decoder with (k, v) caches."""
    return getattr(cfg, "latent_dim", None)


def cache_geometry(cfg):
    """(layers, kv heads, head dim) of the caches of a decoder config:
    a LlamaConfig, or an nn/mpt.MptConfig (1 kv head with multi-query
    attention, else one a head); for a latent cache (deepseek_v3),
    (layers, 1, latent values)."""
    if latent_cache_dim(cfg) is not None:
        return cfg.num_layers, 1, cfg.latent_dim
    if hasattr(cfg, "n_layers"):
        return cfg.n_layers, 1 if cfg.multiquery else cfg.n_heads, cfg.head_dim
    return cfg.num_layers, cfg.num_kv_heads, cfg.head_dim


def alloc_caches(cfg, batch: int, max_len: int, device,
                 cache_dtype=torch.bfloat16, kv_cache_8bit: bool = False):
    """One (k, v) pair a layer of zeroed (B, max_len, nkv, hd) caches:
    tensors of `cache_dtype`, or int8 QuantArrays with unit float32
    scales (B, max_len, nkv, 1). A latent-cache decoder (deepseek_v3)
    gets one zeroed (B, max_len, latent) tensor a layer; it has no int8
    cache (ValueError)."""
    layers, nkv, hd = cache_geometry(cfg)
    if latent_cache_dim(cfg) is not None:
        if kv_cache_8bit:
            raise ValueError("the deepseek_v3 decoder's latent cache has no "
                             "int8 form")
        return [torch.zeros((batch, max_len, hd), dtype=cache_dtype,
                            device=device) for _ in range(layers)]
    shape = (batch, max_len, nkv, hd)

    def one_cache():
        if kv_cache_8bit:
            return QuantArray(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                           device=device))
        return torch.zeros(shape, dtype=cache_dtype, device=device)

    return [(one_cache(), one_cache()) for _ in range(layers)]


class _CacheState:
    """The caches and the last step's logits and hidden state, which the
    first prefill allocates in the dtype of its outputs."""

    def __init__(self, cfg, batch: int, max_len: int, device, cache_dtype,
                 kv_cache_8bit: bool):
        self.max_len = max_len
        self.caches: List = alloc_caches(cfg, batch, max_len, device,
                                         cache_dtype, kv_cache_8bit)
        self.last_logits = self.last_hidden = None
        # The experts each MoE layer chose (deepseek_v3, greedy only):
        # static buffers the forwards' routing is copied into, inside the
        # decode graph too.
        self.prompt_experts = self.decode_experts = None

    def reset_caches(self) -> None:
        """Zero the caches (unit scales), as a freshly allocated state."""
        for pair in self.caches:
            for c in (pair if isinstance(pair, tuple) else (pair,)):
                if isinstance(c, QuantArray):
                    c.values.zero_()
                    c.scales.fill_(1.0)
                else:
                    c.zero_()

    def _alloc_outputs(self, hidden) -> None:
        raise NotImplementedError

    def _start(self, lengths) -> None:
        raise NotImplementedError


class DecodeState(_CacheState):
    """Every tensor the greedy loop reads or writes, allocated once for a
    (batch, prompt length, new tokens, cache kind) bucket: the KV caches
    (bfloat16 tensors by default, as in the JAX package, or int8
    QuantArrays with per token-head float32 scales), the rows' lengths,
    the live-slot mask `kv_seg`, the `done` flags, the last step's logits
    and hidden state, and the emitted tokens, hidden states and done
    flags of every step. `cfg` is the decoder's config (LlamaConfig or
    MptConfig)."""

    def __init__(self, cfg, batch: int, prompt_len: int,
                 max_new_tokens: int, device, cache_dtype=torch.bfloat16,
                 kv_cache_8bit: bool = False):
        b, t = batch, max_new_tokens
        super().__init__(cfg, b, prompt_len + t, device, cache_dtype,
                         kv_cache_8bit)
        new = lambda *s, dtype: torch.zeros(s, dtype=dtype,  # noqa: E731
                                            device=device)
        self.lengths = new(b, dtype=torch.long)
        self.kv_seg = new(b, self.max_len, dtype=torch.int32)
        self.done = new(b, dtype=torch.bool)
        self.hiddens = None
        self.tokens = new(b, t, dtype=torch.long)
        self.was_done = new(b, t, dtype=torch.bool)
        self.slots = torch.arange(self.max_len, device=device)[None, :]
        if latent_cache_dim(cfg) is not None:
            n, k = cfg.num_moe_layers, cfg.num_experts_per_tok
            self.prompt_experts = new(b, prompt_len, n, k, dtype=torch.int16)
            self.decode_experts = new(b, t, n, k, dtype=torch.int16)

    def _alloc_outputs(self, hidden) -> None:
        b, t = self.tokens.shape
        self.hiddens = hidden.new_empty((b, t, hidden.shape[-1]))

    def _start(self, lengths) -> None:
        self.lengths.copy_(lengths)
        self.kv_seg.copy_(self.slots < lengths[:, None])
        self.done.zero_()
        if self.decode_experts is not None:
            self.decode_experts.fill_(-1)

    def result(self) -> GenerateResult:
        experts = (None if self.prompt_experts is None
                   else (self.prompt_experts, self.decode_experts))
        return GenerateResult(
            tokens=self.tokens.to(torch.int32), hiddens=self.hiddens,
            lengths=(~self.was_done).sum(dim=1).to(torch.int32),
            expert_ids=experts,
            latent_caches=None if experts is None else self.caches)


def _forward(llm_fn: Callable, record, *args):
    """llm_fn(*args)'s logits and hidden state; given a `record` buffer
    (B, L, MoE layers, k), the forward is asked `with_aux` and the experts
    it returns as its fourth item are copied into the buffer."""
    if record is None:
        logits, hidden, _ = llm_fn(*args)
    else:
        logits, hidden, _, chosen = llm_fn(*args, with_aux=True)
        record.copy_(chosen)
    return logits, hidden


def prefill(state: _CacheState, llm_fn: Callable, prompt_embeds,
            prompt_positions, prompt_segment_ids, prompt_lengths) -> None:
    """Run the prompt through `llm_fn`, writing its k/v into the state's
    caches, set the last logits and hidden state (each row's, at its
    length), and start the loop's state from the rows' lengths (greedy:
    lengths and live slots, no row done; speculative: the history, the
    output buffers and the counters too). Shared by the greedy and the
    speculative decode, as JAX's `_alloc_and_prefill`: the exactness
    contract between them starts from one prefill."""
    with span("evaluate.prefill"):
        b = prompt_embeds.shape[0]
        dev = prompt_embeds.device
        lengths = prompt_lengths.long()
        logits, hidden = _forward(
            llm_fn, state.prompt_experts, prompt_embeds, prompt_positions,
            prompt_segment_ids, state.caches,
            torch.zeros((b,), dtype=torch.long, device=dev), None)
        rows = torch.arange(b, device=dev)
        last = (lengths - 1).clamp(min=0)
        if state.last_logits is None:
            state.last_logits = logits.new_empty((b, logits.shape[-1]))
            state.last_hidden = hidden.new_empty((b, hidden.shape[-1]))
            state._alloc_outputs(hidden)
        state.last_logits.copy_(logits[rows, last])
        state.last_hidden.copy_(hidden[rows, last])
        state._start(lengths)


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
        record = (None if state.decode_experts is None
                  else state.decode_experts[:, step:step + 1])
        logits, hidden = _forward(
            llm_fn, record, embed_fn(token[:, None]), lengths[:, None], None,
            state.caches, lengths, state.kv_seg)
        lengths.copy_(torch.where(new_done, lengths, lengths + 1))
        state.last_logits.copy_(logits[:, 0])
        state.last_hidden.copy_(hidden[:, 0])
        state.done.copy_(new_done)


@torch.inference_mode()
def greedy_generate(cfg, embed_fn: Callable, llm_fn: Callable,
                    prompt_embeds, prompt_positions, prompt_segment_ids,
                    prompt_lengths, max_new_tokens: int, eos_id: int,
                    cache_dtype=torch.bfloat16,
                    kv_cache_8bit: bool = False) -> GenerateResult:
    """embed_fn(tokens (B, 1)) -> (B, 1, E); llm_fn(embeds, positions,
    segment_ids, kv_caches, cache_index, cache_kv_segment_ids) ->
    (logits, hidden, kv_caches), the caches updated in place.
    prompt_*: spliced prompt (B, L, ...); prompt_lengths (B,) real token
    counts; `cfg` is the decoder's config (LlamaConfig or MptConfig). The
    cache dtype defaults to bfloat16 as in the JAX package; `kv_cache_8bit`
    stores it as int8 with per token-head float32 scales
    (nn/quant.QuantArray) instead."""
    b, l, _ = prompt_embeds.shape
    state = DecodeState(cfg, b, l, max_new_tokens, prompt_embeds.device,
                        cache_dtype, kv_cache_8bit)
    prefill(state, llm_fn, prompt_embeds, prompt_positions,
            prompt_segment_ids, prompt_lengths)
    with span("evaluate.decode"):
        decode_loop(state, embed_fn, llm_fn, max_new_tokens, eos_id)
    return state.result()


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decoding
# ---------------------------------------------------------------------------

def make_lookup_corpus(token_rows, width: int, batch: int, pad_id: int):
    """Host-side helper: pack template token-id lists (e.g. the tokenized
    data/prompts.py ANSWER_LIST answers) into a (batch, width) int32
    corpus + (batch,) live lengths for speculative_generate. Rows are
    concatenated in order and truncated/padded to `width`."""
    import numpy as np

    flat = [t for row in token_rows for t in row][:width]
    corpus = np.full((width,), pad_id, np.int32)
    corpus[:len(flat)] = np.asarray(flat, np.int32)
    return (np.broadcast_to(corpus, (batch, width)).copy(),
            np.full((batch,), len(flat), np.int32))


def answer_template_corpus(tokenizer, width: int = 128):
    """The data/prompts.py ANSWER_LIST templates tokenized (each followed
    by EOS) into a (1, width) draft corpus + (1,) length for
    speculative_generate: the strings a trained affordance model emits,
    so lookup drafting accepts them nearly wholesale."""
    from ..data.prompts import ANSWER_LIST

    eos = tokenizer.eos_token_id
    rows = [list(tokenizer(a, add_special_tokens=False).input_ids) + [eos]
            for a in ANSWER_LIST]
    return make_lookup_corpus(rows, width, 1, eos)


class SpeculativeState(_CacheState):
    """Every tensor the speculative loop reads or writes, allocated once
    for a (batch, prompt length, new tokens, cache kind, draft length,
    corpus width) bucket: caches of `prompt_len + T + D` slots (a verify
    chunk may write D slots past the last token), the draft history
    (corpus ++ accepted tokens, `C + T + D` columns, -1 past its live
    length), the rows' cache offsets `cur`, emitted counts, `done` flags
    and last verified tokens `t_prev`, the output buffers (T + D columns),
    the step counter `steps` and the one-element `live` flag (some row
    neither done nor full), which the host reads between steps.

    draft_corpus (B, C) and corpus_lengths (B,) (None: all C live) are
    tensors on `device`; each prefill copies them into the history."""

    def __init__(self, cfg, batch: int, prompt_len: int,
                 max_new_tokens: int, device, draft_corpus,
                 corpus_lengths=None, draft_len: int = 8, eos_id: int = 2,
                 cache_dtype=torch.bfloat16, kv_cache_8bit: bool = False):
        if draft_len < 2:
            raise ValueError("draft_len must be >= 2 (1 == plain greedy)")
        b, t, d = batch, max_new_tokens, draft_len
        super().__init__(cfg, b, prompt_len + t + d, device, cache_dtype,
                         kv_cache_8bit)
        self.max_new_tokens, self.draft_len, self.eos_id = t, d, eos_id
        self.corpus = draft_corpus.long()
        c = self.corpus.shape[1]
        self.corpus_lengths = (
            torch.full((b,), c, dtype=torch.long, device=device)
            if corpus_lengths is None else corpus_lengths.long())
        new = lambda *s, dtype=torch.long: torch.zeros(  # noqa: E731
            s, dtype=dtype, device=device)
        self.hist = new(b, c + t + d)
        self.hist_len = new(b)
        self.cur, self.emitted, self.t_prev = new(b), new(b), new(b)
        self.done = new(b, dtype=torch.bool)
        self.out_tok = new(b, t + d)
        self.out_hid = None
        self.steps = new()
        self.live = new(1, dtype=torch.bool)
        self.slots = torch.arange(self.max_len, device=device)
        self.drange = torch.arange(d, device=device)
        self.harange = torch.arange(c + t + d, device=device)

    def _alloc_outputs(self, hidden) -> None:
        b, w = self.out_tok.shape
        self.out_hid = hidden.new_zeros((b, w, hidden.shape[-1]))

    def _start(self, lengths) -> None:
        c = self.corpus.shape[1]
        self.hist.fill_(-1)
        self.hist[:, :c] = self.corpus
        self.hist_len.copy_(self.corpus_lengths)
        self.cur.copy_(lengths)
        self.emitted.zero_()
        self.t_prev.fill_(-1)
        self.done.zero_()
        self.out_tok.fill_(self.eos_id)
        self.out_hid.zero_()
        self.steps.zero_()
        self.live.fill_(self.max_new_tokens > 0)

    def result(self) -> GenerateResult:
        t = self.max_new_tokens
        return GenerateResult(
            tokens=self.out_tok[:, :t].to(torch.int32),
            hiddens=self.out_hid[:, :t].clone(),
            lengths=self.emitted.to(torch.int32),
            steps=self.steps.to(torch.int32))


def _draft_chunk(state: SpeculativeState, t1):
    """(B, D) chunk starting with the verified token t1; D-1 drafts follow
    the most recent (t_prev, t1) bigram in the history (the most recent
    t1 where no bigram matches). Where nothing matches, or the history
    ends, the filler is t1: sound, since acceptance re-verifies."""
    hist, hist_len, harange = state.hist, state.hist_len, state.harange
    b, w = hist.shape
    live = harange[None, :] < hist_len[:, None]
    big = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=hist.device),
         (hist[:, :-1] == state.t_prev[:, None]) & (hist[:, 1:] == t1[:, None])],
        dim=1) & live
    uni = (hist == t1[:, None]) & live
    none = torch.full_like(harange, -1)[None, :]
    jb = torch.where(big, harange[None, :], none).amax(dim=1)
    ju = torch.where(uni, harange[None, :], none).amax(dim=1)
    j = torch.where(jb >= 0, jb, ju)
    offs = j[:, None] + 1 + state.drange[None, :-1]
    valid = (j >= 0)[:, None] & (offs < hist_len[:, None])
    got = hist.gather(1, offs.clamp(0, w - 1))
    drafts = torch.where(valid, got, t1[:, None])
    return torch.cat([t1[:, None], drafts], dim=1)


def _write_rows(buf, chunk, offs, n_emit, drange) -> None:
    """buf[r, offs[r] + j] = chunk[r, j] for j < n_emit[r], in place (the
    buffers are wide enough that offs + D never passes their end)."""
    idx = offs[:, None] + drange[None, :]
    sel = drange[None, :] < n_emit[:, None]
    if buf.dim() == 3:
        idx = idx[..., None].expand(-1, -1, buf.shape[-1])
        sel = sel[..., None]
    buf.scatter_(1, idx, torch.where(sel, chunk.to(buf.dtype),
                                     buf.gather(1, idx)))


def verify_step(state: SpeculativeState, embed_fn: Callable,
                llm_fn: Callable) -> None:
    """One speculative step after `prefill`, in place on `state` (JAX's
    `while_loop` body): draft a chunk of D tokens (the verified argmax of
    the last logits, EOS for a done row, then D-1 lookup drafts), run it
    through `llm_fn` in one verify forward (written into the caches at
    each row's offset; each token attends up to its own position), accept
    the longest prefix the model's own argmax confirms, cut it after an
    accepted EOS and at T tokens, and write the accepted tokens (with the
    hidden states that emitted them) into the outputs and the history.
    Sets `live` for the host's loop. Reads and writes only the state's
    tensors and never waits for the device."""
    d, t_out, eos = state.draft_len, state.max_new_tokens, state.eos_id
    drange, cur, emitted, done = (state.drange, state.cur, state.emitted,
                                  state.done)
    t1 = torch.where(done, torch.full_like(cur, eos),
                     torch.argmax(state.last_logits, dim=-1))
    chunk = _draft_chunk(state, t1)                              # (B, D)
    pos = cur[:, None] + drange[None, :]
    kv_seg = (state.slots[None, :] < (cur + d)[:, None]).to(torch.int32)
    logits, hidden, _ = llm_fn(embed_fn(chunk), pos, None, state.caches,
                               cur, kv_seg)

    g = torch.argmax(logits, dim=-1)                             # (B, D)
    acc = torch.cumprod((chunk[:, 1:] == g[:, :-1]).long(), dim=1)
    n_acc = 1 + acc.sum(dim=1)
    iseos = chunk == eos
    in_acc = iseos & (drange[None, :] < n_acc[:, None])
    first_eos = torch.argmax(in_acc.int(), dim=1)  # the first, on ties
    n_emit = torch.where(in_acc.any(dim=1), first_eos + 1, n_acc)
    n_emit = torch.minimum(n_emit, t_out - emitted)
    n_emit = torch.where(done, torch.zeros_like(n_emit), n_emit)
    eos_emitted = (iseos & (drange[None, :] < n_emit[:, None])).any(dim=1)

    h_chunk = torch.cat([state.last_hidden[:, None], hidden[:, :-1]], dim=1)
    _write_rows(state.out_tok, chunk, emitted, n_emit, drange)
    _write_rows(state.out_hid, h_chunk, emitted, n_emit, drange)
    _write_rows(state.hist, chunk, state.hist_len, n_emit, drange)
    state.hist_len.add_(n_emit)

    rows = torch.arange(chunk.shape[0], device=chunk.device)
    pick = n_emit.clamp(min=1) - 1
    active = n_emit > 0
    state.last_logits.copy_(torch.where(active[:, None], logits[rows, pick],
                                        state.last_logits))
    state.last_hidden.copy_(torch.where(active[:, None], hidden[rows, pick],
                                        state.last_hidden))
    state.t_prev.copy_(torch.where(active, chunk[rows, pick], state.t_prev))
    cur.add_(n_emit)
    emitted.add_(n_emit)
    done.logical_or_(eos_emitted)
    state.steps.add_(1)
    state.live.copy_((~done & (emitted < t_out)).any().reshape(1))


@torch.inference_mode()
def speculative_generate(cfg, embed_fn: Callable, llm_fn: Callable,
                         prompt_embeds, prompt_positions, prompt_segment_ids,
                         prompt_lengths, max_new_tokens: int, eos_id: int,
                         draft_corpus, corpus_lengths=None,
                         draft_len: int = 8, cache_dtype=torch.bfloat16,
                         kv_cache_8bit: bool = False) -> GenerateResult:
    """Greedy generation with prompt-lookup speculative decoding: emits
    exactly greedy_generate's tokens (and the hidden states that emitted
    the live ones) in fewer decode forwards. Each step drafts `draft_len`
    tokens by n-gram lookup over `draft_corpus` ++ the accepted tokens,
    verifies them in one chunked forward (nn/llama.py's L > 1 cache mode,
    kernels/decode_attention.py chunk_decode_attention) and accepts the
    longest prefix the model's own argmax confirms; draft quality moves
    only the number of steps. The loop runs `verify_step` while a row is
    live (at most T times), reading the `live` flag on the host.

    draft_corpus: (B, C) int token ids (tensor or numpy); corpus_lengths
    (B,) live counts (default: all C). Arguments otherwise as
    greedy_generate's. Returns a GenerateResult with `steps`."""
    b, l, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    as_long = lambda x: torch.as_tensor(x, device=dev).long()  # noqa: E731
    state = SpeculativeState(
        cfg, b, l, max_new_tokens, dev, as_long(draft_corpus),
        None if corpus_lengths is None else as_long(corpus_lengths),
        draft_len, eos_id, cache_dtype, kv_cache_8bit)
    prefill(state, llm_fn, prompt_embeds, prompt_positions,
            prompt_segment_ids, prompt_lengths)
    with span("evaluate.decode"):
        for _ in range(max_new_tokens):
            if not bool(state.live):
                break
            verify_step(state, embed_fn, llm_fn)
    return state.result()
