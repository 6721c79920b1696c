"""Prompt-lookup speculative decoding of the port
(haff_tpu_torch/infer/generate.py) against haff_tpu/infer/generate.py at
the tiny LLaMA preset in float32, with the same seeded weights (bridged)
and inputs, as the cases of tests/test_speculative.py: a junk corpus (EOS
0 and 3), an oracle corpus (greedy's own tokens), an EOS inside an
accepted chunk, ragged prompts over the int8 cache, one chunked verify
forward against stepwise decode, and the corpus helpers.

Tolerances: tokens, lengths and decode steps identical to JAX's; the
hidden states of the live tokens within 2e-4, JAX's own bound between its
speculative and greedy streams; the port's speculative equals the port's
greedy the same way. JAX's generate functions are jitted once a case
(the prompts are shorter than 8 tokens, so JAX's attention is XLA).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import LlamaConfig as JLlamaConfig
from haff_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from haff_tpu.infer import generate as jgen
from haff_tpu.nn.llama import LlamaForCausalLM as JLlama
from haff_tpu_torch.core.config import LlamaConfig
from haff_tpu_torch.data.tokenizer import ByteTokenizer
from haff_tpu_torch.infer import generate as tgen
from haff_tpu_torch.nn.llama import LlamaForCausalLM
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like

HID = dict(rtol=2e-4, atol=2e-4)
B, LP = 2, 6


class Setup:
    """The tiny LLaMA in JAX and in the port with one seeded tree, a
    prompt of B x LP tokens and both packages' generate arguments."""

    def __init__(self, seed, lengths=None):
        cfg = JLlamaConfig.preset("tiny")
        jmodel = JLlama(cfg=cfg)
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(2, cfg.vocab_size, (B, LP)).astype(np.int32)
        pos = np.broadcast_to(np.arange(LP)[None], (B, LP)).astype(np.int32)
        shapes = jax.eval_shape(
            lambda k: jmodel.init(k, jnp.asarray(self.ids), jnp.asarray(pos),
                                  method="init_all"), jax.random.PRNGKey(0))
        params = {"params": random_like(fnn.unbox(shapes)["params"], seed)}
        self.cfg, self.jcfg = LlamaConfig.preset("tiny"), cfg
        self.port = LlamaForCausalLM(self.cfg)
        self.port.load_state_dict(flax_to_state_dict(params), strict=True)
        lengths = np.full((B,), LP) if lengths is None else np.asarray(lengths)
        seg = (np.arange(LP)[None] < lengths[:, None]).astype(np.int32)
        self.lengths = lengths.astype(np.int32)

        def embed_fn(tok):
            return jmodel.apply(params, tok, method="embed")

        def llm_fn(emb, p, sg, caches, idx, kvseg):
            return jmodel.apply(params, emb, p, sg, caches, idx, kvseg)

        self.jfns = (embed_fn, llm_fn)
        self.jargs = (jnp.asarray(pos), jnp.asarray(seg),
                      jnp.asarray(self.lengths))
        self.targs = tuple(torch.from_numpy(np.ascontiguousarray(a)).long()
                           for a in (pos, seg, self.lengths))

    def jax_greedy(self, T, eos, **kw):
        embed_fn, llm_fn = self.jfns

        @jax.jit
        def run(ids, pos, seg, lengths):
            return jgen.greedy_generate(self.jcfg, embed_fn, llm_fn,
                                        embed_fn(ids), pos, seg, lengths, T,
                                        eos_id=eos, **kw)
        return run(jnp.asarray(self.ids), *self.jargs)

    def jax_spec(self, T, eos, corpus, d, **kw):
        embed_fn, llm_fn = self.jfns

        @jax.jit
        def run(ids, pos, seg, lengths, corpus):
            return jgen.speculative_generate(
                self.jcfg, embed_fn, llm_fn, embed_fn(ids), pos, seg,
                lengths, T, eos_id=eos, draft_corpus=corpus, draft_len=d,
                **kw)
        return run(jnp.asarray(self.ids), *self.jargs,
                   jnp.asarray(corpus, jnp.int32))

    def _port(self, fn, *args, **kw):
        emb = self.port.embed(torch.from_numpy(self.ids))
        return fn(self.cfg, self.port.embed, self.port, emb, *self.targs,
                  *args, **kw)

    def port_greedy(self, T, eos, **kw):
        return self._port(tgen.greedy_generate, T, eos, **kw)

    def port_spec(self, T, eos, corpus, d, **kw):
        return self._port(tgen.speculative_generate, T, eos,
                          torch.as_tensor(np.asarray(corpus)), None, d, **kw)


def assert_same_stream(got, ref, hiddens=True):
    """Tokens and lengths identical; the live tokens' hidden states within
    2e-4 (both as numpy)."""
    np.testing.assert_array_equal(np.asarray(got.tokens), np.asarray(ref.tokens))
    np.testing.assert_array_equal(np.asarray(got.lengths),
                                  np.asarray(ref.lengths))
    if hiddens:
        gh, rh = np.asarray(got.hiddens), np.asarray(ref.hiddens)
        for r, n in enumerate(np.asarray(ref.lengths)):
            np.testing.assert_allclose(gh[r, :n], rh[r, :n], **HID,
                                       err_msg=f"row {r} live hiddens")


def check_all(s, T, eos, corpus, d, **kw):
    """The port's speculative against JAX's (steps too) and the port's
    greedy; the port's greedy against JAX's. Returns the port's result."""
    cache = dict(cache_dtype=jnp.float32) if not kw else kw
    tcache = dict(cache_dtype=torch.float32) if not kw else kw
    jg = s.jax_greedy(T, eos, **cache)
    js = s.jax_spec(T, eos, corpus, d, **cache)
    tg = s.port_greedy(T, eos, **tcache)
    ts = s.port_spec(T, eos, corpus, d, **tcache)
    assert_same_stream(tg, jg)
    assert_same_stream(ts, js)
    assert int(ts.steps) == int(js.steps)
    assert ts.tokens.dtype == torch.int32 and ts.steps.dtype == torch.int32
    assert_same_stream(ts, tg)
    return ts, tg


@pytest.mark.parametrize("eos", [0, 3])
def test_junk_corpus_matches_jax_and_greedy(eos):
    s = Setup(0)
    corpus = np.random.RandomState(7).randint(2, s.cfg.vocab_size, (B, 16))
    check_all(s, 6, eos, corpus, 4)


def test_oracle_corpus_fewer_steps():
    s = Setup(1)
    T = 8
    greedy = s.port_greedy(T, 0, cache_dtype=torch.float32)
    corpus = np.concatenate([s.ids[:, -1:], greedy.tokens.numpy()], axis=1)
    spec, _ = check_all(s, T, 0, corpus, 5)
    assert int(spec.steps) <= 4 and int(spec.steps) < T


def test_eos_mid_chunk():
    s = Setup(2)
    T = 8
    gen0 = s.port_greedy(T, 0, cache_dtype=torch.float32)
    eos = int(gen0.tokens[0, 2])  # row 0 stops after at most 3 tokens
    corpus = np.concatenate([s.ids[:, -1:], gen0.tokens.numpy()], axis=1)
    spec, greedy = check_all(s, T, eos, corpus, 5)
    assert int(greedy.lengths[0]) <= 3
    assert int(spec.steps) < T


def test_ragged_prompts_int8_cache():
    s = Setup(3, lengths=[LP, LP - 2])
    corpus = np.random.RandomState(9).randint(2, s.cfg.vocab_size, (B, 12))
    check_all(s, 5, 0, corpus, 3, kv_cache_8bit=True)


def test_chunk_verify_matches_stepwise():
    """The L > 1 cache mode (chunk_decode_attention) against D one-token
    decode steps of the same tokens, and against JAX's chunked forward."""
    s = Setup(4)
    D, max_len = 4, LP + 4
    chunk = np.random.RandomState(11).randint(2, s.cfg.vocab_size, (B, D))
    port, embed_fn, llm_fn = s.port, *s.jfns
    kv_seg = (np.arange(max_len)[None] < LP + D).astype(np.int32).repeat(B, 0)
    cpos = LP + np.broadcast_to(np.arange(D)[None], (B, D))

    shape = (B, max_len, s.jcfg.num_kv_heads, s.jcfg.head_dim)
    jc = [(jnp.zeros(shape), jnp.zeros(shape))
          for _ in range(s.jcfg.num_layers)]
    _, _, jc = llm_fn(embed_fn(jnp.asarray(s.ids)), s.jargs[0],
                      jnp.ones((B, LP), jnp.int32), jc,
                      jnp.zeros((B,), jnp.int32), None)
    jlogits, _, _ = llm_fn(embed_fn(jnp.asarray(chunk)), jnp.asarray(cpos),
                           None, jc, jnp.full((B,), LP, jnp.int32),
                           jnp.asarray(kv_seg))

    def prefilled():
        caches = tgen.alloc_caches(s.cfg, B, max_len, "cpu", torch.float32)
        port(port.embed(torch.from_numpy(s.ids)), s.targs[0],
             torch.ones(B, LP), caches, torch.zeros(B, dtype=torch.long))
        return caches

    with torch.inference_mode():
        caches = prefilled()
        logits, _, _ = port(port.embed(torch.from_numpy(chunk)),
                            torch.from_numpy(cpos.copy()), None, caches,
                            torch.full((B,), LP), torch.from_numpy(kv_seg))
        caches = prefilled()
        steps = []
        for i in range(D):
            widx = torch.full((B,), LP + i)
            kseg = (torch.arange(max_len)[None] <= LP + i).int().repeat(B, 1)
            lg, _, _ = port(port.embed(torch.from_numpy(chunk[:, i:i + 1])),
                            widx[:, None], None, caches, widx, kseg)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(logits.numpy(), torch.stack(steps, 1).numpy(),
                               **HID)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **HID)


def test_draft_len_below_two_rejected():
    s = Setup(0)
    corpus = np.zeros((B, 4), np.int64)
    with pytest.raises(ValueError, match="draft_len"):
        s.port_spec(4, 0, corpus, 1, cache_dtype=torch.float32)


def test_make_lookup_corpus_matches_jax():
    for rows, width, batch in (([[5, 6, 7], [8, 9]], 8, 3), ([[1] * 10], 4, 1)):
        got = tgen.make_lookup_corpus(rows, width, batch, 0)
        ref = jgen.make_lookup_corpus(rows, width, batch, 0)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype == np.int32
            np.testing.assert_array_equal(g, r)
    corpus, lens = tgen.make_lookup_corpus([[5, 6, 7], [8, 9]], 8, 3, 0)
    np.testing.assert_array_equal(corpus[0], [5, 6, 7, 8, 9, 0, 0, 0])
    assert int(lens[0]) == 5


@pytest.mark.parametrize("width", [128, 32])
def test_answer_template_corpus_matches_jax(width):
    got = tgen.answer_template_corpus(ByteTokenizer(), width)
    ref = jgen.answer_template_corpus(JByteTokenizer(), width)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    corpus, lens = got
    assert corpus.shape == (1, width) and 0 < int(lens[0]) <= width
    # Each template ends with EOS (2 for the byte tokenizer).
    assert (corpus[0, :int(lens[0])] == 2).sum() >= (5 if width == 128 else 1)
