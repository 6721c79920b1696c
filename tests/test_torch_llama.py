"""LLaMA decoder of the port (haff_tpu_torch/nn/llama.py) against
haff_tpu/nn/llama.py with the same bridged float32 weights: logits and
hidden states over right-padded prompts, prefill + cached decode equal to
the full forward, single-token decode attention equal to the JAX
`_xla_path`, and the CLIP tower.

Tolerance 1e-4 abs + rel (float32, two layers; summation order).
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.nn.clip_vit import ClipVisionTower as JaxClip
from haff_tpu.nn.llama import LlamaForCausalLM as JaxLlama
from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.infer.generate import greedy_generate
from haff_tpu_torch.nn.clip_vit import ClipVisionTower
from haff_tpu_torch.kernels.decode_attention import \
    flash_decode_attention as decode_attention
from haff_tpu_torch.nn.llama import LlamaForCausalLM
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like

jda = importlib.import_module("haff_tpu.kernels.decode_attention")
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = ModelConfig.preset("tiny").llama


def _llama_pair(seed=0):
    jm = JaxLlama(cfg=JaxModelConfig.preset("tiny").llama)
    ids = jnp.ones((1, 8), jnp.int32)
    shapes = fnn.unbox(jax.eval_shape(
        lambda k: jm.init(k, ids, jnp.arange(8)[None], method="init_all"),
        jax.random.PRNGKey(0)))["params"]
    params = random_like(shapes, seed)
    pm = LlamaForCausalLM(CFG)
    pm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, params, pm.eval()


def _prompt(b=2, l=11, lengths=(11, 7), seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, CFG.vocab_size, (b, l)).astype(np.int32)
    seg = (np.arange(l)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    pos = np.maximum(np.cumsum(seg, axis=1) - 1, 0).astype(np.int32)
    return ids, seg, pos


def test_logits_and_hidden_match_jax():
    jm, params, pm = _llama_pair()
    ids, seg, pos = _prompt()

    def jfwd(p, ids, pos, seg):
        emb = jm.apply({"params": p}, ids, method="embed")
        return jm.apply({"params": p}, emb, pos, seg)[:2]

    logits, hidden = jax.jit(jfwd)(params, ids, pos, seg)
    with torch.no_grad():
        emb = pm.embed(torch.from_numpy(ids))
        got_logits, got_hidden, _ = pm(emb, torch.from_numpy(pos),
                                       torch.from_numpy(seg))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden), **TOL)


def test_prefill_plus_decode_equals_full_forward():
    """Each emitted token is the argmax of an uncached forward over the
    prompt and the tokens so far, and the captured hidden state is that
    forward's hidden state at the emitting position."""
    _, _, pm = _llama_pair(1)
    b, lp, T = 2, 6, 4
    ids, seg, pos = _prompt(b, lp, (lp, lp), seed=1)
    ids_t, pos_t, seg_t = map(torch.from_numpy, (ids, pos, seg))
    with torch.no_grad():
        gen = greedy_generate(CFG, pm.embed, pm, pm.embed(ids_t), pos_t, seg_t,
                              seg_t.sum(1), T, eos_id=0,
                              cache_dtype=torch.float32)
        full = torch.cat([ids_t, gen.tokens], dim=1)
        fpos = torch.arange(lp + T)[None].expand(b, -1)
        logits, hidden, _ = pm(pm.embed(full), fpos,
                               torch.ones((b, lp + T), dtype=torch.int32))
    for t in range(T):
        assert torch.equal(gen.tokens[:, t].long(),
                           logits[:, lp - 1 + t].argmax(-1)), t
        torch.testing.assert_close(gen.hiddens[:, t], hidden[:, lp - 1 + t],
                                   rtol=1e-4, atol=1e-4)


def test_decode_attention_matches_xla_path():
    rng = np.random.default_rng(4)
    b, lmax, nh, hd = 2, 9, 4, 16
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, lmax, nh, hd)).astype(np.float32)
    v = rng.standard_normal((b, lmax, nh, hd)).astype(np.float32)
    mask = (np.arange(lmax)[None] < np.array([[9], [4]])).astype(np.int32)
    ref = jda._xla_path(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), hd ** -0.5)
    got = decode_attention(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_clip_tower_matches_jax():
    jcfg = JaxModelConfig.preset("tiny").clip
    jc = JaxClip(cfg=jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    shapes = fnn.unbox(jax.eval_shape(jc.init, jax.random.PRNGKey(0), x))
    params = random_like(shapes["params"], 5)
    pc = ClipVisionTower(ModelConfig.preset("tiny").clip)
    pc.load_state_dict(flax_to_state_dict(params), strict=True)
    ref = jax.jit(lambda p, x: jc.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        got = pc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
