"""Quantized serving end to end: the port's `greedy_generate` and
`evaluate_fn` (haff_tpu_torch/infer) with int8 weights + the int8 KV
cache, and with packed-int4 weights, against the JAX package on the
bridged `quantize_dense_tree` trees, at the tiny preset in float32 on the
CPU (plain versions of the three kernels).

Tokens, lengths and `seg_found` must be identical. Masks and taxonomy:
the 4-bit path quantizes no activation and agrees within 1e-4 like the
float path (observed 1.2e-6). The 8-bit paths round activations (W8A8) and
fresh keys/values (int8 cache) to int8: a 1e-6 difference between the two
frameworks before a `round` can move one int8 step, which is 1/127 of that
token's largest value; observed max abs differences 2.8e-3 on mask logits
(whose magnitude is ~1) and 2.9e-4 on taxonomy probabilities. Tolerance
for them: 2e-2 abs + 2e-2 rel.
"""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.core.config import IMAGE_TOKEN_INDEX
from haff_tpu.infer.evaluate import make_jitted_evaluate
from haff_tpu.infer.generate import greedy_generate as jax_greedy_generate
from haff_tpu.nn import quant as jq
from haff_tpu_torch.infer.evaluate import evaluate_fn
from haff_tpu_torch.infer.generate import greedy_generate
from haff_tpu_torch.nn.layers import QDense
from haff_tpu_torch.nn.quant import QuantArray
from test_torch_bridge import jax_tiny_params, port_model

B, L, T, EOS = 3, 10, 6, 248
MODES = {
    # bits, JAX predicate, group, int8 cache, mask/taxonomy tolerance,
    # factor on lm_head's [SEG] column (so that some row emits [SEG])
    "w8a8_kv8": (8, jq.lisa_serving_predicate, 64, True,
                 dict(rtol=2e-2, atol=2e-2), 2.0),
    "w4a16": (4, jq.default_llm_predicate, 16, False,
              dict(rtol=1e-4, atol=1e-4), 3.0),
}


def _requests(cfg):
    rng = np.random.default_rng(7)
    ids = rng.integers(5, 400, (B, L)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    att = np.ones((B, L), np.int32)
    att[1, 7:] = 0
    att[2, 5:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.standard_normal((B, S, S, 3)).astype(np.float32),
            rng.standard_normal((B, C, C, 3)).astype(np.float32), ids, att)


@pytest.fixture(scope="module", params=sorted(MODES))
def both(request):
    bits, pred, group, kv8, tol, seg_gain = MODES[request.param]
    jmodel, params = jax_tiny_params()
    cfg = jmodel.cfg
    params["llm"]["lm_head"]["kernel"][:, cfg.seg_token_idx] *= seg_gain
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(
        params, pred, bits=bits, group=group))
    req = _requests(cfg)
    ref = make_jitted_evaluate(jmodel, T, EOS, kv_cache_8bit=kv8)(
        {"params": qtree}, *req)
    port = port_model(qtree)
    got = evaluate_fn(port, *req, T, EOS, kv_cache_8bit=kv8)
    return ({k: np.asarray(v) for k, v in ref._asdict().items()
             if v is not None},
            {k: v.numpy() for k, v in got._asdict().items()
             if v is not None}, tol, port, bits)


def test_quantized_layers_were_served(both):
    *_, port, bits = both
    kinds = {m.weight.dtype for m in port.modules()
             if isinstance(m, QDense) and m.quantized}
    assert kinds == {torch.int8 if bits == 8 else torch.uint8}


def test_tokens_lengths_and_seg_found_identical(both):
    ref, got, *_ = both
    np.testing.assert_array_equal(got["output_ids"], ref["output_ids"])
    np.testing.assert_array_equal(got["gen_lengths"], ref["gen_lengths"])
    np.testing.assert_array_equal(got["seg_found"], ref["seg_found"])
    assert got["seg_found"].any()


@pytest.mark.parametrize("key", ["pred_masks_left", "pred_masks_right",
                                 "taxonomies"])
def test_masks_and_taxonomy_agree(both, key):
    ref, got, tol, *_ = both
    assert got[key].shape == ref[key].shape
    assert np.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key], ref[key], **tol)


def test_greedy_generate_with_the_int8_cache_matches_jax():
    """The LLM alone, float weights, int8 KV cache: identical tokens, and
    hidden states within the int8 cache's rounding noise (2e-2)."""
    jmodel, params = jax_tiny_params(seed=2)
    cfg = jmodel.cfg.llama
    port = port_model(params)
    rng = np.random.default_rng(3)
    b, lp = 2, 9
    ids = rng.integers(3, cfg.vocab_size, (b, lp)).astype(np.int32)
    seg = (np.arange(lp)[None] < np.array([[9], [6]])).astype(np.int32)
    pos = np.maximum(np.cumsum(seg, axis=1) - 1, 0).astype(np.int32)
    variables = {"params": params}

    def jrun(ids, pos, seg):
        embed = lambda t: jmodel.apply(variables, t,  # noqa: E731
                                       method="embed_tokens")
        llm = lambda *a: jmodel.apply(variables, *a,  # noqa: E731
                                      method="llm_forward")
        return jax_greedy_generate(cfg, embed, llm, embed(ids), pos, seg,
                                   seg.sum(1), 5, 0, kv_cache_8bit=True)

    ref = jax.jit(jrun)(ids, pos, seg)
    seen = []

    def llm_fn(*args):
        seen.append(args[3][0][0])
        return port.llm_forward(*args)

    ids_t, pos_t, seg_t = map(torch.from_numpy, (ids, pos, seg))
    got = greedy_generate(port.cfg.llama, port.embed_tokens, llm_fn,
                          port.embed_tokens(ids_t), pos_t, seg_t, seg_t.sum(1),
                          5, 0, kv_cache_8bit=True)
    cache = seen[0]
    assert isinstance(cache, QuantArray)
    assert cache.values.dtype == torch.int8
    assert cache.values.shape == (b, lp + 5, cfg.num_kv_heads, cfg.head_dim)
    assert cache.scales.dtype == torch.float32
    assert cache.scales.shape == (b, lp + 5, cfg.num_kv_heads, 1)
    assert cache.values[0, :lp].any()            # written in place
    assert (cache.scales[:, -1] == 1).all()      # the unwritten tail
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(got.hiddens.numpy(), np.asarray(ref.hiddens),
                               rtol=2e-2, atol=2e-2)
