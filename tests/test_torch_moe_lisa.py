"""MoE decoder MLPs through the port's model and serving paths, at the tiny
preset with 4 experts, top-2, in every other layer (layer 1 MoE, layer 0
dense), float32 on the CPU, against haff_tpu on the same bridged weights
(one seeded JAX parameter tree, shapes from `jax.eval_shape`):

* the LLaMA decoder with remat, forward and gradients (JAX's
  `test_moe_in_llama_with_remat_and_interleave`), with a padded row so
  that the token mask takes part;
* `evaluate_fn` and `make_jitted_evaluate` against JAX's evaluate;
* speculative decode against JAX's and against the port's greedy
  (`tests/test_speculative.py::test_speculative_with_moe_decoder`);
(quantized serving: tests/test_torch_moe_quant.py).

Tolerances: tokens, lengths and decode steps identical; logits, masks and
taxonomy within 1e-4 (float32, summation order); gradients within 1e-4 of
the leaf's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.core.config import IMAGE_TOKEN_INDEX
from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.infer.evaluate import make_jitted_evaluate as jax_evaluate
from haff_tpu.infer.generate import make_lookup_corpus
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.nn.llama import LlamaForCausalLM as JaxLlama
from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
from haff_tpu_torch.nn.moe import MoEMLP
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import jax_param_shapes, port_model, random_like

B, L, T, EOS = 3, 10, 6, 248
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_every=2)
TOL = dict(rtol=1e-4, atol=1e-4)
CORPUS, LENS = make_lookup_corpus([[3, 4, 5]], width=8, batch=1, pad_id=2)


def moe_params(jcfg, seed=0):
    """Seeded float32 tree of the JAX MoE LisaModel; the stacked experts
    at fan-in scale, lm_head's [SEG] column doubled so rows emit [SEG]."""
    params = random_like(jax_param_shapes(JaxLisaModel(cfg=jcfg), jcfg), seed)
    for path, leaf in traverse_util.flatten_dict(params).items():
        if "moe" in path and path[-1] != "kernel":
            leaf *= 2.0 / np.sqrt(leaf.shape[1])  # 0.5 * z -> z / sqrt(fan_in)
    params["llm"]["lm_head"]["kernel"][:, jcfg.seg_token_idx] *= 2.0
    return params


def _requests(cfg, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 400, (B, L)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    att = np.ones((B, L), np.int32)
    att[1, 7:] = 0
    att[2, 5:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.standard_normal((B, S, S, 3)).astype(np.float32),
            rng.standard_normal((B, C, C, 3)).astype(np.float32), ids, att)


def _np(res):
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in res._asdict().items() if v is not None}


def _same(got, ref, tol, steps=True):
    for key in ("output_ids", "gen_lengths", "seg_found"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    if steps:
        assert int(got["decode_steps"]) == int(ref["decode_steps"])
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        np.testing.assert_allclose(got[key], ref[key], **tol, err_msg=key)


@pytest.fixture(scope="module")
def trees():
    base = JaxModelConfig.preset("tiny")
    jcfg = base.replace(llama=dataclasses.replace(base.llama, **MOE))
    params = moe_params(jcfg)
    return JaxLisaModel(cfg=jcfg), params, _requests(jcfg)


def _port(tree):
    return port_model(tree, llama=dataclasses.replace(
        ModelConfig.preset("tiny").llama, **MOE))


@pytest.fixture(scope="module")
def port(trees):
    return _port(trees[1])


def test_moe_layout_and_bridge(port, trees):
    layers = port.llm.model.layers
    assert isinstance(layers[1].moe, MoEMLP) and not hasattr(layers[1], "mlp")
    assert not hasattr(layers[0], "moe") and hasattr(layers[0], "mlp")
    assert port.moe_layers == (1,)
    names = set(port.state_dict())
    for leaf in ("router.weight", "gate_proj", "up_proj", "down_proj"):
        assert f"llm.model.layers.1.moe.{leaf}" in names
    want = trees[1]["llm"]["model"]["layers_1"]["moe"]["gate_proj"]
    np.testing.assert_array_equal(
        layers[1].moe.gate_proj.detach().numpy(), want)


def test_llama_with_remat_matches_jax(port, trees):
    jmodel, params, _ = trees
    cfg = jmodel.cfg.llama
    lm = JaxLlama(cfg=cfg, remat=True)
    rng = np.random.default_rng(5)
    ids = rng.integers(2, cfg.vocab_size, (2, 8)).astype(np.int32)
    seg = np.ones((2, 8), np.int32)
    seg[1, 5:] = 0
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))

    def loss(p):
        emb = lm.apply({"params": p}, jnp.asarray(ids), method=lm.embed)
        (logits, _, _), mut = lm.apply({"params": p}, emb, jnp.asarray(pos),
                                       jnp.asarray(seg), mutable=("moe_aux",))
        aux = sum(jax.tree_util.tree_leaves(mut["moe_aux"]))
        return jnp.sum(logits ** 2) * 1e-3 + aux, (logits, aux)

    (_, (jlogits, jaux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params["llm"])
    llm = port.llm
    llm.zero_grad()
    emb = llm.embed(torch.from_numpy(ids))
    logits, _, _, aux = llm(emb, torch.from_numpy(pos), torch.from_numpy(seg),
                            remat=True, with_aux=True)
    ((logits ** 2).sum() * 1e-3 + aux).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=0,
                               atol=1e-6)
    ref = flax_to_state_dict(grads)
    got = dict(llm.named_parameters())
    assert any("moe" in k for k in ref)
    for name, r in ref.items():
        r = r.numpy()
        g = got[name].grad.numpy()
        scale = float(np.abs(r).max())
        assert np.abs(g - r).max() <= 1e-4 * scale + 1e-6, name


@pytest.fixture(scope="module")
def float_refs(trees):
    jmodel, params, req = trees
    greedy = _np(jax_evaluate(jmodel, T, EOS)({"params": params}, *req))
    spec = _np(jax_evaluate(jmodel, T, EOS, draft_corpus=CORPUS,
                            corpus_lengths=LENS, draft_len=3)(
        {"params": params}, *req))
    return greedy, spec


@pytest.mark.parametrize("entry", ["evaluate_fn", "make_jitted_evaluate"])
def test_evaluate_matches_jax(port, trees, float_refs, entry):
    req = trees[2]
    if entry == "evaluate_fn":
        got = _np(evaluate_fn(port, *req, T, EOS))
    else:
        got = _np(make_jitted_evaluate(port, T, EOS)(*req))
    _same(got, float_refs[0], TOL, steps=False)
    assert got["seg_found"].any()


def test_speculative_matches_jax_and_greedy(port, trees, float_refs):
    req = trees[2]
    kw = dict(draft_corpus=CORPUS, corpus_lengths=LENS, draft_len=3)
    spec = _np(evaluate_fn(port, *req, T, EOS, **kw))
    _same(spec, float_refs[1], TOL)
    greedy = _np(evaluate_fn(port, *req, T, EOS))
    _same(spec, greedy, TOL, steps=False)
    oracle = np.concatenate([np.full((B, 1), -1), greedy["output_ids"]], 1)
    fast = _np(evaluate_fn(port, *req, T, EOS, draft_corpus=oracle,
                           draft_len=4))
    _same(fast, greedy, TOL, steps=False)
    assert int(fast["decode_steps"]) < T
