"""The MPT decoder inside the composite model: the port's
`LisaModel(decoder="mpt")` evaluate against haff_tpu's at the tiny preset
in float32 (float cache and int8 cache), on one seeded parameter tree
carried over by tools/bridge.py; the bridge's names and layouts on an
MPT tree; the quantization predicates selecting the layers JAX's select
in it; and `convert_mpt` against haff_tpu's on a mosaicml/HF-named state
dict the test writes.

Tolerances: tokens, lengths and `seg_found` identical; masks and taxonomy
within 1e-4 (float32, summation order); with the int8 cache the same
(the cache's int8 values are bit-equal in both packages, and JAX's MPT
step dequantizes to float32 here, as the port's decode does).
"""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.core.config import IMAGE_TOKEN_INDEX
from haff_tpu.core.config import ModelConfig as JModelConfig
from haff_tpu.infer.evaluate import make_jitted_evaluate
from haff_tpu.model.lisa import LisaModel as JLisaModel
from haff_tpu.nn import quant as jq
from haff_tpu.tools import convert_weights as jcw
from haff_tpu_torch.infer.evaluate import evaluate_fn
from haff_tpu_torch.infer.generate import DecodeState
from haff_tpu_torch.nn import quant as tq
from haff_tpu_torch.nn.layers import QDense
from haff_tpu_torch.nn.mpt import MptConfig, MptForCausalLM
from haff_tpu_torch.tools import convert_weights as tcw
from haff_tpu_torch.tools.bridge import _torch_name, flax_to_state_dict
from test_torch_bridge import jax_param_shapes, port_model, random_like

B, L, T, EOS = 2, 10, 5, 2
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def trees():
    cfg = JModelConfig.preset("tiny").replace(decoder="mpt")
    jmodel = JLisaModel(cfg=cfg)
    params = random_like(jax_param_shapes(jmodel, cfg), 0)
    rng = np.random.default_rng(3)
    ids = rng.integers(5, 400, (B, L)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    att = np.ones((B, L), np.int32)
    att[1, 6:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    req = (rng.standard_normal((B, S, S, 3)).astype(np.float32),
           rng.standard_normal((B, C, C, 3)).astype(np.float32), ids, att)
    return jmodel, params, req


@pytest.fixture(scope="module")
def port(trees):
    return port_model(trees[1], decoder="mpt")


@pytest.mark.parametrize("kv8", [False, True], ids=["float_cache",
                                                    "int8_cache"])
def test_mpt_evaluate_matches_jax(trees, port, kv8):
    jmodel, params, req = trees
    ref = make_jitted_evaluate(jmodel, T, EOS, kv_cache_8bit=kv8)(
        {"params": params}, *req)
    got = evaluate_fn(port, *req, T, EOS, kv_cache_8bit=kv8)
    assert isinstance(port.llm, MptForCausalLM)
    for key in ("output_ids", "gen_lengths", "seg_found"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    assert got.decode_steps is None
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        g = getattr(got, key).numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(getattr(ref, key)), **TOL,
                                   err_msg=key)


def test_mpt_cache_geometry():
    cfg = MptConfig.preset("tiny")
    for mq, nkv in ((False, cfg.n_heads), (True, 1)):
        c = MptConfig(**{**cfg.__dict__, "multiquery": mq})
        state = DecodeState(c, 2, 6, 3, "cpu", torch.float32)
        assert len(state.caches) == c.n_layers
        assert state.caches[0][0].shape == (2, 9, nkv, c.head_dim)


def test_bridge_maps_an_mpt_tree(trees, port):
    params = trees[1]
    sd = flax_to_state_dict(params)
    assert set(port.state_dict()) == set(sd)
    blk = params["llm"]["blocks_1"]
    np.testing.assert_array_equal(sd["llm.blocks.1.attn.Wqkv.weight"].numpy(),
                                  blk["attn"]["Wqkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["llm.blocks.1.norm_2.weight"].numpy(),
                                  blk["norm_2"]["scale"])
    np.testing.assert_array_equal(sd["llm.wte.weight"].numpy(),
                                  params["llm"]["wte"]["embedding"])
    np.testing.assert_array_equal(sd["llm.norm_f.weight"].numpy(),
                                  params["llm"]["norm_f"]["scale"])
    assert "llm.blocks.0.norm_1.bias" not in sd  # bias-free norms


@pytest.mark.parametrize("which", ["lisa_serving_predicate",
                                   "default_llm_predicate"])
def test_quant_predicates_select_jax_layers(trees, which):
    """The port's predicate quantizes exactly the layers whose kernels
    JAX's predicate quantizes in the MPT tree (Wqkv, out_proj, up and
    down in every block; never wte, the norms or the mask decoders'
    out_proj)."""
    params = trees[1]
    jtree = jq.quantize_dense_tree(params, getattr(jq, which))
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    want = {_torch_name(tuple(k.key for k in path)).rsplit(".", 1)[0]
            for path, leaf in flat
            if path[-1].key == "kernel" and np.asarray(leaf).dtype == np.int8}
    model = port_model(params, decoder="mpt")
    tq.quantize_model_(model, getattr(tq, which))
    got = {n for n, m in model.named_modules()
           if isinstance(m, QDense) and m.quantized}
    assert got == want
    llm = {n for n in got if n.startswith("llm.")}
    assert len(llm) == 4 * model.llm.cfg.n_layers
    assert not any("wte" in n or "norm" in n for n in got)


def _mpt_state_dict(cfg, qk_ln, seed=0):
    """A mosaicml/HF MPTForCausalLM state dict (torch layouts) of `cfg`'s
    widths, seeded numpy."""
    rng = np.random.default_rng(seed)
    d, nl = cfg.d_model, cfg.n_layers
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {"transformer.wte.weight": f(cfg.vocab_size, d),
          "transformer.norm_f.weight": f(d)}
    for i in range(nl):
        b = f"transformer.blocks.{i}."
        sd.update({b + "norm_1.weight": f(d), b + "norm_2.weight": f(d),
                   b + "attn.Wqkv.weight": f(3 * d, d),
                   b + "attn.out_proj.weight": f(d, d),
                   b + "ffn.up_proj.weight": f(4 * d, d),
                   b + "ffn.down_proj.weight": f(d, 4 * d)})
        if qk_ln:
            sd[b + "attn.q_ln.weight"] = f(d)
            sd[b + "attn.k_ln.weight"] = f(d)
    return sd


@pytest.mark.parametrize("qk_ln", [False, True])
def test_convert_mpt_matches_jax(qk_ln):
    cfg = MptConfig.preset("tiny")
    sd = _mpt_state_dict(cfg, qk_ln)
    got = tcw.convert_mpt(sd, cfg.n_layers)
    ref = jcw.convert_mpt(sd, cfg.n_layers)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert flat_g.keys() == flat_r.keys()
    for k, v in flat_r.items():
        np.testing.assert_array_equal(flat_g[k], np.asarray(v))
    if not qk_ln:  # the converted tree loads into the port's MPT, strictly
        model = MptForCausalLM(cfg)
        model.load_state_dict(tcw.to_state_dict(got), strict=True)
        np.testing.assert_array_equal(
            model.blocks[0].attn.Wqkv.weight.detach().numpy(),
            sd["transformer.blocks.0.attn.Wqkv.weight"])
