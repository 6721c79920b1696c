"""The external-scales quantization family at the tiny preset on the CPU
(haff_tpu_torch/nn/quant.py `quantize_tree`, `dequantize_tree`,
`random_quantized_like`) against haff_tpu's, on the bridged seeded JAX
tree:

* quantize_tree: the same layers quantized, int8 / packed int4 values and
  scales bit-equal to JAX's (transposed to the port's layout);
  dequantize_tree bit-equal in float32 and bfloat16, the legacy bare int8
  scales too;
* random_quantized_like: every parameter's name, dtype and shape as JAX's
  tree (the LLM's and the SAM encoder's, where the predicates select),
  scales equal, value ranges as JAX's, for both predicates and both
  widths; the model serves through the W8A8 / W4A16 products.

make_quantized_apply and make_jitted_evaluate(quant_scales=) against JAX
are in tests/test_torch_quant_apply.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.nn import quant as jq
from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.nn import quant as tq
from haff_tpu_torch.nn.layers import QDense
from haff_tpu_torch.tools.bridge import _torch_name, flax_to_state_dict
from test_torch_bridge import init_batch, jax_tiny_params
from test_torch_quant_evaluate import _requests

GROUP = 16  # tiny widths divide by 16, not by 64
PREDICATES = {"default_llm": (jq.default_llm_predicate,
                              tq.default_llm_predicate),
              "lisa_serving": (jq.lisa_serving_predicate,
                               tq.lisa_serving_predicate)}
T, EOS = 6, 248


@pytest.fixture(scope="module")
def tiny():
    jmodel, params = jax_tiny_params()
    params["llm"]["lm_head"]["kernel"][:, jmodel.cfg.seg_token_idx] *= 3.0
    return jmodel, params


def _jax_scales(scales):
    """JAX scales keyed by the port's weight names, in the port's layout."""
    out = {}
    for path, (kind, s, group) in scales.items():
        s = np.asarray(s)
        out[_torch_name(path)] = (kind, s.T if s.ndim == 2 else s, group)
    return out


@pytest.mark.parametrize("bits,pred", [(8, "lisa_serving"),
                                       (4, "default_llm")])
def test_quantize_and_dequantize_tree_bit_equal_jax(tiny, pred, bits):
    _, params = tiny
    jpred, tpred = PREDICATES[pred]
    jq_params, jscales = jq.quantize_tree(params, jpred, bits=bits,
                                          group=GROUP)
    state = flax_to_state_dict(params)
    qstate, scales = tq.quantize_tree(state, tpred, bits=bits, group=GROUP)
    want = _jax_scales(jscales)
    assert set(scales) == set(want) and scales
    jflat = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jq_params))
    for name, (kind, s, group) in scales.items():
        assert (kind, group) == want[name][::2]
        assert np.array_equal(s.numpy(), want[name][1]), name
        assert qstate[name].dtype == (torch.uint8 if kind == "int4"
                                      else torch.int8)
        assert np.array_equal(qstate[name].numpy(), jflat[name].numpy()), name
    for name, t in state.items():  # the float state untouched
        if name not in scales:
            assert qstate[name] is t
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jd = flax_to_state_dict(jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)),
            jq.dequantize_tree(jq_params, jscales, jdt)))
        td = tq.dequantize_tree(qstate, scales, tdt)
        for name in scales:
            assert td[name].dtype == tdt
            assert torch.equal(td[name].float(), jd[name]), (name, tdt)
    if bits == 8:  # legacy: bare int8 scales
        legacy = {k: s for k, (_, s, _) in scales.items()}
        td = tq.dequantize_tree(qstate, legacy, torch.float32)
        for name in scales:
            assert torch.equal(td[name], tq.dequantize_kernel(
                qstate[name], scales[name][1], torch.float32))


@pytest.mark.parametrize("pred", sorted(PREDICATES))
@pytest.mark.parametrize("bits", [8, 4])
def test_random_quantized_like_matches_jax(tiny, pred, bits):
    jmodel, _ = tiny
    jpred, tpred = PREDICATES[pred]
    big = 20_000  # some tiny leaves exceed it: the bfloat16 branch runs
    # The subtrees the predicates select from (the LLM, the SAM encoder):
    # JAX's generator compiles each op at each shape, a minute for the
    # whole tiny tree.
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            init_batch(jmodel.cfg))["params"]
    shapes = {"llm": shapes["llm"], "visual_model": {
        "image_encoder": shapes["visual_model"]["image_encoder"]}}
    # Op by op, through the rbg PRNG (the values need not match JAX's).
    impl = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "unsafe_rbg")
    try:
        with jax.disable_jit():
            jtree = jq.random_quantized_like(shapes, jpred, big_bf16=big,
                                             bits=bits, group=GROUP)
    finally:
        jax.config.update("jax_default_prng_impl", impl)
    jflat = {"/".join(k): np.asarray(v) for k, v in
             traverse_util.flatten_dict(jtree).items()}
    want = flax_to_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), jtree))
    model = tq.random_quantized_like(ModelConfig.preset("tiny"), tpred,
                                     seed=1, big_bf16=big, bits=bits,
                                     group=GROUP, dtype=torch.float32,
                                     device="cpu")
    got = {k: v for k, v in model.state_dict().items()
           if k.startswith(("llm.", "visual_model.image_encoder."))}
    assert set(got) == set(want)
    bf16 = {k for k, v in jflat.items() if v.dtype == jnp.bfloat16}
    assert bf16  # the big_bf16 branch ran
    for name, t in got.items():
        w = want[name]
        assert tuple(t.shape) == tuple(w.shape), name
        jdt = next(v.dtype for k, v in jflat.items()
                   if _torch_name(tuple(k.split("/")), k.endswith("/scale")
                                  and k[:-5] + "kernel" in jflat) == name)
        assert str(t.dtype).split(".")[-1] == str(jdt), (name, t.dtype, jdt)
        if t.dtype == torch.int8:
            assert t.min() >= -127 and t.max() <= 127 and t.abs().max() > 100
        elif t.dtype == torch.uint8:
            assert t.min() >= 0 and t.max() <= 255 and t.max() > 200
        elif name.endswith(".scale") and name[:-5] + "weight" in got and (
                not got[name[:-5] + "weight"].is_floating_point()):
            assert torch.equal(t, w), name  # 0.02 / sqrt(in), JAX's
        elif t.numel() > 100:
            assert abs(t.float().std().item() - 0.02) < 0.004, name
            assert abs(w.std().item() - 0.02) < 0.004, name
    layers = [m for m in model.modules() if isinstance(m, QDense)
              and m.quantized]
    assert layers and all(
        m.weight.dtype == (torch.uint8 if bits == 4 and m.in_features % GROUP
                           == 0 else torch.int8) for m in layers)


def test_random_quantized_like_serves():
    """A model made by random_quantized_like (no big_bf16 leaf at tiny)
    serves a greedy evaluate through the quantized QDense products."""
    from haff_tpu_torch.infer.evaluate import evaluate_fn
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny")
    assert LisaModel(cfg, torch.float32, device="meta").device.type == "meta"
    model = tq.random_quantized_like(cfg, tq.default_llm_predicate, bits=4,
                                     group=GROUP, dtype=torch.float32,
                                     device="cpu")
    out = evaluate_fn(model, *_requests(cfg), T, EOS)
    assert out.output_ids.shape == (3, T)
    assert torch.isfinite(out.pred_masks_left).all()
