"""The external-scales family served at the tiny preset on the CPU
against haff_tpu's, on the bridged seeded JAX tree:

* make_quantized_apply (haff_tpu_torch/nn/quant.py): the whole training
  forward over int8 at rest, dequantized to bfloat16 at use, within 1e-4
  of JAX's apply_fn; no quantized product is called;
* make_jitted_evaluate(quant_scales=) (infer/evaluate.py) over
  quantize_tree's int8 and packed-int4 trees bound into the model
  (`bind_quantized_tree_`): JAX's tokens, masks and taxonomy within 1e-4,
  no quantized product called, the layers as they were after the call;
  without the bound tree it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.infer.evaluate import make_jitted_evaluate as jax_evaluate
from haff_tpu.nn import quant as jq
from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
from haff_tpu_torch.nn import quant as tq
from test_lisa_model import make_tiny_batch
from test_torch_bridge import port_model
from test_torch_quant_evaluate import _requests
from test_torch_quant_tree import EOS, GROUP, T, tiny  # noqa: F401
from test_torch_train import _port_batch


def _refuse(*a, **k):
    raise AssertionError("a quantized product was called")


def test_make_quantized_apply_matches_jax(tiny, monkeypatch):
    """The training forward over int8 at rest dequantized to bfloat16 at
    use, against JAX's apply_fn: loss terms, masks and taxonomy within
    1e-4; the quantized products are never called."""
    jmodel, params = tiny
    qp, apply_fn = jq.make_quantized_apply(jmodel, params)
    jbatch = make_tiny_batch(jmodel.cfg)
    ref = jax.jit(apply_fn)(qp, jbatch)
    model = port_model(params)

    monkeypatch.setattr(tq, "int8_matmul", _refuse)
    monkeypatch.setattr(tq, "int4_matmul", _refuse)
    tqp, tapply = tq.make_quantized_apply(model)
    assert all(t.dtype == torch.int8 for n, t in tqp.items()
               if tq.default_llm_predicate(tuple(n.split(".")))
               and n.endswith(".weight") and t.dim() == 2)
    with torch.no_grad():
        got = tapply(tqp, _port_batch(jbatch))
    for key in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                "taxonomy_ce_loss", "pred_masks_left", "pred_masks_right",
                "pred_taxonomies"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("bits", [8, 4])
def test_jitted_evaluate_quant_scales_matches_jax(tiny, bits, monkeypatch):
    jmodel, params = tiny
    jq_vars, jscales = jq.quantize_tree({"params": params},
                                        jq.default_llm_predicate, bits=bits,
                                        group=GROUP)
    req = _requests(jmodel.cfg)
    ref = jax_evaluate(jmodel, T, EOS, quant_scales=jscales,
                       quant_dtype=jnp.bfloat16)(jq_vars, *req)
    model = port_model(params)
    qstate, scales = tq.quantize_tree(model, tq.default_llm_predicate,
                                      bits=bits, group=GROUP)
    tq.bind_quantized_tree_(model, qstate, scales)
    monkeypatch.setattr(tq, "int8_matmul", _refuse)
    monkeypatch.setattr(tq, "int4_matmul", _refuse)
    got = make_jitted_evaluate(model, T, EOS, quant_scales=scales,
                               quant_dtype=torch.bfloat16)(*req)
    # The scales act on the evaluator's calls only.
    assert all(model.get_submodule(n[:-7]).dequant_dtype is None
               for n in scales)
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(ref.output_ids))
    np.testing.assert_array_equal(got.gen_lengths.numpy(),
                                  np.asarray(ref.gen_lengths))
    assert np.asarray(ref.seg_found).any()
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    with pytest.raises(ValueError, match="bind the quantized tree"):
        make_jitted_evaluate(port_model(params), T, EOS, quant_scales=scales)
