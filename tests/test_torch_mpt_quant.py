"""Quantized serving of the MPT decoder: the port's MPT `evaluate_fn` over
haff_tpu's `quantize_dense_tree` of an MPT tree, bridged, against
haff_tpu's evaluate on the same tree, at the tiny preset in float32 on
the CPU: int8 weights (W8A8, `lisa_serving_predicate`: Wqkv, out_proj,
up and down in every block, and the SAM encoder) with the int8 KV cache,
and packed-int4 weights (W4A16, `default_llm_predicate`, group 16).

Tokens, lengths and `seg_found` identical; masks and taxonomy within
2e-2 at 8 bits (the 8-bit evaluate's standing tolerance,
tests/test_torch_quant_evaluate.py: a 1e-6 difference before an
activation's round moves one int8 step) and 1e-4 at 4 bits (no
activation is rounded).
"""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.infer.evaluate import make_jitted_evaluate
from haff_tpu.nn import quant as jq
from haff_tpu_torch.infer.evaluate import evaluate_fn
from haff_tpu_torch.nn.layers import QDense
from test_torch_bridge import port_model
from test_torch_mpt_lisa import EOS, T, trees  # noqa: F401  (a fixture)

MODES = {
    # bits, JAX predicate, group, int8 cache, mask/taxonomy tolerance
    "w8a8_kv8": (8, jq.lisa_serving_predicate, 64, True,
                 dict(rtol=2e-2, atol=2e-2)),
    "w4a16": (4, jq.default_llm_predicate, 16, False,
              dict(rtol=1e-4, atol=1e-4)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantized_mpt_evaluate_matches_jax(trees, mode):  # noqa: F811
    bits, pred, group, kv8, tol = MODES[mode]
    jmodel, params, req = trees
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(
        params, pred, bits=bits, group=group))
    ref = make_jitted_evaluate(jmodel, T, EOS, kv_cache_8bit=kv8)(
        {"params": qtree}, *req)
    port = port_model(qtree, decoder="mpt")
    kinds = {m.weight.dtype for n, m in port.named_modules()
             if isinstance(m, QDense) and m.quantized and n.startswith("llm.")}
    assert kinds == {torch.int8 if bits == 8 else torch.uint8}
    got = evaluate_fn(port, *req, T, EOS, kv_cache_8bit=kv8)
    for key in ("output_ids", "gen_lengths", "seg_found"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)), **tol,
                                   err_msg=key)
