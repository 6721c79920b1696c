"""MoE decoder MLPs under quantized serving, at the tiny preset with 4
experts, top-2, in every other layer, float32 on the CPU: W8A8 with the
int8 cache and W4A16 (group 16) evaluate against haff_tpu's on the tree
its `quantize_dense_tree` gives (which quantizes 2-D `kernel` leaves only:
the router, outside both predicates, and the stacked 3-D experts stay
float); the port's `quantize_model_` picks the same layers from the float
model and leaves the router and the experts float too.

Tolerances: tokens, lengths and `seg_found` identical; masks and taxonomy
within 2e-2 (W8A8 rounds activations to int8, and a 1e-6 difference
before a round moves one int8 step: tests/test_torch_quant_evaluate.py).
"""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.infer.evaluate import make_jitted_evaluate as jax_evaluate
from haff_tpu.nn import quant as jq
from haff_tpu_torch.infer.evaluate import evaluate_fn
from haff_tpu_torch.nn import quant
from haff_tpu_torch.nn.layers import QDense
from test_torch_moe_lisa import EOS, T, _np, _port, _same, trees  # noqa: F401

TOL8 = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mode", ["w8a8", "w4a16"])
def test_quantized_evaluate_matches_jax(trees, mode):
    jmodel, params, req = trees
    bits, pred, group, kv8 = {
        "w8a8": (8, jq.lisa_serving_predicate, 64, True),
        "w4a16": (4, jq.default_llm_predicate, 16, False)}[mode]
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(
        params, pred, bits=bits, group=group))
    moe = qtree["llm"]["model"]["layers_1"]["moe"]
    assert moe["router"]["kernel"].dtype == np.float32
    assert all(moe[k].dtype == np.float32
               for k in ("gate_proj", "up_proj", "down_proj"))
    ref = _np(jax_evaluate(jmodel, T, EOS, kv_cache_8bit=kv8)(
        {"params": qtree}, *req))
    port = _port(qtree)
    got = _np(evaluate_fn(port, *req, T, EOS, kv_cache_8bit=kv8))
    _same(got, ref, TOL8, steps=False)
    # The port's own quantizer picks the same layers, and leaves the
    # router and the experts float.
    mine = _port(params)
    quant.quantize_model_(mine, getattr(quant, pred.__name__), bits=bits,
                          group=group)
    quantized = lambda m: {n for n, mod in m.named_modules()  # noqa: E731
                           if isinstance(mod, QDense) and mod.quantized}
    assert quantized(mine) == quantized(port)
    assert "llm.model.layers.1.self_attn.q_proj.base" in quantized(mine)
    moe = mine.llm.model.layers[1].moe
    assert not moe.router.quantized
    assert all(p.dtype == torch.float32 for p in moe.parameters())
