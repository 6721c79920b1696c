"""The port's Predictor with int8 weights (W8A8) and the int8 KV cache
against haff_tpu's at the tiny preset on the CPU: both sides quantize the
same float weights (the JAX predictor's initial parameters, carried over
through an export .npz) with bit-equal quantizers. Identical answer text;
masks at the original size and the taxonomy within 2e-2, the standing
8-bit agreement of the port's quantized evaluate."""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.infer.evaluate import make_jitted_evaluate
from haff_tpu.infer.predictor import Predictor as JaxPredictor
from haff_tpu.nn.quant import lisa_serving_predicate, quantize_dense_tree
from haff_tpu_torch.infer.predictor import Predictor
from test_torch_bridge import write_npz
from test_torch_predictor import KW, PROMPTS, _assert_agree


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8)
            for hw in ((60, 90), (48, 40))]


def test_8bit_weights_and_cache_match(frames, tmp_path):
    # JAX: the float predictor's initial weights quantized and served as
    # Predictor(load_in_8bit=True, kv_cache_8bit=True) does it (the same
    # calls), which spares a second compile of the JAX model's init.
    jax_pred = JaxPredictor(**KW)
    npz = write_npz(jax_pred.params, tmp_path / "p.npz")
    jax_pred.params = jax.device_put(quantize_dense_tree(
        jax_pred.params, lisa_serving_predicate))
    jax_pred._eval = make_jitted_evaluate(
        jax_pred.model, max_new_tokens=KW["max_new_tokens"],
        eos_id=jax_pred.tok.eos_token_id, kv_cache_8bit=True)
    got = Predictor(**KW, load_in_8bit=True, kv_cache_8bit=True,
                    checkpoint=npz, device="cpu")
    assert got.model.llm.lm_head.weight.dtype == torch.int8
    _assert_agree(got.predict_batch(frames, PROMPTS),
                  jax_pred.predict_batch(frames, PROMPTS), 2e-2)
