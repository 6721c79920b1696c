"""The slice end to end: the port's `evaluate_fn`
(haff_tpu_torch/infer/evaluate.py) against
`haff_tpu.infer.evaluate.evaluate_fn` at the tiny preset, with the same
bridged float32 weights and inputs: CLIP tower + splice, LLaMA prefill and
greedy decode with hidden capture, [SEG] gather, SAM encode, dual decode
with the taxonomy head, canvas upsample.

The lm_head column of [SEG] is doubled in the shared weights so that two
of the three rows emit [SEG] (at different steps) and one does not, and
EOS is a token row 0 emits, so the gather, `seg_found` and the per-row
stop are all exercised. Tokens and lengths must be identical; masks and
taxonomy agree within 1e-4 abs + rel (float32, summation order).
"""

import numpy as np
import pytest
import torch

from haff_tpu.core.config import IMAGE_TOKEN_INDEX
from haff_tpu.infer.evaluate import make_jitted_evaluate
from haff_tpu_torch.infer.evaluate import evaluate_fn
from test_torch_bridge import jax_tiny_params, port_model

B, L, T, EOS = 3, 10, 6, 248
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def both():
    jmodel, params = jax_tiny_params()
    cfg = jmodel.cfg
    params["llm"]["lm_head"]["kernel"][:, cfg.seg_token_idx] *= 2.0
    rng = np.random.default_rng(7)
    ids = rng.integers(5, 400, (B, L)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    att = np.ones((B, L), np.int32)
    att[1, 7:] = 0
    att[2, 5:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    isam = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    iclip = rng.standard_normal((B, C, C, 3)).astype(np.float32)
    ref = make_jitted_evaluate(jmodel, T, EOS)(
        {"params": params}, isam, iclip, ids, att)
    got = evaluate_fn(port_model(params), isam, iclip, ids, att, T, EOS)
    return ({k: np.asarray(v) for k, v in ref._asdict().items()
             if v is not None},
            {k: v.numpy() for k, v in got._asdict().items()
             if v is not None})


def test_tokens_and_lengths_identical(both):
    ref, got = both
    np.testing.assert_array_equal(got["output_ids"], ref["output_ids"])
    np.testing.assert_array_equal(got["gen_lengths"], ref["gen_lengths"])
    assert got["gen_lengths"][0] < T  # row 0 stopped at EOS


def test_seg_found_identical(both):
    ref, got = both
    np.testing.assert_array_equal(got["seg_found"], ref["seg_found"])
    assert got["seg_found"].tolist() == [False, True, True]


@pytest.mark.parametrize("key", ["pred_masks_left", "pred_masks_right",
                                 "taxonomies"])
def test_masks_and_taxonomy_agree(both, key):
    ref, got = both
    assert got[key].shape == ref[key].shape
    assert np.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key], ref[key], **TOL)
