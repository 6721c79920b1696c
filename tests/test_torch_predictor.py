"""The port's Predictor (haff_tpu_torch/infer/predictor.py) against
haff_tpu's at the tiny preset in float32 on the CPU, with the JAX
predictor's own initial parameters carried over through an export .npz
(tools/bridge.py): collate, tokenizer, evaluate and the resize to each
frame's size. Identical answer text; masks at the original size and the
taxonomy within 1e-4 (float32, summation order). The 8-bit case is
test_torch_predictor_8bit.py."""

import numpy as np
import pytest
import torch

from haff_tpu.infer.predictor import Predictor as JaxPredictor
from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
from haff_tpu_torch.infer.predictor import Predictor
from test_torch_bridge import write_npz

KW = dict(model_preset="tiny", precision="fp32", max_new_tokens=4,
          max_text_len=448)
PROMPTS = ["open the drawer", "<image>\nWhere would you grab the cup?"]


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8)
            for hw in ((60, 90), (48, 40))]


@pytest.fixture(scope="module")
def jax_pred():
    return JaxPredictor(**KW)


@pytest.fixture(scope="module")
def npz(jax_pred, tmp_path_factory):
    return write_npz(jax_pred.params, tmp_path_factory.mktemp("w") / "p.npz")


@pytest.fixture(scope="module")
def port_pred(npz):
    return Predictor(**KW, checkpoint=npz, device="cpu")


def _assert_agree(got, ref, tol):
    assert len(got) == len(ref)
    for (t, ml, mr, tax), (rt, rml, rmr, rtax) in zip(got, ref):
        assert t == rt
        assert ml.shape == rml.shape and mr.shape == rmr.shape
        np.testing.assert_allclose(ml, rml, rtol=tol, atol=tol)
        np.testing.assert_allclose(mr, rmr, rtol=tol, atol=tol)
        np.testing.assert_allclose(tax, np.asarray(rtax), rtol=tol, atol=tol)


def test_predict_batch_matches(jax_pred, port_pred, frames):
    got = port_pred.predict_batch(frames, PROMPTS)
    _assert_agree(got, jax_pred.predict_batch(frames, PROMPTS), 1e-4)
    assert got[0][1].shape == (60, 90) and got[1][2].shape == (48, 40)
    assert abs(float(got[0][3].sum()) - 1.0) < 1e-5


def test_call_is_a_batch_of_one(port_pred, frames):
    text, ml, mr, tax = port_pred(frames[1], PROMPTS[1])
    ref = port_pred.predict_batch(frames, PROMPTS)[1]
    assert text == ref[0]
    for a, b in zip((ml, mr, tax), ref[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_jitted_evaluate_on_the_cpu_is_evaluate_fn(port_pred):
    model = port_pred.model
    cfg = model.cfg
    rng = np.random.RandomState(1)
    ids = rng.randint(5, 400, (2, 12))
    ids[:, 2] = -200
    att = np.ones((2, 12), np.int64)
    att[1, 9:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    isam = rng.randn(2, S, S, 3).astype(np.float32)
    iclip = rng.randn(2, C, C, 3).astype(np.float32)
    fn = make_jitted_evaluate(model, 5, 2)
    got, ref = fn(isam, iclip, ids, att), evaluate_fn(model, isam, iclip,
                                                      ids, att, 5, 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_checkpoint_directory_and_speculative_raise(tmp_path):
    # A directory holding no checkpoint of the port's train CLI (an orbax
    # one, say) raises; a port checkpoint loads (test_torch_train_cli.py).
    with pytest.raises(NotImplementedError, match="orbax checkpoints are not"):
        Predictor(**KW, checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Predictor(**KW, speculative=True, device="cpu")
