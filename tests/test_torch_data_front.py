"""The port's data front end (haff_tpu_torch/data/tokenizer.py, prompts.py,
collate.py, aff_dataset.py) against haff_tpu's: the same strings, frames
and benchmark folders give the same token ids, labels and arrays, byte for
byte."""

import json
import os

import cv2
import numpy as np
import pytest

from haff_tpu.data import aff_dataset as ja
from haff_tpu.data import collate as jc
from haff_tpu.data import prompts as jp
from haff_tpu.data import tokenizer as jt
from haff_tpu_torch.data import aff_dataset as ta
from haff_tpu_torch.data import collate as tc
from haff_tpu_torch.data import prompts as tp
from haff_tpu_torch.data import tokenizer as tt

TEXTS = ["", "open the drawer", "héllo wörld ✓", "[SEG] and <im_start>x<im_end>",
         "<image>\nWhere would you interact [SEG]."]
QUESTION = "<image>\nPlease segment the region to perform the action 'cut'."
TURNS = [(QUESTION, "Sure, [SEG]."), ("And the lid?", "It is [SEG].")]


@pytest.fixture(scope="module")
def toks():
    return jt.ByteTokenizer(), tt.ByteTokenizer()


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_equal(toks, text):
    j, t = toks
    for special in (True, False):
        ids = t(text, add_special_tokens=special).input_ids
        assert ids == j(text, add_special_tokens=special).input_ids
        for skip in (True, False):
            assert t.decode(ids, skip) == j.decode(ids, skip)
    assert t.decode(np.array([1, 2, 3, 999, 104])) == j.decode(
        np.array([1, 2, 3, 999, 104]))


def test_vocab_specials_and_loader(toks):
    j, t = toks
    assert len(t) == len(j) and t.vocab_size == j.vocab_size
    assert tt.seg_token_idx(t) == jt.seg_token_idx(j)
    for name in ("bos_token_id", "eos_token_id", "pad_token_id"):
        assert getattr(t, name) == getattr(j, name)
    # No path: the byte tokenizer, as in the JAX package.
    assert isinstance(tt.load_tokenizer(None, 77), tt.ByteTokenizer)
    assert tt.load_tokenizer("/nonexistent", 77).model_max_length == 77


@pytest.mark.parametrize("prompt", ["<image>\nx", "a <image> b <image> c",
                                    "no image", "<image>"])
def test_tokenizer_image_token_equal(toks, prompt):
    j, t = toks
    assert tt.tokenizer_image_token(prompt, t) == jt.tokenizer_image_token(
        prompt, j)


def test_prompt_constants_equal():
    assert tp.SHORT_QUESTION_LIST == jp.SHORT_QUESTION_LIST
    assert tp.ANSWER_LIST == jp.ANSWER_LIST
    assert tp.INFERENCE_QUESTION == jp.INFERENCE_QUESTION
    assert set(tp.CONV_TEMPLATES) == set(jp.CONV_TEMPLATES)
    for conv_type in tp.CONV_TEMPLATES:
        for ans in ("Sure, [SEG].", None):
            assert tp.build_conversation(QUESTION, ans, conv_type) == \
                jp.build_conversation(QUESTION, ans, conv_type)
        for wrap in (True, False):
            assert tp.wrap_image_tokens(QUESTION, wrap) == \
                jp.wrap_image_tokens(QUESTION, wrap)


@pytest.mark.parametrize("conv_type", ["llava_v1", "llava_llama_2"])
@pytest.mark.parametrize("mm", [True, False])
@pytest.mark.parametrize("template,answer", [(True, "Sure, it is [SEG]."),
                                             (True, None), (False, None)])
def test_tokenize_conversation_equal(toks, conv_type, mm, template, answer):
    j, t = toks
    got = tc.tokenize_conversation(QUESTION, answer, t, conv_type, mm,
                                   use_template=template)
    ref = jc.tokenize_conversation(QUESTION, answer, j, conv_type, mm,
                                   use_template=template)
    assert got == ref


@pytest.mark.parametrize("conv_type", ["llava_v1", "llava_llama_2"])
@pytest.mark.parametrize("mm", [True, False])
def test_tokenize_multiturn_equal(toks, conv_type, mm):
    j, t = toks
    got = tc.tokenize_multiturn(TURNS, t, conv_type, mm)
    assert got == jc.tokenize_multiturn(TURNS, j, conv_type, mm)
    assert any(x != -100 for x in got[1])


def _samples(mod, rng):
    out = []
    for i, hw in enumerate([(40, 56), (64, 30), (25, 25)]):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        ml = (rng.rand(*hw) > 0.5).astype(np.uint8)
        out.append(mod.Sample(
            image=img, question=QUESTION, answer=tp.ANSWER_LIST[i],
            mask_left=ml, mask_right=None if i == 1 else 1 - ml,
            taxonomy=np.eye(4, dtype=np.float32)[i],
            turns=TURNS if i == 2 else None))
    return out


@pytest.mark.parametrize("for_training,template", [(True, True),
                                                   (False, True),
                                                   (False, False)])
def test_collate_affordance_byte_equal(toks, for_training, template):
    j, t = toks
    kw = dict(sam_image_size=64, clip_image_size=32, max_text_len=96,
              batch_size=4, for_training=for_training,
              use_template=template)
    got = tc.collate_affordance(_samples(tc, np.random.RandomState(0)), t,
                                **kw)
    ref = jc.collate_affordance(_samples(jc, np.random.RandomState(0)), j,
                                **kw)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["resizes"].tolist()[:3] == [[46, 64], [64, 30], [64, 64]]


def test_rasterize_contours_equal():
    contours = [[[2, 3], [20, 4], [15, 18]], [[25, 25], [30, 25], [30, 31]]]
    got = ta.rasterize_contours(contours, (32, 40))
    np.testing.assert_array_equal(got, ja.rasterize_contours(contours,
                                                             (32, 40)))
    assert got.dtype == np.uint8 and got.sum() > 0


@pytest.mark.parametrize("style,require_masks", [("inference", False),
                                                 ("validate", True)])
def test_aff_dataset_val_items_equal(tmp_path, style, require_masks):
    rng = np.random.RandomState(0)
    for i in range(3):  # frame 2 has no hand mask
        fdir = os.path.join(tmp_path, "vid", f"{i:07d}")
        os.makedirs(fdir)
        cv2.imwrite(os.path.join(fdir, "inpainting.png"),
                    (rng.rand(20, 30, 3) * 255).astype(np.uint8))
        with open(os.path.join(fdir, "annotation.json"), "w") as f:
            json.dump({"narration": "Open Drawer",
                       "taxonomy": np.eye(4)[i].tolist()}, f)
        if i < 2:
            cv2.imwrite(os.path.join(fdir, "aff_left.png"),
                        (rng.rand(20, 30) > 0.5).astype(np.uint8) * 255)
    got = ta.AffDatasetVal(str(tmp_path), require_masks, style, seed=3)
    ref = ja.AffDatasetVal(str(tmp_path), require_masks, style, seed=3)
    assert len(got) == len(ref) == (2 if require_masks else 3)
    for i in range(len(ref)):
        (gs, ge), (rs, re_) = got[i], ref[i]
        assert ge == re_ and gs.question == rs.question
        for key in ("image", "mask_left", "mask_right", "taxonomy"):
            np.testing.assert_array_equal(getattr(gs, key), getattr(rs, key))
