"""The train CLI's validation protocol: the port's `validate_on_benchmark`
(haff_tpu_torch/infer/evaluate.py) against haff_tpu's at the tiny preset
on the same bridged float32 weights, over a 2-frame benchmark folder the
test writes: one frame with both hands' GT, one with the right hand
missing and its GT kept on a canvas of another size than the frame.
Batches of 3 pad the 2 frames by repeating the last; the port also runs
in batches of 1. Same taxonomy per frame (so the same gating), IoU and
IoCM within 1e-4. One JAX model init."""

import json

import numpy as np
import pytest

from haff_tpu.data.aff_dataset import AffDatasetVal as JaxVal
from haff_tpu.data.tokenizer import ByteTokenizer as JaxTok
from haff_tpu.infer.evaluate import validate_on_benchmark as jax_validate
from haff_tpu_torch.data.aff_dataset import AffDatasetVal
from haff_tpu_torch.data.tokenizer import ByteTokenizer
from haff_tpu_torch.infer.evaluate import validate_on_benchmark
from test_torch_bridge import jax_tiny_params, port_model, write_npz

KW = dict(model_max_length=448, conv_type="llava_v1", use_mm_start_end=True)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("bench")
    rng = np.random.RandomState(5)
    for k, (narr, tax) in enumerate((("Open Drawer", [0, 0, 1, 0]),
                                     ("cut onion", [1, 0, 0, 0]))):
        fdir = root / "P01_101" / f"{k:07d}"
        fdir.mkdir(parents=True)
        cv2.imwrite(str(fdir / "inpainting.png"),
                    rng.randint(0, 255, (60, 80, 3)).astype(np.uint8))
        gh, gw = (60, 80) if k == 0 else (90, 120)  # frame 1: another canvas
        gt = np.zeros((gh, gw), np.uint8)
        gt[gh // 6:gh // 2, gw // 5:gw // 2] = 255
        cv2.imwrite(str(fdir / "aff_left.png"), gt)
        if k == 0:  # frame 1's right hand is missing
            cv2.imwrite(str(fdir / "aff_right.png"), np.roll(gt, 20, 1))
        (fdir / "annotation.json").write_text(json.dumps(
            {"narration": narr, "taxonomy": tax}))
    return str(root)


@pytest.fixture(scope="module")
def results(bench):
    jmodel, params = jax_tiny_params(seed=3)
    # a stronger [SEG] column so decoding emits [SEG] in some rows
    params["llm"]["lm_head"]["kernel"][:, jmodel.cfg.seg_token_idx] *= 3.0
    ref = jax_validate(jmodel, {"params": params}, JaxTok(model_max_length=448),
                       JaxVal(bench), val_batch_size=3, **KW)
    model = port_model(params)
    tok = ByteTokenizer(model_max_length=448)
    got = {vb: validate_on_benchmark(model, tok, AffDatasetVal(bench),
                                     val_batch_size=vb, **KW)
           for vb in (3, 1)}
    return ref, got, model, params


@pytest.mark.parametrize("vb", [3, 1])
def test_validate_matches_jax(results, vb):
    (iou, iocm, frames), got, _, _ = results
    g_iou, g_iocm, g_frames = got[vb]
    assert len(g_frames) == len(frames) == 2
    for a, b in zip(g_frames, frames):
        assert a["tax"] == b["tax"]
        assert abs(a["iou"] - b["iou"]) <= 1e-4
        assert abs(a["iocm"] - b["iocm"]) <= 1e-4
    assert abs(g_iou - iou) <= 1e-4 and abs(g_iocm - iocm) <= 1e-4


def test_validate_restores_train_mode(results, bench):
    _, got, model, _ = results
    model.train()
    again = validate_on_benchmark(model, ByteTokenizer(model_max_length=448),
                                  AffDatasetVal(bench), val_batch_size=1,
                                  **KW)
    assert model.training and again[:2] == got[1][:2]


def test_train_cli_eval_only_from_pretrained_params(results, bench, tmp_path):
    """`--pretrained_params` (an export .npz of the same weights) with
    `--eval_only` (no LoRA, the CLI's [SEG] id from its tokenizer): the
    CLI's validation equals `validate_on_benchmark` on the bridged model."""
    from haff_tpu_torch.train.cli import main

    params = results[3]
    tok = ByteTokenizer(model_max_length=448)
    from haff_tpu_torch.data.tokenizer import seg_token_idx

    want = validate_on_benchmark(
        port_model(params, seg_token_idx=seg_token_idx(tok)), tok,
        AffDatasetVal(bench), val_batch_size=1, **KW)
    # the CLI builds its training data even to evaluate: an empty
    # ReasonSeg folder will do
    run = main(["--dataset_dir", str(tmp_path), "--dataset", "reason_seg",
                "--reason_seg_data", str(tmp_path), "--val_benchmark_dir", bench,
                "--model_preset", "tiny", "--precision", "fp32",
                "--lora_r", "0", "--model_max_length", "448", "--eval_only",
                "--pretrained_params", write_npz(params, tmp_path / "p.npz"),
                "--log_base_dir", str(tmp_path / "runs"), "--device", "cpu"])
    (_, iou, iocm, frames, _), = run.validations
    assert (iou, iocm, frames) == want
