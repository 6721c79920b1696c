"""The port's training entry point with the MPT decoder (`--decoder mpt`)
at the tiny preset on the CPU, port only: an auto-resumed run
bit-identical to an uninterrupted one, and `--load_in_8bit` with
validation and a Predictor serving the checkpoint (the runs against
haff_tpu's CLI are in tests/test_torch_train_cli_mpt.py)."""

import json

import numpy as np
import torch

from haff_tpu_torch.data import collate as tcollate
from haff_tpu_torch.train import checkpoints as C

FLAGS = ["--model_preset", "tiny", "--decoder", "mpt", "--batch_size", "2",
         "--grad_accum", "1", "--lr", "1e-3", "--warmup_steps", "0",
         "--model_max_length", "448", "--print_freq", "1", "--precision",
         "fp32", "--workers", "1", "--seed", "3"]


def samples(Sample):
    """Two affordance samples (right hand, then left)."""
    rs = np.random.RandomState(0)
    out = []
    for i, (q, a) in enumerate((("open the drawer", "[SEG] right"),
                                ("cut the onion", "[SEG] left"))):
        mask = np.zeros((64, 80), np.uint8)
        mask[10 + 10 * i:40, 20:60 - 10 * i] = 1
        out.append(Sample(
            image=rs.randint(0, 255, (64, 80, 3), np.uint8),
            question=f"<image>\nWhat can the hand do to {q}?", answer=a,
            mask_left=mask if i else np.zeros_like(mask),
            mask_right=np.zeros_like(mask) if i else mask,
            taxonomy=np.eye(4, dtype=np.float32)[1 + i]))
    return out


class Fixed:
    """A dataset returning the same samples in turn, whatever its seed."""

    def __init__(self, items):
        self.items, self.n, self.datasets = items, 0, ()
        self.rng = np.random.RandomState(0)

    def __getitem__(self, idx):
        item = self.items[self.n % len(self.items)]
        self.n += 1
        return item


def run_port(monkeypatch, tmp_path, exp, *extra):
    from haff_tpu_torch.train import cli

    items = samples(tcollate.Sample)
    monkeypatch.setattr(cli, "build_dataset", lambda args, seed: Fixed(items))
    return cli.main(["--dataset_dir", str(tmp_path), "--log_base_dir",
                     str(tmp_path / "runs"), "--exp_name", exp, "--device",
                     "cpu", *FLAGS, *extra])


def test_mpt_cli_auto_resume_bit_identical(monkeypatch, tmp_path):
    flags = ("--epochs", "2", "--steps_per_epoch", "2", "--no_eval")
    monkeypatch.setenv("HAFF_TEST_PREEMPT_STEP", "1")
    first = run_port(monkeypatch, tmp_path, "r", *flags)
    monkeypatch.delenv("HAFF_TEST_PREEMPT_STEP")
    assert first.preempted and [s["step"] for s in first.steps] == [1, 2]
    resumed = run_port(monkeypatch, tmp_path, "r", *flags)
    assert resumed.start_step == 2
    whole = run_port(monkeypatch, tmp_path, "w", *flags)
    assert [s["loss"] for s in whole.steps[2:]] == [
        s["loss"] for s in resumed.steps]
    root = tmp_path / "runs"
    a, b = (torch.load(root / e / "ckpt_model" / "4" / C.STATE,
                       weights_only=True) for e in ("r", "w"))
    for name, t in b["trainable"].items():
        assert torch.equal(a["trainable"][name], t), name
    for k, st in b["optimizer"]["adamw"]["state"].items():
        for key, t in st.items():
            assert torch.equal(a["optimizer"]["adamw"]["state"][k][key], t)


def test_mpt_cli_qlora_8bit_validation_and_predictor(monkeypatch, tmp_path):
    """QLoRA 8-bit quantizes the frozen MPT projections (Wqkv, out_proj,
    up_proj, down_proj); validation runs through the kept evaluate; a
    Predictor given the checkpoint rebuilds the MPT model from its
    model.json and serves it."""
    import cv2

    from haff_tpu_torch.infer.predictor import Predictor
    from haff_tpu_torch.nn.layers import QDense

    fdir = tmp_path / "bench" / "P01_101" / "0000123"
    fdir.mkdir(parents=True)
    cv2.imwrite(str(fdir / "inpainting.png"),
                np.random.RandomState(1).randint(0, 255, (64, 80, 3),
                                                 np.uint8))
    gt = np.zeros((64, 80), np.uint8)
    gt[20:40, 30:50] = 255
    cv2.imwrite(str(fdir / "aff_right.png"), gt)
    (fdir / "annotation.json").write_text(
        json.dumps({"narration": "open drawer", "taxonomy": [0, 1, 0, 0]}))
    run = run_port(monkeypatch, tmp_path, "q", "--epochs", "1",
                   "--steps_per_epoch", "1", "--load_in_8bit",
                   "--val_benchmark_dir", str(tmp_path / "bench"))
    quantized = {n for n, m in run.model.named_modules()
                 if isinstance(m, QDense) and m.quantized}
    assert quantized and all(n.startswith("llm.blocks.") and n.split(".")[-1]
                             in ("Wqkv", "out_proj", "up_proj", "down_proj")
                             for n in quantized)
    assert len(run.validations) == 1 and np.isfinite(run.steps[0]["loss"])
    pred = Predictor(model_preset="tiny", precision="fp32", max_new_tokens=4,
                     max_text_len=448, device="cpu",
                     checkpoint=str(tmp_path / "runs" / "q" / "ckpt_model"))
    assert type(pred.model.llm).__name__ == "MptForCausalLM"
    snap = torch.load(tmp_path / "runs" / "q" / "ckpt_model" / "1" / C.STATE,
                      weights_only=True)
    own = pred.model.state_dict()
    for name, t in snap["trainable"].items():
        assert torch.equal(own[name], t), name
    frame = np.random.RandomState(3).randint(0, 255, (48, 64, 3), np.uint8)
    text, ml, mr, tax = pred(frame, "open the drawer")
    assert ml.shape == (48, 64) and mr.shape == (48, 64) and tax.shape == (4,)
