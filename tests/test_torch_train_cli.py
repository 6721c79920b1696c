"""The port's training entry point at the tiny preset on the CPU
(haff_tpu_torch/train/cli.py, train/checkpoints.py): micro-run, eval
only, preemption, auto-resume equal bit for bit to an uninterrupted run,
the checkpoint writer and its `max_to_keep`, QLoRA 8- and 4-bit with
validation, the flags that stay unported, and a Predictor serving a
checkpoint directory. Torch only; the data are files the tests write."""

import json
import os

import numpy as np
import pytest
import torch

from haff_tpu_torch.train import checkpoints as C
from haff_tpu_torch.train.cli import main

BASE = ["--model_preset", "tiny", "--batch_size", "2", "--grad_accum", "1",
        "--lr", "1e-3", "--warmup_steps", "0", "--model_max_length", "448",
        "--print_freq", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    """Four 2HANDS frames in one h5 + json shard pair and a one-frame
    benchmark folder (as tests/test_cli.py writes them)."""
    import cv2
    import h5py

    root = tmp_path_factory.mktemp("data")
    droot = root / "shards"
    (droot / "h5").mkdir(parents=True)
    (droot / "jsons").mkdir()
    n = 4
    with h5py.File(droot / "h5" / "0-3_P01.h5", "w") as f:
        g = f.create_group("data")
        g.create_dataset("inpainted", data=np.random.RandomState(0).randint(
            0, 255, (n, 64, 80, 3), np.uint8))
        g.create_dataset("narration", data=np.array(
            [b"open drawer", b"cut onion", b"pour water", b"wash plate"]))
        tax = np.zeros((n, 4), np.float32)
        tax[:, 1] = 1
        g.create_dataset("taxonomy", data=tax)
    entries = {str(i): {"original_size": [64, 80], "aff_left": [],
                        "aff_right": [[[[30, 20]], [[30, 40]], [[50, 40]],
                                       [[50, 20]]]]} for i in range(n)}
    (droot / "jsons" / "0-3_P01.json").write_text(json.dumps(entries))
    fdir = root / "bench" / "P01_101" / "0000123"
    fdir.mkdir(parents=True)
    cv2.imwrite(str(fdir / "inpainting.png"),
                (np.random.RandomState(1).rand(64, 80, 3) * 255
                 ).astype(np.uint8))
    gt = np.zeros((64, 80), np.uint8)
    gt[20:40, 30:50] = 255
    cv2.imwrite(str(fdir / "aff_right.png"), gt)
    (fdir / "annotation.json").write_text(
        json.dumps({"narration": "open drawer", "taxonomy": [0, 1, 0, 0]}))
    return str(droot), str(root / "bench")


def run_cli(data, tmp_path, exp, *extra):
    shards, bench = data
    return main(["--dataset_dir", shards, "--val_benchmark_dir", bench,
                 "--log_base_dir", str(tmp_path / "runs"), "--exp_name", exp,
                 *BASE, *extra])


def saved(tmp_path, exp, step=None):
    root = tmp_path / "runs" / exp / "ckpt_model"
    step = C.latest_step(str(root)) if step is None else step
    return torch.load(root / str(step) / C.STATE, weights_only=True)


def test_train_cli_micro_run(synth_data, tmp_path):
    run = run_cli(synth_data, tmp_path, "t", "--epochs", "1",
                  "--steps_per_epoch", "2", "--no_remat", "--val_batch_size",
                  "2", "--workers", "2")
    assert [s["step"] for s in run.steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in run.steps)
    (epoch, iou, iocm, frames, _), = run.validations
    assert epoch == 0 and 0 <= iou <= 1 and 0 <= iocm <= 1 and len(frames) == 1
    step_dir = tmp_path / "runs" / "t" / "ckpt_model" / "2"
    assert sorted(os.listdir(step_dir)) == ["metrics.json", "model.json",
                                           "state.pt"]
    assert json.loads((step_dir / "metrics.json").read_text()) == {"iou": iou}
    snap = saved(tmp_path, "t")
    assert snap["step"] == 2
    for name, p in run.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(snap["trainable"][name], p.detach())
    assert run.checkpoints[0]["step"] == 2 and run.checkpoints[0]["written_s"] > 0


def test_train_cli_hybrid_mix(synth_data, tmp_path):
    """Every corpus the CLI mixes (`--dataset` a||b||..., `--sample_rates`),
    each on a one-item folder written here, through two steps."""
    import cv2

    img = np.random.RandomState(5).randint(0, 255, (40, 60, 3), np.uint8)
    for d in ("sem/images", "sem/annotations", "refer/images", "reason/train",
              "vqa"):
        (tmp_path / d).mkdir(parents=True)
    cv2.imwrite(str(tmp_path / "sem/images/a.jpg"), img)
    ann = np.zeros((40, 60), np.uint8)
    ann[5:20, 5:30] = 1
    cv2.imwrite(str(tmp_path / "sem/annotations/a.png"), ann)
    (tmp_path / "classes.txt").write_text("background\npan\n")
    cv2.imwrite(str(tmp_path / "refer/images/r.jpg"), img)
    (tmp_path / "refer/instances.json").write_text(json.dumps({
        "images": [{"id": 1, "file_name": "r.jpg", "height": 40,
                    "width": 60}],
        "annotations": [{"id": 2, "image_id": 1,
                         "segmentation": [[5, 5, 20, 5, 20, 20, 5, 20]]}],
        "categories": []}))
    (tmp_path / "refer/refs.json").write_text(json.dumps([{
        "ref_id": 1, "ann_id": 2, "image_id": 1, "split": "train",
        "sentences": [{"sent": "the red mug"}]}]))
    cv2.imwrite(str(tmp_path / "reason/train/x.jpg"), img)
    (tmp_path / "reason/train/x.json").write_text(json.dumps({
        "text": "the cup", "is_sentence": False, "shapes": [
            {"label": "t", "points": [[5, 5], [30, 5], [30, 20]]}]}))
    cv2.imwrite(str(tmp_path / "vqa/v.jpg"), img)
    (tmp_path / "vqa.json").write_text(json.dumps([{
        "image": "v.jpg", "conversations": [
            {"from": "human", "value": "<image>\nWhat is this?"},
            {"from": "gpt", "value": "A kitchen."}]}]))
    run = run_cli(
        synth_data, tmp_path, "mix", "--epochs", "1", "--steps_per_epoch",
        "2", "--no_eval", "--no_remat", "--dataset",
        "affordance||sem_seg||refer_seg||reason_seg||vqa", "--sample_rates",
        "3,1,1,1,1", "--sem_seg_data", str(tmp_path / "sem"),
        "--sem_seg_classes", str(tmp_path / "classes.txt"),
        "--refer_seg_data", str(tmp_path / "refer"), "--reason_seg_data",
        str(tmp_path / "reason"), "--vqa_data", str(tmp_path / "vqa.json"),
        "--vqa_image_dir", str(tmp_path / "vqa"))
    assert len(run.steps) == 2 and all(np.isfinite(s["loss"])
                                       for s in run.steps)
    with pytest.raises(SystemExit, match="unknown dataset 'nope'"):
        run_cli(synth_data, tmp_path, "bad", "--dataset", "nope")


def test_train_cli_eval_only(synth_data, tmp_path):
    run = run_cli(synth_data, tmp_path, "e", "--eval_only", "--no_remat")
    assert len(run.validations) == 1 and not run.steps
    assert not (tmp_path / "runs" / "e" / "ckpt_model").exists()
    with pytest.raises(SystemExit, match="--eval_only needs"):
        main(["--dataset_dir", synth_data[0], "--eval_only",
              "--log_base_dir", str(tmp_path / "runs"), "--exp_name", "e2",
              *BASE])


def test_train_cli_preemption_checkpoint(synth_data, tmp_path, capsys,
                                         monkeypatch):
    monkeypatch.setenv("HAFF_TEST_PREEMPT_STEP", "1")
    run = run_cli(synth_data, tmp_path, "p", "--epochs", "1",
                  "--steps_per_epoch", "50", "--no_eval", "--no_remat")
    assert run.preempted and len(run.steps) == 2
    assert "preemption checkpoint at step 2" in capsys.readouterr().out
    assert C.latest_step(str(tmp_path / "runs" / "p" / "ckpt_model")) == 2


def test_train_cli_auto_resume_bit_identical(synth_data, tmp_path,
                                             monkeypatch):
    """2 steps (stopped by the preemption hook), then 2 more after an
    auto-resume: trainable tensors and optimizer state bit-identical to 4
    uninterrupted steps. Two workers build the batches."""
    flags = ("--epochs", "2", "--steps_per_epoch", "2", "--no_eval",
             "--workers", "2", "--lora_dropout", "0.3")
    monkeypatch.setenv("HAFF_TEST_PREEMPT_STEP", "1")
    first = run_cli(synth_data, tmp_path, "r", *flags)
    monkeypatch.delenv("HAFF_TEST_PREEMPT_STEP")
    assert first.preempted and [s["step"] for s in first.steps] == [1, 2]
    resumed = run_cli(synth_data, tmp_path, "r", *flags)
    assert resumed.start_step == 2
    assert [s["step"] for s in resumed.steps] == [3, 4]
    whole = run_cli(synth_data, tmp_path, "w", *flags)
    assert [s["step"] for s in whole.steps] == [1, 2, 3, 4]
    assert [s["loss"] for s in whole.steps[2:]] == [
        s["loss"] for s in resumed.steps]
    a, b = saved(tmp_path, "r"), saved(tmp_path, "w")
    assert a["step"] == b["step"] == 4
    for name, t in b["trainable"].items():
        assert torch.equal(a["trainable"][name], t), name
    for k, st in b["optimizer"]["adamw"]["state"].items():
        for key, t in st.items():
            assert torch.equal(a["optimizer"]["adamw"]["state"][k][key], t)
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    # --resume names the checkpoint explicitly; an empty one raises
    with pytest.raises(SystemExit, match="no checkpoint found"):
        run_cli(synth_data, tmp_path, "x", *flags, "--resume",
                str(tmp_path / "nothing"))


class _State:
    """A minimal TrainState for the writer tests."""

    def __init__(self, step):
        from haff_tpu_torch.core.config import TrainConfig
        from haff_tpu_torch.train.trainer import init_train_state

        self.p = torch.nn.Parameter(torch.full((3,), float(step)))
        st = init_train_state(TrainConfig(), {"w": self.p})
        self.step, self.trainable, self.optimizer = step, st.trainable, st.optimizer


def test_checkpoint_max_to_keep_and_writer_finish(tmp_path):
    root = str(tmp_path / "ck")
    for step in (1, 2, 3):
        C.save_checkpoint(root, step, _State(step), max_to_keep=2)
    assert C._steps(root) == [2, 3]
    writer = C.CheckpointWriter(root, max_to_keep=1, model_meta={"seed": 1})
    state = _State(4)
    writer.save(4, state, metrics={"iou": 0.5})
    with torch.no_grad():
        state.p.fill_(9.0)  # after save: the host copy was taken already
    writer.save(5, _State(5))
    writer.finish()
    assert C._steps(root) == [5]
    assert C.read_json(os.path.join(root, "5", C.MODEL)) == {"seed": 1}
    assert not [n for n in os.listdir(root) if n.startswith(".tmp")]
    restored = _State(0)
    _, step = C.restore_checkpoint(root, restored)
    assert step == 5 and torch.equal(restored.p.detach(), torch.full((3,), 5.))
    writer = C.CheckpointWriter(str(tmp_path / "file"))
    (tmp_path / "file").write_text("not a directory")
    writer.save(1, _State(1))
    with pytest.raises(OSError):
        writer.finish()


@pytest.mark.parametrize("bits", [8, 4])
def test_train_cli_qlora_with_validation(synth_data, tmp_path, bits):
    """--load_in_8bit / --load_in_4bit: the frozen LLM projections become
    int8 / packed int4 in place, the trainable lm_head stays float, the
    adapters get gradients through the straight-through products, and the
    validation decodes over the quantized weights."""
    from haff_tpu_torch.nn.layers import QDense

    run = run_cli(synth_data, tmp_path, f"q{bits}", "--epochs", "1",
                  "--steps_per_epoch", "2", f"--load_in_{bits}bit")
    model = run.model
    want = torch.int8 if bits == 8 else torch.uint8
    quantized = {n for n, m in model.named_modules()
                 if isinstance(m, QDense) and m.quantized}
    assert quantized and all(
        dict(model.named_modules())[n].weight.dtype == want for n in quantized)
    assert not any("lm_head" in n for n in quantized)
    assert model.llm.lm_head.weight.dtype == torch.float32
    assert model.llm.lm_head.weight.requires_grad
    assert all(".base" in n or "self_attn" in n or "mlp" in n
               for n in quantized)
    snap = saved(tmp_path, f"q{bits}")
    assert not any("base" in n for n in snap["trainable"])
    lora_b = [t for n, t in snap["trainable"].items() if n.endswith("lora_b")]
    assert lora_b and all(t.abs().sum() > 0 for t in lora_b)
    assert len(run.validations) == 1


@pytest.mark.parametrize("flags,match", [
    (("--pp", "2"), r"1 devices not divisible by pp\*fsdp\*ep\*sp\*tensor=2"),
    (("--sp", "2"), r"1 devices not divisible by pp\*fsdp\*ep\*sp\*tensor=2"),
    (("--fsdp", "2"), r"1 devices not divisible by pp\*fsdp\*ep\*sp\*tensor=2"),
    (("--tensor", "2", "--data", "1"), "mesh 1x1x1x1x1x2 != 1 devices"),
    (("--moe_experts", "4", "--ep", "2"),
     r"1 devices not divisible by pp\*fsdp\*ep\*sp\*tensor=2"),
    (("--moe_experts", "4", "--moe_every", "0"), "--moe_every must be >= 1"),
    (("--pp", "2", "--sp", "2"), "--pp cannot be combined with --sp"),
    (("--ep", "2"), "--ep > 1 requires --moe_experts > 0"),
    (("--moe_experts", "3", "--ep", "2"), "must be divisible by"),
    (("--decoder", "mpt", "--ep", "2"), "--ep > 1 requires --moe_experts"),
])
def test_train_cli_rejected_flags(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        main(["--dataset_dir", str(tmp_path), "--log_base_dir",
              str(tmp_path / "runs"), *BASE, *flags])
    assert not (tmp_path / "runs").exists()


def test_predictor_loads_port_checkpoint(synth_data, tmp_path):
    """A Predictor given the run's ckpt_model directory rebuilds the run's
    model (seeded init, LoRA settings) and loads its trained tensors: the
    whole state_dict equals the trained model's, and it serves."""
    from haff_tpu_torch.infer.predictor import Predictor

    run = run_cli(synth_data, tmp_path, "pr", "--epochs", "1",
                  "--steps_per_epoch", "1", "--no_eval", "--precision",
                  "fp32")
    ckpt = str(tmp_path / "runs" / "pr" / "ckpt_model")
    pred = Predictor(model_preset="tiny", precision="fp32", max_new_tokens=4,
                     max_text_len=448, checkpoint=ckpt, device="cpu")
    got, want = pred.model.state_dict(), run.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    frame = np.random.RandomState(3).randint(0, 255, (48, 64, 3), np.uint8)
    text, ml, mr, tax = pred(frame, "open the drawer")
    assert ml.shape == (48, 64) and mr.shape == (48, 64) and tax.shape == (4,)
