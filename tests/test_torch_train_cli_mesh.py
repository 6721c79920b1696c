"""The port's train CLI on a mesh (haff_tpu_torch/train/cli.py with
`--tensor 2 --sp 2`) at the tiny preset on the CPU, in 4 gloo ranks (one
spawn, tests/torch_mesh_workers.py `case_cli`), on the 2HANDS shards of
tests/test_torch_train_cli.py.

* Two steps with a checkpoint, then a second run under the same
  --exp_name that auto-resumes at step 2 and trains two more: each rank's
  per-step losses and grad_norm equal the one-process CLI's over the same
  two runs (float32, LoRA r8 with the default dropout 0.05; within 1e-5,
  grad_norm 1e-4 relative); the parameters stay on the CPU as asked; rank
  0 alone wrote the checkpoints, in the one-process layout.
* What stays for slice 18 exits with `_NOT_PORTED` (--pp, --ep, MoE and
  validation on a mesh, quantized bases under --fsdp/--tensor), and JAX's
  combination errors are JAX's CLI's, word for word.
"""

import pytest
import torch

from haff_tpu_torch.train import checkpoints as C
from haff_tpu_torch.train.cli import _NOT_PORTED, main
from test_torch_train_cli import synth_data  # noqa: F401 (a fixture)
from torch_mesh_workers import run_ranks

BASE = ["--model_preset", "tiny", "--batch_size", "2", "--grad_accum", "1",
        "--lr", "1e-3", "--warmup_steps", "0", "--model_max_length", "448",
        "--print_freq", "1", "--device", "cpu", "--no_eval", "--workers", "1",
        "--precision", "fp32"]
MESH = ["--tensor", "2", "--sp", "2"]


def _argvs(shards, root, exp, *extra):
    common = ["--dataset_dir", shards, "--log_base_dir", str(root),
              "--exp_name", exp, *BASE, *extra]
    return [common + ["--epochs", "1", "--steps_per_epoch", "2"],
            common + ["--epochs", "2", "--steps_per_epoch", "2"]]


@pytest.fixture(scope="module")
def runs(synth_data, tmp_path_factory):  # noqa: F811
    shards, bench = synth_data
    root = tmp_path_factory.mktemp("runs")
    exits = [
        ["--dataset_dir", shards, "--log_base_dir", str(root / "x"), *BASE,
         *MESH, "--moe_experts", "2"],
        ["--dataset_dir", shards, "--log_base_dir", str(root / "x"), *BASE,
         "--tensor", "2", "--val_benchmark_dir", bench, "--eval_only"],
    ]
    got = run_ranks("cli", dict(argvs=_argvs(shards, root, "mesh", *MESH),
                                exits=exits),
                    4, tmp_path_factory.mktemp("cli"), timeout=240)
    want = [main(argv) for argv in _argvs(shards, root, "one")]
    return got, want, root


def test_mesh_cli_continues_the_one_process_losses(runs):
    got, want, _ = runs
    want_steps = [s for run in want for s in run.steps]
    assert [s["step"] for s in want_steps] == [1, 2, 3, 4]
    for r, res in enumerate(got):
        first, second = res["runs"]
        assert second["start_step"] == 2
        steps = first["steps"] + second["steps"]
        assert [s["step"] for s in steps] == [1, 2, 3, 4]
        for have, ref in zip(steps, want_steps):
            for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                      "taxonomy_ce_loss"):
                assert abs(have[k] - ref[k]) <= 1e-5, (r, have["step"], k)
            assert abs(have["grad_norm"] - ref["grad_norm"]) <= \
                1e-4 * ref["grad_norm"], (r, have["step"])
        assert first["devices"] == ["cpu"]


def test_rank0_writes_the_one_process_checkpoint_layout(runs):
    _, want, root = runs
    mesh = torch.load(root / "mesh" / "ckpt_model" / "4" / C.STATE,
                      weights_only=True)
    one = torch.load(root / "one" / "ckpt_model" / "4" / C.STATE,
                     weights_only=True)
    assert set(mesh["trainable"]) == set(one["trainable"])
    for n, t in one["trainable"].items():
        assert mesh["trainable"][n].shape == t.shape, n
        assert float((mesh["trainable"][n] - t).abs().max()) <= \
            1e-4 * float(t.abs().max()) + 1e-3, n   # after 4 AdamW updates
    assert not list((root / "mesh" / "ckpt_model").glob(".tmp-*"))


def test_slice_18_flags_exit_on_a_mesh(runs):
    got, _, _ = runs
    for res in got:
        moe, validation = res["exits"]
        assert "--moe_experts on a mesh of 4 ranks" in moe
        assert "validation on a mesh of 4 ranks" in validation
        for msg in (moe, validation):
            assert _NOT_PORTED in msg and "slice 18" in msg


@pytest.mark.parametrize("flags", [
    ("--pp", "2"),
    ("--moe_experts", "2", "--ep", "2"),
    ("--tensor", "2", "--load_in_8bit"),
    ("--fsdp", "2", "--load_in_4bit"),
], ids=" ".join)
def test_unported_flags_exit_naming_slice_18(tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        main(["--dataset_dir", str(tmp_path), "--log_base_dir",
              str(tmp_path / "runs"), *BASE, *flags])
    assert _NOT_PORTED in str(e.value) and "slice 18" in str(e.value)
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("flags", [
    ("--pp", "2", "--sp", "2"),
    ("--pp", "2", "--moe_experts", "2"),
    ("--ep", "2"),
    ("--moe_experts", "2", "--moe_every", "0"),
    ("--moe_experts", "3", "--ep", "2"),
], ids=" ".join)
def test_combination_errors_are_jax_word_for_word(tmp_path, flags):
    from haff_tpu.train.cli import main as jax_main

    argv = ["--dataset_dir", str(tmp_path), "--model_preset", "tiny"]
    with pytest.raises(SystemExit) as want:
        jax_main(argv + ["--log_base_dir", str(tmp_path / "jax"), *flags])
    with pytest.raises(SystemExit) as got:
        main(argv + ["--log_base_dir", str(tmp_path / "port"), *flags])
    assert str(got.value) == str(want.value)
