"""The port's train CLI on a mesh (haff_tpu_torch/train/cli.py) at the
tiny preset on the CPU, in 4 gloo ranks (one spawn,
tests/torch_mesh_workers.py `case_cli`), on the 2HANDS shards of
tests/test_torch_train_cli.py.

* `--tensor 2 --sp 2`: two steps with a checkpoint, then a second run
  under the same --exp_name that auto-resumes at step 2 and trains two
  more: each rank's per-step losses and grad_norm equal the one-process
  CLI's over the same two runs (float32, LoRA r8 with the default dropout
  0.05; within 1e-5, grad_norm 1e-4 relative); the parameters stay on the
  CPU as asked; rank 0 alone wrote the checkpoints, in the one-process
  layout.
* The flags the CLI refused on a mesh before pipeline and expert
  parallelism were ported now run: MoE layers on a mesh (`--moe_experts
  2` under tensor 2 x sp 2, and `--ep 2`), validation on a mesh
  (`--eval_only` under tensor 2), `--pp 2 --tensor 2` with a validation,
  and QLoRA bases under `--fsdp/--tensor` (`--tensor 2 --load_in_8bit`,
  `--fsdp 2 --load_in_4bit`), a step and a validation each: losses
  within 1e-5 and IoU / IoCM equal to the one-process runs'. On one process those flags exit asking for the
  ranks; JAX's combination errors are JAX's CLI's, word for word.
"""

import pytest
import torch

from haff_tpu_torch.train import checkpoints as C
from haff_tpu_torch.train.cli import main
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


# Each runs on the mesh with the flags in [0] and on one process with [1].
SLICE_18 = {
    "moe": (MESH + ["--moe_experts", "2"], ["--moe_experts", "2"]),
    "eval_only": (["--tensor", "2", "--eval_only"], ["--eval_only"]),
    "pp2_tensor2": (["--pp", "2", "--tensor", "2"], []),
    "ep2": (["--moe_experts", "2", "--ep", "2"], ["--moe_experts", "2"]),
    "tensor2_8bit": (["--tensor", "2", "--load_in_8bit"], ["--load_in_8bit"]),
    "fsdp2_4bit": (["--fsdp", "2", "--load_in_4bit"], ["--load_in_4bit"]),
}


def _slice_18_argv(shards, bench, root, exp, flags):
    base = [a for a in BASE if a != "--no_eval"]
    return ["--dataset_dir", shards, "--log_base_dir", str(root),
            "--exp_name", exp, *base, "--epochs", "1", "--steps_per_epoch",
            "1", "--val_benchmark_dir", bench, *flags]


@pytest.fixture(scope="module")
def runs(synth_data, tmp_path_factory):  # noqa: F811
    shards, bench = synth_data
    root = tmp_path_factory.mktemp("runs")
    more = [_slice_18_argv(shards, bench, root, "m_" + k, mesh)
            for k, (mesh, _) in SLICE_18.items()]
    got = run_ranks("cli", dict(argvs=_argvs(shards, root, "mesh", *MESH)
                                + more),
                    4, tmp_path_factory.mktemp("cli"), timeout=420)
    want = [main(argv) for argv in _argvs(shards, root, "one")]
    one = {k: main(_slice_18_argv(shards, bench, root, "o_" + k, flags))
           for k, (_, flags) in SLICE_18.items()}
    return got, want, root, one


def test_mesh_cli_continues_the_one_process_losses(runs):
    got, want, _, _ = runs
    want_steps = [s for run in want for s in run.steps]
    assert [s["step"] for s in want_steps] == [1, 2, 3, 4]
    for r, res in enumerate(got):
        first, second = res["runs"][:2]
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
    _, want, root, _ = runs
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
    """Run on a mesh now (the module docstring): each such run's losses
    within 1e-5 and its validation's IoU and IoCM equal to the one-process
    run's, on every rank."""
    got, _, _, one = runs
    for r, res in enumerate(got):
        for k, run in zip(SLICE_18, res["runs"][2:]):
            want = one[k]
            assert len(run["steps"]) == len(want.steps), (k, r)
            for have, ref in zip(run["steps"], want.steps):
                assert abs(have["loss"] - ref["loss"]) <= 1e-5, (k, r)
            (_, iou, iocm, _, _), = run["validations"]
            (_, w_iou, w_iocm, _, _), = want.validations
            assert (iou, iocm) == (w_iou, w_iocm), (k, r)


@pytest.mark.parametrize("flags", [
    ("--pp", "2"),
    ("--moe_experts", "2", "--ep", "2"),
    ("--tensor", "2", "--load_in_8bit"),
    ("--fsdp", "2", "--load_in_4bit"),
], ids=" ".join)
def test_unported_flags_exit_naming_slice_18(tmp_path, flags):
    """Flags the port once refused on any mesh: on one process they
    exit asking for more ranks (they run on a mesh: above), before any run
    directory is made."""
    with pytest.raises(SystemExit) as e:
        main(["--dataset_dir", str(tmp_path), "--log_base_dir",
              str(tmp_path / "runs"), *BASE, *flags])
    assert "1 devices not divisible by pp*fsdp*ep*sp*tensor=2" in \
        str(e.value)
    assert "torchrun --nproc_per_node" in str(e.value)
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
