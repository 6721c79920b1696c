"""The port's training entry point with the MPT decoder (`--decoder mpt`)
at the tiny preset on the CPU, against haff_tpu's CLI.

One JAX CLI run (one step) and one port CLI run on the same weights (the
JAX run's initial parameters, given to the port as `--pretrained_params`)
and the same two samples a batch (both CLIs' datasets replaced by one that
returns them in turn): every step's loss terms within 1e-3 (relative) and
every trainable gradient within 1e-3 of the leaf's largest magnitude
(+1e-6). The JAX gradients are read from the optimizer state of a chain
that records them, the states from a recording checkpoint writer.

Also: the trainable set equal to JAX `partition_params` over the JAX
run's tree under each flag that changes it; no gradient into the MPT
decoder (JAX's trainable set reaches none of its parameters); and the
flag combinations JAX refuses, refused with JAX's words. The port-only
runs (auto-resume, QLoRA with validation, a Predictor serving the
checkpoint) are in tests/test_torch_train_cli_mpt_runs.py.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from haff_tpu.data import collate as jcollate
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.tools.bridge import flax_to_state_dict, save_npz
from haff_tpu_torch.train import trainer as ttrainer
from test_torch_train_cli_mpt_runs import FLAGS, Fixed, run_port, samples

STEPS = 1
LOSSES = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
          "taxonomy_ce_loss")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """haff_tpu's CLI, one step: its initial parameters, the step's logged
    loss terms and the saved state (with the step's raw gradients in the
    optimizer state)."""
    from haff_tpu.data import aff_dataset
    from haff_tpu.train import checkpoints as jckpt
    from haff_tpu.train import cli as jcli
    from haff_tpu.train import metrics as jmetrics

    mp = pytest.MonkeyPatch()
    got = {"params": None, "logs": [], "states": []}
    items = samples(jcollate.Sample)
    mp.setattr(aff_dataset, "AffDataset", lambda *a, **k: Fixed(items))
    partition = jtrainer.partition_params

    def capture_params(params, *a, **k):
        got["params"] = jax.device_get(params)
        return partition(params, *a, **k)

    make_optimizer = jtrainer.make_optimizer

    def recording_optimizer(cfg):
        tx = make_optimizer(cfg)

        def init(p):
            return {"grads": jax.tree_util.tree_map(jnp.zeros_like, p),
                    "tx": tx.init(p)}

        def update(g, state, params=None):
            u, s = tx.update(g, state["tx"], params)
            return u, {"grads": g, "tx": s}

        return optax.GradientTransformation(init, update)

    class Writer:
        def __init__(self, *a, **k):
            pass

        def save(self, step, state, metrics=None):
            got["states"].append(jax.device_get(state))

        def finish(self):
            pass

    class Logger:
        def __init__(self, *a, **k):
            pass

        def log(self, scalars, step):
            got["logs"].append(dict(scalars, step=step))

        def close(self):
            pass

    mp.setattr(jtrainer, "partition_params", capture_params)
    mp.setattr(jtrainer, "make_optimizer", recording_optimizer)
    mp.setattr(jckpt, "CheckpointWriter", Writer)
    mp.setattr(jmetrics, "MetricsLogger", Logger)
    root = tmp_path_factory.mktemp("jax_cli")
    try:
        jcli.main(["--dataset_dir", str(root), "--log_base_dir",
                   str(root / "runs"), "--exp_name", "j", "--epochs",
                   str(STEPS), "--steps_per_epoch", "1", "--no_eval", *FLAGS])
    finally:
        mp.undo()
    npz = str(root / "init.npz")
    save_npz(got["params"], npz, dtype="float32")
    return dict(got, npz=npz)


def jax_trainable(params, *flags):
    exclude = ("mask_decoder_left", "mask_decoder_right") if (
        "--no_train_mask_decoder" in flags) else ()
    extra = ("moe",) if "--moe_experts" in flags else ()
    if "--train_vision_encoder" in flags:
        extra += ("image_encoder",)
    trainable, _ = jtrainer.partition_params(params, exclude, extra)
    return set(flax_to_state_dict(trainable))


def test_mpt_cli_losses_and_gradients_match_jax(jax_run, monkeypatch,
                                                 tmp_path):
    grads, names = [], []
    update = ttrainer.Optimizer.update
    init_state = ttrainer.init_train_state

    def recording_update(self, g, norm=None):
        grads.append([None if t is None else t.clone() for t in g])
        return update(self, g, norm)

    def naming_init(cfg, trainable):
        names.extend(trainable)
        return init_state(cfg, trainable)

    monkeypatch.setattr(ttrainer.Optimizer, "update", recording_update)
    monkeypatch.setattr(ttrainer, "init_train_state", naming_init)
    run = run_port(monkeypatch, tmp_path, "p", "--epochs", str(STEPS),
                   "--steps_per_epoch", "1", "--no_eval",
                   "--pretrained_params", jax_run["npz"])
    assert len(run.steps) == len(jax_run["logs"]) == STEPS
    for got, want in zip(run.steps, jax_run["logs"]):
        assert got["step"] == want["step"]
        for k in LOSSES:
            assert abs(got[k] - want[k]) <= 1e-3 * max(1.0, abs(want[k])), (
                got["step"], k, got[k], want[k])
    assert set(names) == jax_trainable(jax_run["params"])
    for step, state in enumerate(jax_run["states"]):
        want = flax_to_state_dict(state.opt_state["grads"])
        assert set(want) == set(names)
        for name, g in zip(names, grads[step]):
            # None: the loss does not reach the leaf (JAX: zeros).
            g = torch.zeros_like(want[name]) if g is None else g
            w = want[name].numpy()
            tol = 1e-3 * np.abs(w).max() + 1e-6
            assert np.abs(g.numpy() - w).max() <= tol, (step, name)
    # No gradient reached the decoder: none of its parameters trains, and
    # its output carries no graph (so no flash backward would launch).
    llm = run.model.llm
    assert not any(p.requires_grad or p.grad is not None
                   for p in llm.parameters())
    emb = llm.embed(torch.tensor([[5, 6, 7, 8]]))
    logits, hidden, _ = llm(emb, remat=True)
    assert not logits.requires_grad and not hidden.requires_grad


@pytest.mark.parametrize("flags", [
    (), ("--train_vision_encoder",), ("--no_train_mask_decoder",),
    ("--moe_experts", "2", "--reset_mask_decoder"), ("--load_in_4bit",)])
def test_mpt_cli_trainable_set_equals_jax(jax_run, monkeypatch, tmp_path,
                                          flags):
    """Each flag JAX's CLI takes with --decoder mpt runs a step, and the
    trainable set is JAX's partition of its own tree under that flag
    (MPT has no LoRA, a tied `wte`, no `lm_head`, no MoE layers)."""
    run = run_port(monkeypatch, tmp_path, "f", "--epochs", "1",
                   "--steps_per_epoch", "1", "--no_eval", *flags)
    assert len(run.steps) == 1 and np.isfinite(run.steps[0]["loss"])
    got = {n for n, p in run.model.named_parameters() if p.requires_grad}
    assert got == jax_trainable(jax_run["params"], *flags)
    assert not any(n.startswith("llm.") for n in got)


@pytest.mark.parametrize("flags", [
    ("--pp", "2", "--sp", "2"), ("--ep", "2"),
    ("--moe_experts", "2", "--moe_every", "0"),
    ("--moe_experts", "3", "--ep", "2"),
    ("--pp", "2", "--moe_experts", "2")])
def test_mpt_cli_refusals_worded_as_jax(tmp_path, flags):
    from haff_tpu.train import cli as jcli
    from haff_tpu_torch.train import cli as tcli

    argv = ["--dataset_dir", str(tmp_path), "--log_base_dir",
            str(tmp_path / "runs"), *FLAGS, *flags]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
