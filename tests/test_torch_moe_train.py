"""MoE training in the port: the train step at the tiny preset with 4
experts, top-2, in every other layer and LoRA rank 2, against haff_tpu's
(`trainer._forward`, which adds moe_aux_weight * aux / n_moe to the loss)
on the same bridged float32 weights and batch, the trainable set
`extra=("moe",)` on both sides; then the train CLI with MoE flags.

* loss without the aux term, the aux sum, and the aux-weighted loss
  (rtol 1e-4), and every trainable gradient within 1e-3 of its leaf's
  largest magnitude, against JAX `value_and_grad`;
* the trainable set equal to JAX `partition_params(extra=("moe",))`, the
  experts and routers in it; the eval step's loss carrying the aux term;
* the port's whole train step: its loss metric equal to JAX's weighted
  loss, and moving with `moe_aux_weight`;
* `--moe_experts 2 --moe_top_k 1`: trains, validates, checkpoints the
  experts, and a Predictor rebuilds the MoE model from the checkpoint;
* `--ep 2` and `--pp 2 --moe_experts 2` still refused.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.core.config import TrainConfig as JaxTrainConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import ModelConfig, TrainConfig
from haff_tpu_torch.model.lisa import TrainBatch
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from haff_tpu_torch.train import trainer as ttrainer
from test_lisa_model import make_tiny_batch
from test_torch_bridge import port_model
from test_torch_moe_lisa import moe_params
from test_torch_train_cli import BASE, run_cli, saved, synth_data  # noqa: F401
from haff_tpu_torch.train.cli import main

MOE = dict(moe_num_experts=4, moe_top_k=2, moe_every=2, lora_rank=2,
           lora_dropout=0.0, moe_aux_weight=0.5)


def _port(params, **kw):
    return port_model(params, llama=dataclasses.replace(
        ModelConfig.preset("tiny").llama, **dict(MOE, **kw)))


def _batch(batch):
    return TrainBatch(*(np.array(x) for x in batch)).to("cpu")


@pytest.fixture(scope="module")
def jax_side():
    base = JaxModelConfig.preset("tiny")
    cfg = base.replace(llama=dataclasses.replace(base.llama, **MOE))
    model = JaxLisaModel(cfg=cfg)
    params = moe_params(cfg)
    batch = make_tiny_batch(cfg)
    trainable, frozen = jtrainer.partition_params(params, extra=("moe",))
    tcfg = JaxTrainConfig(model=cfg, grad_accumulation_steps=1)

    def loss_fn(t):
        p = jtrainer.merge_params(t, frozen)
        out, mut = model.apply({"params": p}, batch, mutable=("moe_aux",))
        aux = sum(jax.tree_util.tree_leaves(mut["moe_aux"]))
        total = jtrainer._forward(model, tcfg, None, p, batch, None,
                                  deterministic=True).loss
        return total, (out.loss, aux)

    (total, (plain, aux)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable)
    return params, batch, trainable, float(total), float(plain), float(aux), \
        grads


@pytest.fixture(scope="module")
def port_side(jax_side):
    params, batch = jax_side[:2]
    model = _port(params)
    trainable, _ = ttrainer.partition_params(model, extra=("moe",))
    out = model(_batch(batch))
    total = ttrainer.with_moe_aux(model, out)
    total.loss.backward()
    return model, trainable, out, total


def test_loss_and_aux_match(jax_side, port_side):
    _, _, _, total, plain, aux, _ = jax_side
    _, _, out, weighted = port_side
    np.testing.assert_allclose(float(out.loss.detach()), plain, rtol=1e-4)
    np.testing.assert_allclose(float(out.moe_aux.detach()), aux, rtol=1e-4)
    np.testing.assert_allclose(float(weighted.loss.detach()), total,
                               rtol=1e-4)
    # one MoE layer: loss + 0.5 * aux / 1
    assert abs(total - plain - 0.5 * aux) < 1e-4 * abs(total)


def test_trainable_set_matches_jax(jax_side, port_side):
    ref = set(flax_to_state_dict(jax_side[2]))
    assert set(port_side[1]) == ref
    for leaf in ("router.weight", "gate_proj", "up_proj", "down_proj"):
        assert f"llm.model.layers.1.moe.{leaf}" in ref


def test_gradients_match(jax_side, port_side):
    ref = flax_to_state_dict(jax_side[6])
    trainable = port_side[1]
    groups = set()
    for name, r in ref.items():
        g = trainable[name].grad
        r = r.numpy()
        if g is None:  # off the loss path (the IoU head): JAX gives zeros
            assert not r.any(), name
            continue
        scale = float(np.abs(r).max())
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-3 * scale + 1e-6, (name, err, scale)
        groups.add(name.split(".")[0] if "moe" not in name else "moe")
    assert "moe" in groups
    for leaf in ("router.weight", "gate_proj", "down_proj"):
        assert trainable[f"llm.model.layers.1.moe.{leaf}"].grad.abs().max() > 0


def test_train_and_eval_steps_carry_the_aux_term(jax_side):
    params, batch, _, total, plain = jax_side[:5]
    losses = {}
    for weight in (0.0, 0.5):
        model = _port(params, moe_aux_weight=weight)
        trainable, _ = ttrainer.partition_params(model, extra=("moe",))
        tcfg = TrainConfig(model=model.cfg, grad_accumulation_steps=1)
        ev = ttrainer.make_eval_step(model, tcfg)(_batch(batch))
        state = ttrainer.init_train_state(tcfg, trainable)
        _, metrics = ttrainer.make_train_step(model, tcfg)(
            state, _batch(batch), 0)
        losses[weight] = float(metrics["loss"])
        np.testing.assert_allclose(float(ev.loss), losses[weight], rtol=1e-5)
    np.testing.assert_allclose(losses[0.5], total, rtol=1e-4)
    np.testing.assert_allclose(losses[0.0], plain, rtol=1e-4)
    assert losses[0.5] != losses[0.0]


def test_train_cli_moe_micro_run(synth_data, tmp_path):  # noqa: F811
    from haff_tpu_torch.infer.predictor import Predictor

    run = run_cli(synth_data, tmp_path, "moe", "--epochs", "1",
                  "--steps_per_epoch", "2", "--moe_experts", "2",
                  "--moe_top_k", "1", "--precision", "fp32")
    assert [s["step"] for s in run.steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in run.steps)
    assert len(run.validations) == 1
    llama = run.model.cfg.llama
    assert (llama.moe_num_experts, llama.moe_top_k, llama.moe_every) == (
        2, 1, 1)
    snap = saved(tmp_path, "moe")
    moe = [n for n in snap["trainable"] if ".moe." in n]
    assert {n.rsplit(".moe.", 1)[1] for n in moe} == {
        "router.weight", "gate_proj", "up_proj", "down_proj"}
    assert len(moe) == 4 * llama.num_layers
    ckpt = str(tmp_path / "runs" / "moe" / "ckpt_model")
    pred = Predictor(model_preset="tiny", precision="fp32", max_new_tokens=4,
                     max_text_len=448, checkpoint=ckpt, device="cpu")
    got, want = pred.model.state_dict(), run.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("flags,match", [
    (("--ep", "2"), "--ep > 1 requires --moe_experts > 0"),
    (("--moe_experts", "2", "--ep", "2"),
     r"1 devices not divisible by pp\*fsdp\*ep\*sp\*tensor=2"),
    (("--pp", "2", "--moe_experts", "2"),
     "--pp cannot be combined with --moe_experts"),
])
def test_train_cli_moe_refusals(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        main(["--dataset_dir", str(tmp_path), "--log_base_dir",
              str(tmp_path / "runs"), *BASE, *flags])
    assert not (tmp_path / "runs").exists()
