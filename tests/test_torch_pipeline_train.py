"""The port's LISA train step under a pipe axis (train/trainer.py routing
the decoder through parallel/pipeline.py, as JAX's `_forward` does) at the
tiny preset with 4 decoder layers, LoRA rank 2 with dropout 0.3, float32,
remat, in 4 gloo ranks on the CPU (one spawn, tests/torch_mesh_workers.py
`case_train`), against the port's one-process steps.

* pipe 2 x data 2 and pipe 4: two steps; every loss term within 1e-5,
  grad_norm within 1e-4 relative, each rank's completed gradients (its
  stage's layers, the replicated rest) within 1e-4 of the leaf's largest
  magnitude (+1e-6): the dropout masks are the one-process masks, and the
  replicated gradients are counted once, not once a pipe rank.
* Checkpoints keep the one-process layout: one written under pipe 2 x
  tensor 2 after step 1 resumes under data 4 (no pipe), and one written
  under pipe 2 x fsdp 2 resumes under pipe 4, each continuing the
  one-process losses; the file holds the one-process names in their
  order, with AdamW's moments on the same indices.
"""

import dataclasses

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import ModelConfig, TrainConfig
from haff_tpu_torch.model.lisa import LisaModel, TrainBatch
from haff_tpu_torch.train import checkpoints as CK
from haff_tpu_torch.train import trainer as T
from test_torch_sharded_train import make_batch
from torch_mesh_workers import Ranks

LLAMA = dict(lora_rank=2, lora_dropout=0.3, num_layers=4)
SEED = 5
TKW = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_accumulation_steps=1)
LOSSES = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
          "taxonomy_ce_loss", "grad_norm")
RUNS = {
    "pp2_data2": [((("pp", 2), ("data", 2)), [0, 1])],
    "pp4": [((("pp", 4),), [0, 1])],
    "pp2_tensor2_to_data4": [((("pp", 2), ("tensor", 2)), [0]),
                             ((("data", 4),), [1])],
    "pp2_fsdp2_to_pp4": [((("pp", 2), ("fsdp", 2)), [0]),
                         ((("pp", 4),), [1])],
}


def _model():
    base = ModelConfig.preset("tiny")
    cfg = base.replace(llama=dataclasses.replace(base.llama, **LLAMA))
    model = LisaModel(cfg, torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(11))
    return cfg, model


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg, model = _model()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [tuple(make_batch(ModelConfig.preset("tiny"), s))
               for s in (1, 2)]
    runs = [dict(llama=LLAMA, plan=plan) for plan in RUNS.values()]
    work = tmp_path_factory.mktemp("pp_train")
    ranks = Ranks("train", dict(preset="tiny", sd=sd, batches=batches,
                                tcfg=dict(TKW, remat=True), seed=SEED,
                                runs=runs), 4, work, timeout=420)
    trainable, _ = T.partition_params(model)
    tcfg = TrainConfig(model=cfg, remat=True, **TKW)
    state = T.init_train_state(tcfg, trainable)
    step = T.make_train_step(model, tcfg)
    update, grads, metrics = state.optimizer.update, [], []

    def record(g, norm=None):
        grads.append({n: torch.zeros_like(p) if t is None else
                      t.detach().clone()
                      for (n, p), t in zip(state.trainable.items(), g)})
        return update(g, norm)

    state.optimizer.update = record
    for i, b in enumerate(batches):
        state, m = step(state, TrainBatch(*b).to("cpu"), SEED)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            CK.save_checkpoint(str(work / "one"), 1, state)
    got = ranks.join()
    return ({name: [got[r][i] for r in range(4)]
             for i, name in enumerate(RUNS)}, metrics, grads, work)


@pytest.mark.parametrize("run", ["pp2_data2", "pp4"])
def test_pipelined_step_equals_one_process_step(results, run):
    got, metrics, grads, _ = results
    for r, res in enumerate(got[run]):
        for s in range(2):
            for k in LOSSES:
                tol = 1e-4 * metrics[s][k] if k == "grad_norm" else 1e-5
                assert abs(res["metrics"][s][k] - metrics[s][k]) <= tol, (
                    r, s, k, res["metrics"][s][k], metrics[s][k])
            for name, have in res["grads"][s].items():
                want = grads[s][name]
                err = float((have - want).abs().max())
                assert err <= 1e-4 * float(want.abs().max()) + 1e-6, (
                    r, s, name, err)
        # a rank holds its stage's adapters only
        layers = {int(n.split(".")[3]) for n in res["trainable"]
                  if n.startswith("llm.model.layers.")}
        assert len(layers) == 4 // (4 if run == "pp4" else 2), layers


@pytest.mark.parametrize("run", ["pp2_tensor2_to_data4", "pp2_fsdp2_to_pp4"])
def test_pipeline_checkpoint_resumes_at_another_pipe(results, run):
    got, metrics, _, _ = results
    for r, res in enumerate(got[run]):
        for s in range(2):
            assert abs(res["metrics"][s]["loss"] - metrics[s]["loss"]) \
                <= 1e-5, (r, s)


def test_pipeline_checkpoint_has_the_one_process_layout(results):
    got, _, _, work = results
    one = torch.load(work / "one" / "1" / CK.STATE, weights_only=True)
    for run in ("pp2_tensor2_to_data4", "pp2_fsdp2_to_pp4"):
        ckpt = got[run][0]["ckpt"]
        snap = torch.load(f"{ckpt}/1/{CK.STATE}", weights_only=True)
        assert list(snap["trainable"]) == list(one["trainable"])
        want, have = one["optimizer"]["adamw"], snap["optimizer"]["adamw"]
        assert set(have["state"]) == set(want["state"])
        for i, n in enumerate(one["trainable"]):
            m = want["state"][i]["exp_avg"]
            np.testing.assert_allclose(have["state"][i]["exp_avg"].numpy(),
                                       m.numpy(), atol=1e-7, err_msg=n)
            # AdamW's first step moves each element by the learning rate
            # times the sign of its gradient: compare where the gradient
            # is above rounding noise (not at all in leaves whose exact
            # gradient is 0, such as the key biases under softmax).
            if float(m.abs().max()) < 1e-6:
                continue
            sel = m.abs() > 1e-4 * m.abs().max()
            assert torch.allclose(snap["trainable"][n][sel],
                                  one["trainable"][n][sel], atol=1e-6), n
        assert have["param_groups"][0]["params"] == \
            want["param_groups"][0]["params"]
