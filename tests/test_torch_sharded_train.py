"""The port's train step on a mesh (train/trainer.py `make_train_step(...,
mesh=)`, the LLaMA sharded by parallel/sharding.py) at the tiny preset
with LoRA rank 2, float32, remat on, in 4 gloo ranks on the CPU (one
spawn, tests/torch_mesh_workers.py `case_train`); the comparison with
JAX's sharded step is tests/test_torch_sharded_train_jax.py.

The global batch has 4 rows with unequal valid tokens (labels ignored over
6, 12, 6 and 18 leading tokens, two rows right-padded) and unequal masks
(sample weights 1, 1, 0, 1), so a mean of per-rank means would differ
from the global loss.

* data 2 x fsdp 2 and tensor 2 x sp 2, LoRA dropout 0.3: two steps
  against the port's one-process steps; every loss term within 1e-5,
  grad_norm within 1e-4 relative, every completed gradient within 1e-4 of
  its leaf's largest magnitude (+1e-6 absolute: leaves whose exact
  gradient is 0); every replica ends with the same parameters.
* A checkpoint written under data 2 x fsdp 2 after step 1 and resumed
  under tensor 2 x sp 2 for step 2 continues the one-process losses
  (within 1e-5) and ends at its trainable tensors.
* The mesh eval step afterwards: the global losses and every row's
  predictions, as the one-process eval step gives them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu_torch.core.config import (IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                        ModelConfig, TrainConfig)
from haff_tpu_torch.model.lisa import LisaModel, TrainBatch
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from haff_tpu_torch.train import trainer as T
from test_torch_bridge import jax_param_shapes, random_like
from torch_mesh_workers import Ranks

DP2_FSDP2 = (("data", 2), ("fsdp", 2))
TP2_SP2 = (("sp", 2), ("tensor", 2))
DROPOUT = 0.3
SEED = 5
TKW = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_accumulation_steps=1)
LOSSES = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
          "taxonomy_ce_loss", "grad_norm")


def make_batch(cfg, seed, seq=24):
    rng = np.random.RandomState(seed)
    S, C, b = cfg.sam_encoder.image_size, cfg.clip.image_size, 4
    ids = rng.randint(5, cfg.llama.vocab_size - 10, (b, seq)).astype(np.int32)
    ids[:, 0] = 1
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids[:, 10] = cfg.seg_token_idx
    labels = ids.copy()
    for i, n in enumerate((6, 12, 6, 18)):
        labels[i, :n] = IGNORE_INDEX
    attn = np.ones((b, seq), np.int32)
    attn[1, -9:] = 0
    attn[3, -3:] = 0
    return TrainBatch(
        images_sam=rng.randn(b, S, S, 3).astype(np.float32),
        images_clip=rng.randn(b, C, C, 3).astype(np.float32),
        image_index=np.arange(b, dtype=np.int32), input_ids=ids,
        labels=labels, attention_mask=attn,
        masks_left=(rng.rand(b, S, S) > 0.8).astype(np.float32),
        masks_right=(rng.rand(b, S, S) > 0.8).astype(np.float32),
        taxonomies=np.eye(4, dtype=np.float32),
        valid_region=np.ones((b, S, S), np.float32),
        sample_weight=np.array([1, 1, 0, 1], np.float32))


def _port_model(sd, dropout):
    base = ModelConfig.preset("tiny")
    cfg = base.replace(llama=dataclasses.replace(
        base.llama, lora_rank=2, lora_dropout=dropout))
    model = LisaModel(cfg, torch.float32, device="cpu")
    model.load_state_dict(sd)
    return cfg, model


def _one_process(sd, batches, dropout):
    """The port's one-process steps: metrics and gradients of each."""
    cfg, model = _port_model(sd, dropout)
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
    for b in batches:
        state, m = step(state, TrainBatch(*b).to("cpu"), SEED)
        metrics.append({k: float(v) for k, v in m.items()})
    evaluated = T.make_eval_step(model, tcfg)(TrainBatch(*batches[0]).to(
        "cpu"))
    return metrics, grads, {n: p.detach().clone()
                            for n, p in state.trainable.items()}, evaluated


def weights(seed=3):
    """(JAX tiny config with LoRA rank 2 at dropout 0, its seeded
    parameters, the same as the port's state_dict)."""
    base = JaxModelConfig.preset("tiny")
    jcfg = base.replace(llama=dataclasses.replace(base.llama, lora_rank=2,
                                                  lora_dropout=0.0))
    params = random_like(jax_param_shapes(JaxLisaModel(cfg=jcfg), jcfg), seed)
    sd = {k: torch.tensor(np.array(v)) for k, v in
          flax_to_state_dict(params).items()}
    return jcfg, params, sd


def spawn(runs, sd, batches, workdir):
    """Ranks running `runs` (name -> run of `case_train`)."""
    return Ranks("train", dict(preset="tiny", sd=sd, batches=batches,
                               tcfg=dict(TKW, remat=True), seed=SEED,
                               runs=list(runs.values())), 4, workdir,
                 timeout=240)


def by_run(runs, got):
    return {name: [got[r][i] for r in range(4)]
            for i, name in enumerate(runs)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    _, _, sd = weights()
    batches = [tuple(make_batch(ModelConfig.preset("tiny"), s))
               for s in (1, 2)]
    on = dict(lora_rank=2, lora_dropout=DROPOUT)
    runs = {
        "dp2_fsdp2": dict(llama=on, plan=[(DP2_FSDP2, [0, 1])]),
        "tp2_sp2": dict(llama=on, plan=[(TP2_SP2, [0, 1])]),
        "resume": dict(llama=on, plan=[(DP2_FSDP2, [0]), (TP2_SP2, [1])]),
    }
    ranks = spawn(runs, sd, batches, tmp_path_factory.mktemp("train"))
    ref = {"on": _one_process(sd, batches, DROPOUT)}
    return by_run(runs, ranks.join()), ref


def _close_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * scale + 1e-6, (name, err, scale)


@pytest.mark.parametrize("run", ["dp2_fsdp2", "tp2_sp2"])
def test_mesh_step_equals_one_process_step_with_dropout(results, run):
    got, ref = results
    metrics, grads, _, _ = ref["on"]
    for r, res in enumerate(got[run]):
        for s in range(2):
            for k in LOSSES:  # grad_norm: the gradients' 1e-4 relative
                tol = 1e-4 * metrics[s][k] if k == "grad_norm" else 1e-5
                assert abs(res["metrics"][s][k] - metrics[s][k]) <= tol, (
                    r, s, k, res["metrics"][s][k], metrics[s][k])
            _close_grads(res["grads"][s], grads[s])
    # every replica holds the same parameters after the steps
    for res in got[run][1:]:
        for n, t in res["trainable"].items():
            assert torch.equal(t, got[run][0]["trainable"][n]), n


def test_checkpoint_resumes_under_another_mesh(results):
    got, ref = results
    metrics, _, trained, _ = ref["on"]
    for r, res in enumerate(got["resume"]):
        for s in range(2):
            assert abs(res["metrics"][s]["loss"] - metrics[s]["loss"]) \
                <= 1e-5, (r, s)
        for n, w in trained.items():
            # Leaves whose exact gradient is 0 (key biases under softmax)
            # move by AdamW's normalised rounding noise; the rest must agree.
            if min(float(g[n].abs().max()) for g in ref["on"][1]) < 1e-6:
                continue
            err = float((res["trainable"][n] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + 1e-5, (n, err)


@pytest.mark.parametrize("run", ["dp2_fsdp2", "tp2_sp2"])
def test_mesh_eval_step_equals_one_process(results, run):
    """make_eval_step(mesh=) after the two steps: the global losses (within
    1e-5) and every row's predictions, gathered from the batch shards
    (within 1e-4 of the largest magnitude)."""
    got, ref = results
    want = ref["on"][3]
    for r, res in enumerate(got[run]):
        for k, have in res["eval"].items():
            w = getattr(want, k).detach()
            assert have.shape == w.shape, (r, k)
            tol = 1e-5 if w.ndim == 0 else 1e-4 * float(w.abs().max())
            assert float((have - w).abs().max()) <= tol, (r, k)
