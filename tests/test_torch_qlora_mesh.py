"""Quantized (QLoRA) bases and the MPT decoder under tensor and fsdp
(parallel/sharding.py: int8 / packed-int4 weights split with their
scales; a row-parallel W8A8 quantizes its activations with the amax over
the tensor group; MPT stays replicated, as JAX declares no partitioning
for it), in 4 gloo ranks on the CPU (tests/torch_mesh_workers.py), against
the port's one-process steps.

* The row-parallel W8A8 product (`case_amax`, K = 64 over 4 ranks, rows
  whose largest values sit in one rank's slice): with the global amax,
  the int8 activations, their scales and the summed product equal the
  one-process W8A8's bit for bit but for the float sum's order (1e-6);
  each slice's own amax gives other int8 values (asserted), and one
  all-reduce a product ran.
* Two train steps of the tiny LISA (LoRA rank 2, dropout 0.3, remat) with
  its frozen LLaMA projections int8, and int4 at group 16, under tensor 2
  x fsdp 2; and the MPT decoder under tensor 2 x fsdp 2: every loss term
  within 1e-5 and grad_norm within 1e-4 relative of the one-process
  steps (QLoRA's straight-through backward held sharded).
"""

import dataclasses

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import ModelConfig, TrainConfig
from haff_tpu_torch.model.lisa import LisaModel, TrainBatch
from haff_tpu_torch.nn import quant
from haff_tpu_torch.train import trainer as T
from haff_tpu_torch.train.cli import frozen_predicate
from test_torch_sharded_train import make_batch
from torch_mesh_workers import Ranks, run_ranks

LLAMA = dict(lora_rank=2, lora_dropout=0.3)
SEED = 5
TKW = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_accumulation_steps=1)
LOSSES = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
          "taxonomy_ce_loss", "grad_norm")
TP2_FSDP2 = (("tensor", 2), ("fsdp", 2))
RUNS = {"int8": dict(bits=8), "int4": dict(bits=4), "mpt": dict(decoder="mpt")}


def _one_process(run, sd, batches):
    base = ModelConfig.preset("tiny")
    cfg = base.replace(decoder=run.get("decoder", "llama"),
                       llama=dataclasses.replace(base.llama, **LLAMA))
    model = LisaModel(cfg, torch.float32, device="cpu")
    model.load_state_dict(sd)
    trainable, frozen = T.partition_params(model)
    if run.get("bits"):
        quant.quantize_model_(model, frozen_predicate(
            set(frozen), quant.default_llm_predicate), bits=run["bits"],
            group=16)
    tcfg = TrainConfig(model=cfg, remat=True, **TKW)
    state = T.init_train_state(tcfg, trainable)
    step = T.make_train_step(model, tcfg)
    out = []
    for b in batches:
        state, m = step(state, TrainBatch(*b).to("cpu"), SEED)
        out.append({k: float(v) for k, v in m.items()})
    return out


def _sd(decoder):
    base = ModelConfig.preset("tiny")
    cfg = base.replace(decoder=decoder, llama=dataclasses.replace(
        base.llama, **LLAMA))
    model = LisaModel(cfg, torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(13))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    batches = [tuple(make_batch(ModelConfig.preset("tiny"), s))
               for s in (1, 2)]
    runs = []
    for extra in RUNS.values():
        sd = _sd(extra.get("decoder", "llama"))
        runs.append(dict(llama=LLAMA, plan=[(TP2_FSDP2, [0, 1])], sd=sd,
                         **extra))
    ranks = Ranks("train", dict(preset="tiny", batches=batches,
                                tcfg=dict(TKW, remat=True), seed=SEED,
                                runs=runs), 4,
                  tmp_path_factory.mktemp("qlora_mesh"), timeout=420)
    refs = {name: _one_process(run, run["sd"], batches)
            for name, run in zip(RUNS, runs)}
    got = ranks.join()
    return {name: [got[r][i] for r in range(4)]
            for i, name in enumerate(RUNS)}, refs


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_base_step_equals_one_process(results, run):
    got, refs = results
    want = refs[run]
    for r, res in enumerate(got[run]):
        for s in range(2):
            for k in LOSSES:
                tol = 1e-4 * want[s][k] if k == "grad_norm" else 1e-5
                assert abs(res["metrics"][s][k] - want[s][k]) <= tol, (
                    run, r, s, k, res["metrics"][s][k], want[s][k])


def test_row_parallel_w8a8_takes_the_global_amax(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 64).astype(np.float32)
    x[:, 40:48] *= 20.0          # the rows' largest values in rank 2's slice
    w = rng.randn(12, 64).astype(np.float32)
    q, scale = quant.quantize_kernel(torch.tensor(w))
    got = run_ranks("amax", dict(x=torch.tensor(x), q=q, scale=scale), 4,
                    tmp_path)
    xq = quant.quantize_activation(torch.tensor(x))
    want = quant.int8_matmul(torch.tensor(x), q, scale)
    for r, res in enumerate(got):
        assert res["reduces"] == 2, r   # the product and the direct call
        assert torch.equal(res["xq"], xq.values[:, r * 16:(r + 1) * 16]), r
        assert torch.equal(res["sx"], xq.scales), r
        torch.testing.assert_close(res["global_"], want, rtol=1e-6,
                                   atol=1e-6)
        if r != 2:  # a slice without the large values quantizes otherwise
            assert not torch.equal(res["own"],
                                   xq.values[:, r * 16:(r + 1) * 16]), r
    assert float((got[0]["local"] - want).abs().max()) > 1e-3
