"""The MPT decoder under tensor 2 x fsdp 2 against JAX's sharded step.

JAX declares no partitioning for MPT, so its weights stay replicated on
MeshConfig(tensor=2, fsdp=2) and only the batch shards (data 2 x fsdp 2
of the 8 virtual devices); the port keeps them replicated too and splits
the rows over (data, fsdp) in 4 gloo ranks. Both from the same tiny MPT
weights (LoRA rank 2, dropout 0) and the first 4-row global batch of
tests/test_torch_sharded_train.py, remat on: loss terms and grad_norm
within rtol 1e-4 (tests/test_torch_qlora_mesh_jax.py's comparison)."""

import dataclasses

import numpy as np
import pytest
import torch

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import jax_param_shapes, random_like
from test_torch_qlora_mesh_jax import assert_equals_jax, mesh_results


def mpt_weights(seed=3):
    base = JaxModelConfig.preset("tiny")
    jcfg = base.replace(decoder="mpt", llama=dataclasses.replace(
        base.llama, lora_rank=2, lora_dropout=0.0))
    params = random_like(jax_param_shapes(JaxLisaModel(cfg=jcfg), jcfg), seed)
    sd = {k: torch.tensor(np.array(v)) for k, v in
          flax_to_state_dict(params).items()}
    return jcfg, params, sd


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mesh_results(tmp_path_factory.mktemp("mpt_jax"),
                        {"mpt": (dict(decoder="mpt"), mpt_weights())})


def test_mpt_mesh_step_equals_jax_sharded_step(results):
    assert_equals_jax(results, "mpt")
