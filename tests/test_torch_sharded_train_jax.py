"""The port's train step on a mesh against JAX's sharded train step.

Both from the same tiny weights (LoRA rank 2, dropout 0) and the first
4-row global batch of tests/test_torch_sharded_train.py: the port's
step in 4 gloo ranks on the CPU, over data 2 x fsdp 2 and over tensor 2
x sp 2 (remat on); JAX's on its data=2, fsdp=2, tensor=2 mesh
(tests/test_trainer.py:145's setup). Loss terms and grad_norm of the
step within rtol 1e-4, the standing tolerance of
tests/test_torch_train.py. (A second JAX step recompiles for the updated
state's shardings, doubling the file's time; the port's later steps are
held against its one-process steps in tests/test_torch_sharded_train.py.)
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.config import TrainConfig as JaxTrainConfig
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.model.lisa import TrainBatch as JaxTrainBatch
from haff_tpu.parallel.sharding import param_shardings as jax_shardings
from haff_tpu.parallel.sharding import shard_batch_tree as jax_shard_batch
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import ModelConfig
from test_torch_sharded_train import (DP2_FSDP2, LOSSES, TKW, TP2_SP2,
                                      by_run, make_batch, spawn, weights)


def _jax_steps(jcfg, params, batches):
    model = JaxLisaModel(cfg=jcfg)
    mesh = jax_build_mesh(JaxMeshConfig(data=2, fsdp=2, tensor=2))
    tcfg = JaxTrainConfig(model=jcfg, **TKW)
    boxed = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                           JaxTrainBatch(*(jnp.asarray(x)
                                           for x in batches[0])))["params"]
    shardings = fnn.unbox(jax_shardings(mesh, boxed))
    placed = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, s),
                                    params, shardings)
    trainable, frozen = jtrainer.partition_params(placed)
    out = []
    with mesh:
        state = jtrainer.init_train_state(tcfg, trainable)
        step = jax.jit(jtrainer.make_train_step(model, tcfg))
        for b in batches:
            batch = jax_shard_batch(mesh, JaxTrainBatch(
                *(jnp.asarray(x) for x in b)))
            state, m = step(state, frozen, batch, jax.random.PRNGKey(0))
            out.append({k: float(m[k]) for k in LOSSES})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jcfg, params, sd = weights()
    batches = [tuple(make_batch(ModelConfig.preset("tiny"), 1))]
    off = dict(lora_rank=2, lora_dropout=0.0)
    runs = {"dp2_fsdp2": dict(llama=off, plan=[(DP2_FSDP2, [0])]),
            "tp2_sp2": dict(llama=off, plan=[(TP2_SP2, [0])])}
    # JAX's compile takes every core; the ranks start after it.
    ref = _jax_steps(jcfg, params, batches)
    ranks = spawn(runs, sd, batches, tmp_path_factory.mktemp("train_jax"))
    return by_run(runs, ranks.join()), ref


@pytest.mark.parametrize("run", ["dp2_fsdp2", "tp2_sp2"])
def test_mesh_step_equals_jax_sharded_step(results, run):
    got, ref = results
    for r, res in enumerate(got[run]):
        for k in LOSSES:
            np.testing.assert_allclose(res["metrics"][0][k], ref[0][k],
                                       rtol=1e-4, err_msg=f"rank {r} {k}")
