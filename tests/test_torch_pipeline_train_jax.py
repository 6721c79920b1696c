"""The port's pipelined LISA train step against JAX's (haff_tpu/train/
trainer.py `_forward` routing through pipelined_lisa_forward).

Both from the same tiny weights (LoRA rank 2, dropout 0: JAX's pipeline
folds the stage and tick into its dropout keys, the port keeps the
one-process masks) and the first 4-row global batch of
tests/test_torch_sharded_train.py, 2 microbatches: JAX's step on its
MeshConfig(data=4, pp=2) mesh; the port's in 4 gloo ranks over pipe 2 x
data 2 and pipe 2 x tensor 2 (remat on). Loss terms and grad_norm within
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.config import TrainConfig as JaxTrainConfig
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.model.lisa import TrainBatch as JaxTrainBatch
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import ModelConfig
from test_torch_sharded_train import LOSSES, TKW, make_batch, weights
from torch_mesh_workers import Ranks

RUNS = {"pp2_data2": (("pp", 2), ("data", 2)),
        "pp2_tensor2": (("pp", 2), ("tensor", 2))}


def _jax_step(jcfg, params, batch):
    model = JaxLisaModel(cfg=jcfg)
    mesh = jax_build_mesh(JaxMeshConfig(data=4, pp=2))
    tcfg = JaxTrainConfig(model=jcfg, pp_microbatches=2, **TKW)
    trainable, frozen = jtrainer.partition_params(params)
    with mesh:
        state = jtrainer.init_train_state(tcfg, trainable)
        step = jax.jit(jtrainer.make_train_step(model, tcfg, mesh=mesh))
        _, m = step(state, frozen, JaxTrainBatch(
            *(jnp.asarray(x) for x in batch)), jax.random.PRNGKey(0))
    return {k: float(m[k]) for k in LOSSES}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jcfg, params, sd = weights()
    batches = [tuple(make_batch(ModelConfig.preset("tiny"), 1))]
    off = dict(lora_rank=2, lora_dropout=0.0)
    ref = _jax_step(jcfg, params, batches[0])
    ranks = Ranks("train", dict(
        preset="tiny", sd=sd, batches=batches, seed=5,
        tcfg=dict(TKW, remat=True, pp_microbatches=2),
        runs=[dict(llama=off, plan=[(m, [0])]) for m in RUNS.values()]),
        4, tmp_path_factory.mktemp("pp_jax"), timeout=420)
    got = ranks.join()
    return {name: [got[r][i] for r in range(4)]
            for i, name in enumerate(RUNS)}, ref


@pytest.mark.parametrize("run", list(RUNS))
def test_pipelined_step_equals_jax_pipelined_step(results, run):
    got, ref = results
    for r, res in enumerate(got[run]):
        for k in LOSSES:
            np.testing.assert_allclose(res["metrics"][0][k], ref[k],
                                       rtol=1e-4, err_msg=f"rank {r} {k}")
