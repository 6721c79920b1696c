"""The int8 QLoRA base under tensor 2 x fsdp 2 against JAX's sharded
QLoRA step (int4: tests/test_torch_qlora4_mesh_jax.py, the MPT decoder:
tests/test_torch_mpt_mesh_jax.py, each its own file to stay near a
minute).

Both from the same tiny weights (LoRA rank 2, dropout 0) and the first
4-row global batch of tests/test_torch_sharded_train.py, the frozen
LLaMA projections quantized int8 (int4 at group 16): JAX's step over
`quantize_dense_tree(frozen, default_llm_predicate)` (the train CLI's
QLoRA, haff_tpu/train/cli.py:384-399) on its MeshConfig(tensor=2, fsdp=2)
mesh of the 8 virtual devices (data 2); the port's in 4 gloo ranks over
tensor 2 x fsdp 2 (remat on), its int8 / packed-int4 weights split with
their scales and its row-parallel W8A8 quantizing with the amax over the
tensor group. Loss terms and grad_norm within rtol 1e-4. The ranks run
while JAX compiles. (The same runs against the port's one-process steps,
with dropout: test_torch_qlora_mesh.py.)
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
from haff_tpu.nn import quant as jq
from haff_tpu.parallel.sharding import param_shardings as jax_shardings
from haff_tpu.parallel.sharding import shard_batch_tree as jax_shard_batch
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import ModelConfig
from test_torch_sharded_train import LOSSES, TKW, make_batch, weights
from torch_mesh_workers import Ranks

TP2_FSDP2 = (("tensor", 2), ("fsdp", 2))
GROUP = 16


def jax_mesh_step(jcfg, params, batch, bits=None):
    """JAX's train step (remat on) on MeshConfig(tensor=2, fsdp=2), the
    frozen partition quantized with `bits` as the CLI does: its metrics."""
    model = JaxLisaModel(cfg=jcfg)
    mesh = jax_build_mesh(JaxMeshConfig(tensor=2, fsdp=2))
    tcfg = JaxTrainConfig(model=jcfg, remat=True, **TKW)
    jb = JaxTrainBatch(*(jnp.asarray(x) for x in batch))
    boxed = jax.eval_shape(model.init, jax.random.PRNGKey(0), jb)["params"]
    placed = jax.tree_util.tree_map(
        jax.device_put, params, fnn.unbox(jax_shardings(mesh, boxed)))
    trainable, frozen = jtrainer.partition_params(placed)
    with mesh:
        if bits:
            frozen = jq.quantize_dense_tree(frozen, jq.default_llm_predicate,
                                            bits=bits, group=GROUP)
        state = jtrainer.init_train_state(tcfg, trainable)
        step = jax.jit(jtrainer.make_train_step(model, tcfg))
        _, m = step(state, frozen, jax_shard_batch(mesh, jb),
                    jax.random.PRNGKey(0))
    return {k: float(m[k]) for k in LOSSES}


def mesh_results(workdir, runs):
    """{name: (every rank's result, JAX's metrics)} for runs of name ->
    (run of `case_train` at dropout 0 under tensor 2 x fsdp 2: its
    "bits", "decoder"; the JAX config, parameters and port state dict)."""
    batches = [tuple(make_batch(ModelConfig.preset("tiny"), 1))]
    off = dict(lora_rank=2, lora_dropout=0.0)
    ranks = Ranks("train", dict(
        preset="tiny", batches=batches, seed=5, tcfg=dict(TKW, remat=True),
        runs=[dict(run, sd=sd, llama=off, plan=[(TP2_FSDP2, [0])])
              for run, (_, _, sd) in runs.values()]),
        4, workdir, timeout=420)
    refs = {name: jax_mesh_step(jcfg, params, batches[0], run.get("bits"))
            for name, (run, (jcfg, params, _)) in runs.items()}
    got = ranks.join()
    return {name: ([got[r][i] for r in range(4)], refs[name])
            for i, name in enumerate(runs)}


def assert_equals_jax(results, name):
    got, ref = results[name]
    for r, res in enumerate(got):
        for k in LOSSES:
            np.testing.assert_allclose(res["metrics"][0][k], ref[k],
                                       rtol=1e-4, err_msg=f"rank {r} {k}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mesh_results(tmp_path_factory.mktemp("qlora8_jax"),
                        {"int8": (dict(bits=8), weights())})


def test_sharded_qlora_step_equals_jax_sharded_qlora_step(results):
    assert_equals_jax(results, "int8")
