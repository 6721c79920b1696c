"""The pipelined MPT decoder of the port (parallel/pipeline.py
`pipelined_mpt_forward`: ALiBi as the flash kernel's bias in each stage,
the tied head) against haff_tpu's on the virtual 8-device mesh
(MeshConfig(data=4, pp=2), tests/test_pipeline_parallel.py:160).

MPT at the tiny widths with 4 blocks, bridged seeded float32 weights,
batch 4 x 16 with one right-padded row, 2 microbatches; the port in 4
gloo ranks on pipe 4 and pipe 2 x data 2: logits and hidden within 1e-4
of JAX's on every rank, and the gradients of mean(logits^2), the input
embeddings' and every parameter's (each block's on its own stage only,
the tied embedding and final norm on every pipe rank), within 1e-4 of
the largest magnitude of JAX's single-device one.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.nn.mpt import MptConfig as JaxMptConfig
from haff_tpu.nn.mpt import MptForCausalLM as JaxMpt
from haff_tpu.parallel import pipeline as JP
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like
from torch_mesh_workers import Ranks

MESHES = [(("pp", 4),), (("pp", 2), ("data", 2))]
TOL = 1e-4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = dataclasses.replace(JaxMptConfig.preset("tiny"), n_layers=4)
    b, l = 4, 16
    rng = np.random.RandomState(1)
    embeds = (rng.randn(b, l, cfg.d_model) * 0.5).astype(np.float32)
    seg = np.ones((b, l), np.int32)
    seg[1, 9:] = 0
    jm = JaxMpt(cfg=cfg)
    shapes = fnn.unbox(jax.eval_shape(
        lambda k: jm.init(k, jnp.ones((1, 8), jnp.int32), method="init_all"),
        jax.random.PRNGKey(0)))
    params = random_like(shapes["params"], 4)
    sd = {k: torch.tensor(np.array(v)) for k, v in
          flax_to_state_dict(params).items()}
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    ranks = Ranks("gpipe", dict(kind="mpt", cfg=fields, sd=sd,
                                embeds=torch.tensor(embeds),
                                seg=torch.tensor(seg), meshes=MESHES,
                                grad=True, microbatches=2),
                  4, tmp_path_factory.mktemp("gpipe_mpt"))
    e, s_ = jnp.asarray(embeds), jnp.asarray(seg)
    mesh = jax_build_mesh(JaxMeshConfig(data=4, pp=2))
    with mesh:
        logits, hidden = jax.jit(lambda p, x: JP.pipelined_mpt_forward(
            cfg, p, x, s_, mesh=mesh, num_microbatches=2))(params, e)

    def loss(p, x):
        lg, _, _ = jm.apply({"params": p}, x, segment_ids=s_)
        return jnp.mean(lg.astype(jnp.float32) ** 2)

    dp, de = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, e)
    grads = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, dp)).items()}
    return dict(logits=np.asarray(logits), hidden=np.asarray(hidden),
                d_embeds=np.asarray(de), grads=grads), ranks.join()


@pytest.mark.parametrize("i", range(len(MESHES)), ids=["pp4", "pp2_data2"])
def test_pipelined_mpt_forward_matches_jax(results, i):
    ref, got = results
    for r in range(4):
        res = got[r][i]
        for k in ("logits", "hidden"):
            np.testing.assert_allclose(res[k].numpy(), ref[k], atol=TOL,
                                       err_msg=f"{k} rank {r}")
        err = np.abs(res["d_embeds"].numpy() - ref["d_embeds"]).max()
        assert err <= TOL * np.abs(ref["d_embeds"]).max() + 1e-6, (r, err)


@pytest.mark.parametrize("i", range(len(MESHES)), ids=["pp4", "pp2_data2"])
def test_pipelined_mpt_gradients_match_jax(results, i):
    ref, got = results
    seen = set()
    for r in range(4):
        res = got[r][i]
        lo, hi = res["stage"]
        for name, have in res["grads"].items():
            if name.startswith("blocks."):
                assert lo <= int(name.split(".")[1]) < hi, (name, r)
            want = ref["grads"][name]
            err = np.abs(have.numpy() - want).max()
            assert err <= TOL * np.abs(want).max() + 1e-6, (name, r, err)
            seen.add(name)
    assert seen == set(ref["grads"])
