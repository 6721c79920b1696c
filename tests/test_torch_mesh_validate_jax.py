"""Validation on a mesh against JAX's validation under `with mesh:`
(haff_tpu/train/cli.py:402-437, haff_tpu/infer/evaluate.py:169).

The same tiny float32 weights (JAX's seeded tree, its [SEG] column of
lm_head tripled so that decoding emits [SEG]) and the 2-frame benchmark
of tests/test_torch_validate.py (one frame with its GT on another canvas,
one with a hand missing), 6 new tokens: JAX's validate_on_benchmark with
its parameters placed on MeshConfig(data=4, tensor=2) and on
MeshConfig(data=4, pp=2) of the 8 virtual devices; the port's
(infer/evaluate.py `make_mesh_evaluate`) in 4 gloo ranks over data 2 x
tensor 2 and over pipe 2 x data 2, each stage keeping its own layers'
KV caches. On every rank: the same taxonomy per frame, and every frame's
IoU and IoCM and their means within 1e-4 (test_torch_validate.py's
tolerance). The ranks run while JAX compiles. (The port's mesh runs
against its one-process evaluate, tokens included:
test_torch_mesh_validate.py.)
"""

import flax.linen as fnn
import jax
import pytest
import torch

from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.data.aff_dataset import AffDatasetVal as JaxVal
from haff_tpu.data.tokenizer import ByteTokenizer as JaxTok
from haff_tpu.infer.evaluate import validate_on_benchmark as jax_validate
from haff_tpu.parallel.sharding import param_shardings as jax_shardings
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import init_batch, jax_tiny_params
from test_torch_validate import KW, bench  # noqa: F401 (a fixture)
from torch_mesh_workers import Ranks

NEW_TOKENS = 6
RUNS = {"data2_tensor2": ((("data", 2), ("tensor", 2)),
                          JaxMeshConfig(data=4, tensor=2)),
        "pp2_data2": ((("pp", 2), ("data", 2)), JaxMeshConfig(data=4, pp=2))}


@pytest.fixture(scope="module")
def results(bench, tmp_path_factory):  # noqa: F811
    jmodel, params = jax_tiny_params(seed=3)
    params["llm"]["lm_head"]["kernel"][:, jmodel.cfg.seg_token_idx] *= 3.0
    sd = {k: torch.as_tensor(v).clone()
          for k, v in flax_to_state_dict(params).items()}
    tok = JaxTok(model_max_length=448)
    ranks = Ranks("mesh_eval", dict(
        preset="tiny", runs=[dict(mesh=m, llama={}, sd=sd)
                             for m, _ in RUNS.values()],
        new_tokens=NEW_TOKENS, bench=bench), 4,
        tmp_path_factory.mktemp("mesh_eval_jax"), timeout=420)
    boxed = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                           init_batch(jmodel.cfg))["params"]
    refs = {}
    for name, (_, mcfg) in RUNS.items():
        mesh = jax_build_mesh(mcfg)
        placed = jax.tree_util.tree_map(
            jax.device_put, params, fnn.unbox(jax_shardings(mesh, boxed)))
        with mesh:
            refs[name] = jax_validate(
                jmodel, {"params": placed}, tok, JaxVal(bench),
                max_new_tokens=NEW_TOKENS, **KW)
    got = ranks.join()
    return {name: [got[r][i]["validate"] for r in range(4)]
            for i, name in enumerate(RUNS)}, refs


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_validation_equals_jax_validation_under_mesh(results, run):
    got, refs = results
    iou, iocm, frames = refs[run]
    assert len(frames) == 2
    for r, (g_iou, g_iocm, g_frames) in enumerate(got[run]):
        assert len(g_frames) == len(frames), r
        for a, b in zip(g_frames, frames):
            assert a["tax"] == b["tax"], r
            assert abs(a["iou"] - b["iou"]) <= 1e-4, (r, a, b)
            assert abs(a["iocm"] - b["iocm"]) <= 1e-4, (r, a, b)
        assert abs(g_iou - iou) <= 1e-4 and abs(g_iocm - iocm) <= 1e-4, r
