"""GPipe of the port (haff_tpu_torch/parallel/pipeline.py) against
haff_tpu/parallel/pipeline.py: the pure helpers, and the pipelined LLaMA
decoder's forward and gradients on gloo ranks on the CPU.

A 4-layer LLaMA (hidden 32, LoRA rank 2 on q/v, float32, bridged seeded
weights), batch 4 x 16 with one right-padded row, 2 microbatches. JAX runs
`pipelined_llm_forward` on the virtual 8-device mesh: the forward on
MeshConfig(data=2, pp=4), the gradients of mean(logits^2) on
MeshConfig(data=1, pp=2, tensor=2, fsdp=2) (tests/test_pipeline_parallel.py
:85, :101). The port runs in 4 gloo ranks (one spawn) on pipe 4, pipe 2 x
data 2 and pipe 2 x tensor 2: logits and hidden within 1e-4 of JAX's;
every gradient (the embeddings', each stage's layers', the replicated
tables') within 1e-4 of its leaf's largest magnitude (+1e-6).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import LlamaConfig as JaxLlamaConfig
from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.nn.llama import LlamaForCausalLM as JaxLlama
from haff_tpu.parallel import pipeline as JP
from haff_tpu_torch.parallel import pipeline as P
from haff_tpu_torch.parallel.sharding import PipeStage
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like
from torch_mesh_workers import Ranks

MESHES = [(("pp", 4),), (("pp", 2), ("data", 2)), (("pp", 2), ("tensor", 2))]
IDS = ["pp4", "pp2_data2", "pp2_tensor2"]
TOL = 1e-4


def _cfg():
    return JaxLlamaConfig(vocab_size=128, hidden_size=32,
                          intermediate_size=64, num_layers=4, num_heads=4,
                          num_kv_heads=4, head_dim=8, max_seq_len=64,
                          lora_rank=2)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = _cfg()
    b, l = 4, 16
    rng = np.random.RandomState(0)
    embeds = (rng.randn(b, l, cfg.hidden_size) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(l)[None], (b, l)).astype(np.int32)
    seg = np.ones((b, l), np.int32)
    seg[2, 11:] = 0
    jm = JaxLlama(cfg=cfg)
    shapes = fnn.unbox(jax.eval_shape(
        lambda k: jm.init(k, jnp.ones((1, 8), jnp.int32),
                          jnp.arange(8)[None], method="init_all"),
        jax.random.PRNGKey(0)))
    params = random_like(shapes["params"], 2)
    sd = {k: torch.tensor(np.array(v)) for k, v in
          flax_to_state_dict(params).items()}
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    payload = dict(kind="llama", cfg=fields, sd=sd,
                   embeds=torch.tensor(embeds), pos=torch.tensor(pos).long(),
                   seg=torch.tensor(seg), meshes=MESHES, grad=True,
                   microbatches=2)
    ranks = Ranks("gpipe", payload, 4, tmp_path_factory.mktemp("gpipe"))

    e, p_, s_ = (jnp.asarray(a) for a in (embeds, pos, seg))
    mesh = jax_build_mesh(JaxMeshConfig(data=2, pp=4))
    with mesh:
        logits, hidden = jax.jit(lambda p, x: JP.pipelined_llm_forward(
            cfg, p, x, p_, s_, mesh=mesh, num_microbatches=2))(params, e)
    gmesh = jax_build_mesh(JaxMeshConfig(data=1, pp=2, tensor=2, fsdp=2))

    def loss(p, x):
        lg, _ = JP.pipelined_llm_forward(cfg, p, x, p_, s_, mesh=gmesh,
                                         num_microbatches=2)
        return jnp.mean(lg.astype(jnp.float32) ** 2)

    with gmesh:
        dp, de = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, e)
    ref = dict(logits=np.asarray(logits), hidden=np.asarray(hidden),
               d_embeds=np.asarray(de),
               grads={k: np.array(v) for k, v in
                      flax_to_state_dict(dp).items()})
    return ref, ranks.join()


@pytest.mark.parametrize("case", [
    "stack_llama", "stack_mpt", "unstack", "auto_24_4", "auto_6_4",
    "auto_9_4", "auto_7_4", "auto_1_4", "auto_16_4_s4", "auto_24_4_s2",
    "auto_9_4_s2"])
def test_pipeline_helpers_equal_jax(case):
    """stack_layer_params / unstack_layer_params over the port's per-layer
    state_dict names against JAX's over its layers_i / blocks_i scopes,
    and auto_microbatches, equal to JAX's."""
    if case.startswith("auto_"):
        nums = [int(t.lstrip("s")) for t in case.split("_")[1:]]
        args = nums[:2] + ([nums[2]] if len(nums) > 2 else [])
        assert P.auto_microbatches(*args) == JP.auto_microbatches(*args)
        return
    prefix = "blocks_" if case == "stack_mpt" else "layers_"
    rng = np.random.RandomState(3)
    tree = {f"{prefix}{i}": {"attn": {"w": rng.randn(2, 3).astype("f4")},
                             "b": rng.randn(3).astype("f4")}
            for i in range(4)}
    flat = {f"{prefix[:-1]}.{i}.attn.w": torch.tensor(t["attn"]["w"])
            for i, t in enumerate(tree.values())}
    flat.update({f"{prefix[:-1]}.{i}.b": torch.tensor(t["b"])
                 for i, t in enumerate(tree.values())})
    flat["norm.weight"] = torch.ones(3)  # not a layer: ignored
    want = JP.stack_layer_params(tree, 4, prefix=prefix)
    got = P.stack_layer_params(flat, 4, prefix=prefix)
    np.testing.assert_array_equal(got["attn.w"].numpy(),
                                  np.asarray(want["attn"]["w"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    if case == "unstack":
        back = P.unstack_layer_params(got, 4, prefix=prefix)
        jback = JP.unstack_layer_params(want, 4, prefix=prefix)
        for i in range(4):
            np.testing.assert_array_equal(
                back[f"layers.{i}.attn.w"].numpy(),
                np.asarray(jback[f"layers_{i}"]["attn"]["w"]))
        assert set(back) == {k for k in flat if k != "norm.weight"}


@pytest.mark.parametrize("i", range(len(MESHES)), ids=IDS)
def test_pipelined_llm_forward_matches_jax(results, i):
    ref, got = results
    for r in range(4):
        res = got[r][i]
        for k in ("logits", "hidden"):
            np.testing.assert_allclose(res[k].numpy(), ref[k], atol=TOL,
                                       err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("i", range(len(MESHES)), ids=IDS)
def test_pipelined_llm_gradients_match_jax(results, i):
    """Each stage-local layer's gradient on its own stage only, the
    replicated tables' on every pipe rank, all equal to JAX's."""
    ref, got = results
    seen = set()
    for r in range(4):
        res = got[r][i]
        lo, hi = res["stage"]
        want = ref["d_embeds"]
        err = np.abs(res["d_embeds"].numpy() - want).max()
        assert err <= TOL * np.abs(want).max() + 1e-6, ("d_embeds", r, err)
        for name, have in res["grads"].items():
            if name.startswith("model.layers."):
                layer = int(name.split(".")[2])
                assert lo <= layer < hi, (name, r)
            want = ref["grads"][name]
            if have is None:
                assert not want.any(), name
                continue
            err = np.abs(have.numpy() - want).max()
            assert err <= TOL * np.abs(want).max() + 1e-6, (name, r, err)
            seen.add(name)
    assert seen == {k for k, v in ref["grads"].items() if v.any()}


def test_pipeline_errors_are_jax_word_for_word():
    """pipeline_blocks' divisibility errors and the sequence-parallel
    refusal carry JAX's messages."""
    cfg = _cfg()
    x = jnp.zeros((4, 16, cfg.hidden_size))
    pos = jnp.zeros((4, 16), jnp.int32)
    params = {"model": {f"layers_{i}": {"w": jnp.zeros(2)}
                        for i in range(4)}}
    got, want = [], []
    for stages, nm in ((8, 2), (4, 3)):
        mesh = jax_build_mesh(JaxMeshConfig(data=8 // stages, pp=stages))
        with pytest.raises(ValueError) as e:
            JP.pipeline_blocks(lambda p, x, *a, rng=None: x,
                               {"w": jnp.zeros((4, 2))}, (x,), mesh=mesh,
                               num_microbatches=nm)
        want.append(str(e.value))
        stage = PipeStage(0, stages, 0, 4 // stages, 4, None, (0,))
        with pytest.raises(ValueError) as e:
            P.pipeline_blocks(lambda i, x: x, stage, (torch.zeros(4, 16, 2),),
                              num_microbatches=nm)
        got.append(str(e.value))
    assert got == want
    mesh = jax_build_mesh(JaxMeshConfig(data=2, pp=4))
    with pytest.raises(ValueError) as e:
        JP.pipelined_llm_forward(
            dataclasses.replace(cfg, sequence_parallel=True), params, x, pos,
            None, mesh=mesh, num_microbatches=2)
    assert P.PIPE_SP == str(e.value)
