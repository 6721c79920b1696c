"""Sequence- and tensor-parallel LLaMA of the port (haff_tpu_torch/nn/llama.py
under parallel/sharding.py `param_shardings`, ring attention over the
ambient mesh's `sp` axis) against haff_tpu's single-device LLaMA.

The tiny preset with LoRA rank 2 on q/v, bridged float32 weights, L = 60
(padded to 64 inside the ring path) and rows of 55 and 40 tokens, as
tests/test_ring_attention.py's JAX check. The port runs in 4 gloo ranks
(one spawn): sp = 4 (remat on) and sp = 2 x tensor = 2. Logits of the
valid rows within 2e-4 of JAX's (JAX's own bound for its sp path,
tests/test_ring_attention.py:152-155); the gradients of
sum(logits * g * valid) for the input embeddings and every parameter
(tensor-parallel blocks gathered to the full layout) within 1e-4 of each
leaf's largest magnitude (plus 1e-6 absolute).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import LlamaConfig as JaxLlamaConfig
from haff_tpu.nn.llama import LlamaForCausalLM as JaxLlama
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like
from torch_mesh_workers import Ranks

MESHES = [(("sp", 4),), (("sp", 2), ("tensor", 2))]
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = dataclasses.replace(JaxLlamaConfig.preset("tiny"), lora_rank=2)
    b, l = 2, 60
    rng = np.random.RandomState(0)
    embeds = (rng.randn(b, l, cfg.hidden_size) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(l)[None], (b, l)).astype(np.int32)
    seg = (np.arange(l)[None] < np.array([[55], [40]])).astype(np.int32)
    g = (rng.randn(b, l, cfg.vocab_size) * seg[:, :, None]).astype(
        np.float32)
    jm = JaxLlama(cfg=cfg)
    shapes = fnn.unbox(jax.eval_shape(
        lambda k: jm.init(k, jnp.ones((1, 8), jnp.int32),
                          jnp.arange(8)[None], method="init_all"),
        jax.random.PRNGKey(0)))
    params = random_like(shapes["params"], 1)
    sd = {k: torch.tensor(np.array(v)) for k, v in
          flax_to_state_dict(params).items()}
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    payload = dict(cfg=fields, sd=sd, embeds=torch.tensor(embeds),
                   pos=torch.tensor(pos).long(), seg=torch.tensor(seg),
                   g=torch.tensor(g), meshes=MESHES, remat=True)
    ranks = Ranks("llama", payload, 4, tmp_path_factory.mktemp("llama"))

    def loss(p, e):
        logits, _, _ = jm.apply({"params": p}, e, jnp.asarray(pos),
                                jnp.asarray(seg))
        return jnp.sum(logits * jnp.asarray(g)), logits

    (_, logits), (dp, de) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(embeds))
    ref = dict(logits=np.asarray(logits), d_embeds=np.asarray(de),
               grads={k: np.array(v) for k, v in
                      flax_to_state_dict(dp).items()})
    return ref, ranks.join(), seg


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=[str(dict(m)) for m in MESHES])
def test_logits_match_single_device_jax(results, i):
    ref, got, seg = results
    valid = seg[:, :, None] != 0
    for r in range(4):
        logits = got[r][i]["logits"].numpy()
        np.testing.assert_allclose(logits * valid, ref["logits"] * valid,
                                   atol=LOGIT_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=[str(dict(m)) for m in MESHES])
def test_gradients_match_single_device_jax(results, i):
    ref, got, _ = results
    for r in range(4):
        res = got[r][i]
        want = ref["d_embeds"]
        err = np.abs(res["d_embeds"].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-6, ("d_embeds", r, err)
        assert set(res["grads"]) == set(ref["grads"])
        for name, want in ref["grads"].items():
            have = res["grads"][name]
            if have is None:  # off the path (the embedding table under
                assert not want.any(), name  # input embeddings): JAX zeros
                continue
            assert have.shape == want.shape, name
            err = np.abs(have.numpy() - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-6, (name, r, err)
        # the adapters and the vocab-parallel tables carry gradient
        for name in ("model.layers.1.self_attn.q_proj.lora_a",
                     "model.layers.0.self_attn.v_proj.lora_b",
                     "lm_head.weight", "model.layers.0.mlp.down_proj.weight"):
            assert np.abs(res["grads"][name].numpy()).max() > 0, name


def test_without_an_sp_mesh_the_ring_warns_and_runs_flash():
    """JAX's semantics: sequence_parallel with no ambient sp > 1 mesh warns
    and runs single-device flash attention."""
    from haff_tpu_torch.core.config import LlamaConfig
    from haff_tpu_torch.nn.llama import LlamaForCausalLM

    cfg = dataclasses.replace(LlamaConfig.preset("tiny"),
                              sequence_parallel=True)
    torch.manual_seed(0)
    sp = LlamaForCausalLM(cfg)
    plain = LlamaForCausalLM(dataclasses.replace(cfg,
                                                 sequence_parallel=False))
    plain.load_state_dict(sp.state_dict())
    e = torch.randn(1, 12, cfg.hidden_size) * 0.1
    pos = torch.arange(12)[None]
    with pytest.warns(UserWarning, match="no ambient mesh"):
        got = sp(e, pos)[0]
    assert torch.equal(got, plain(e, pos)[0])
