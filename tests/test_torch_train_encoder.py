"""Training with the SAM image encoder unfrozen
(`partition_params(extra=("image_encoder",))`) at the tiny preset against
haff_tpu on the same bridged float32 weights and batch: the trainable set,
every gradient (within 1e-3 of the leaf's largest magnitude; the rel-pos
tables get true gradients at tiny, where JAX's attention leaves its fused
path), one whole train step's metrics and `exclude`. The CLIP tower and
projector's counterparts are in test_torch_train_clip.py.
"""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.core.config import TrainConfig as JaxTrainConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import TrainConfig
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from haff_tpu_torch.train import trainer as ttrainer
from test_lisa_model import make_tiny_batch
from test_torch_train import LOSSES, _cfg, _params, _port, _port_batch

EXTRA = ("image_encoder",)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = _params(cfg)
    batch = make_tiny_batch(cfg)
    return cfg, params, batch


def test_encoder_gradients_match_jax(setup):
    cfg, params, batch = setup
    model = JaxLisaModel(cfg=cfg)
    trainable, frozen = jtrainer.partition_params(params, extra=EXTRA)

    def loss_fn(t):
        return model.apply({"params": jtrainer.merge_params(t, frozen)},
                           batch).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    ref = flax_to_state_dict(grads)

    port = _port(params, cfg)
    ptrain, pfrozen = ttrainer.partition_params(port, extra=EXTRA)
    assert set(ptrain) == set(ref)
    assert not any("image_encoder" in n for n in pfrozen)
    out = port(_port_batch(batch), remat=True)
    np.testing.assert_allclose(float(out.loss.detach()), float(loss), rtol=1e-4)
    out.loss.backward()
    encoder = [n for n in ptrain if "image_encoder" in n]
    assert any("rel_pos_h" in n for n in encoder)
    for name in encoder:
        g, r = ptrain[name].grad, ref[name].numpy()
        assert g is not None, name
        scale = float(np.abs(r).max())
        err = float(np.abs(g.numpy() - r).max())
        assert scale > 0 and err <= 1e-3 * scale + 1e-7, (name, err, scale)


def test_train_step_with_encoder_matches_jax(setup):
    cfg, params, batch = setup
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=20,
              grad_accumulation_steps=1, remat=True)
    jcfg = JaxTrainConfig(model=cfg, **kw)
    jtrain, jfrozen = jtrainer.partition_params(params, extra=EXTRA)
    jstate = jtrainer.init_train_state(jcfg, jtrain)
    jstep = jax.jit(jtrainer.make_train_step(JaxLisaModel(cfg=cfg), jcfg))

    port = _port(params, cfg)
    trainable, _ = ttrainer.partition_params(port, extra=EXTRA)
    state = ttrainer.init_train_state(TrainConfig(**kw), trainable)
    step = ttrainer.make_train_step(port, TrainConfig(**kw))
    pbatch = _port_batch(batch)
    name = "visual_model.image_encoder.blocks.0.attn.qkv.weight"
    before = trainable[name].detach().clone()
    for _ in range(2):
        jstate, jm = jstep(jstate, jfrozen, batch, jax.random.PRNGKey(0))
        state, m = step(state, pbatch, 0)
        for key in LOSSES + ("grad_norm",):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
    assert not torch.equal(trainable[name], before)


def test_exclude_removes_keys(setup):
    cfg, params, _ = setup
    port = _port(params, cfg)
    trainable, frozen = ttrainer.partition_params(
        port, exclude=("mask_decoder_left", "mask_decoder_right"))
    ref = set(flax_to_state_dict(jtrainer.partition_params(
        params, exclude=("mask_decoder_left", "mask_decoder_right"))[0]))
    assert set(trainable) == ref
    assert any("mask_decoder_left" in n for n in frozen)


def test_frozen_encoder_keeps_no_graph(setup):
    cfg, params, batch = setup
    port = _port(params, cfg)
    ttrainer.partition_params(port)
    sam_emb, _ = port.splice_inputs(_port_batch(batch))
    assert not sam_emb.requires_grad
    ttrainer.partition_params(port, extra=EXTRA)
    sam_emb, _ = port.splice_inputs(_port_batch(batch))
    assert sam_emb.requires_grad


def test_bf16_model_holds_the_unfrozen_encoder_in_float32(setup):
    """The 7b dtype policy with the encoder unfrozen: its parameters are
    held in float32 and cast to bfloat16 at use, so the encoder still
    computes in bfloat16 and every encoder gradient is float32 and finite."""
    import dataclasses

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.model.lisa import LisaModel

    cfg, _, batch = setup
    pcfg = ModelConfig.preset("tiny")
    pcfg = pcfg.replace(llama=dataclasses.replace(pcfg.llama, lora_rank=2))
    port = LisaModel(pcfg, torch.bfloat16, device="cpu")
    trainable, frozen = ttrainer.partition_params(port, extra=EXTRA)
    encoder = port.visual_model.image_encoder
    assert encoder.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in encoder.parameters())
    assert frozen["vision_tower.pre_layrnorm.weight"].dtype == torch.bfloat16
    seen = []
    hook = encoder.blocks[0].register_forward_hook(
        lambda m, a, out: seen.append(out.dtype))
    out = port(_port_batch(batch), remat=True)
    hook.remove()
    assert set(seen) == {torch.bfloat16}
    out.loss.backward()
    for name, p in trainable.items():
        if "image_encoder" in name:
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
