"""The port's training step (haff_tpu_torch/model/lisa.py forward,
haff_tpu_torch/train/trainer.py) against haff_tpu's at the tiny preset
with LoRA rank 2, on the same bridged float32 weights and batch
(`make_tiny_batch`: three conversations over two images through
`image_index`, one row right-padded):

* loss terms (rtol 1e-4) and every trainable gradient (within 1e-3 of the
  leaf's largest magnitude, plus 1e-6 absolute for the leaves whose exact
  gradient is 0, such as key biases under softmax) against JAX
  `value_and_grad` of the model loss over the trainable partition;
* the trainable set against JAX `partition_params`;
* the optimizer against optax `make_optimizer` over 3 updates (warmup,
  active clipping, weight decay; and with grad_accumulation_steps=3);
* two whole train steps against the JAX step (LoRA dropout 0, so both are
  deterministic);
* remat on and off giving the same gradients with LoRA dropout on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.core.config import TrainConfig as JaxTrainConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import ModelConfig, TrainConfig
from haff_tpu_torch.core.mesh import Mesh
from haff_tpu_torch.model.lisa import TrainBatch
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from haff_tpu_torch.train import trainer as ttrainer
from test_lisa_model import make_tiny_batch
from test_torch_bridge import jax_param_shapes, port_model, random_like

LOSSES = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
          "taxonomy_ce_loss")


def _cfg(dropout=0.0):
    cfg = JaxModelConfig.preset("tiny")
    return cfg.replace(llama=dataclasses.replace(
        cfg.llama, lora_rank=2, lora_dropout=dropout))


def _params(cfg):
    params = random_like(jax_param_shapes(JaxLisaModel(cfg=cfg), cfg), 0)
    # Small adapters (alpha / r = 8 scales their product).
    for path, leaf in traverse_util.flatten_dict(params).items():
        if path[-1] in ("lora_a", "lora_b"):
            leaf *= 0.2
    return params


def _port(params, cfg):
    return port_model(params, llama=dataclasses.replace(
        ModelConfig.preset("tiny").llama, lora_rank=cfg.llama.lora_rank,
        lora_dropout=cfg.llama.lora_dropout))


def _port_batch(batch):
    return TrainBatch(*(np.array(x) for x in batch)).to("cpu")


@pytest.fixture(scope="module")
def jax_grads():
    """JAX loss terms and gradients over the trainable partition."""
    cfg = _cfg()
    model = JaxLisaModel(cfg=cfg)
    params = _params(cfg)
    batch = make_tiny_batch(cfg)
    trainable, frozen = jtrainer.partition_params(params)

    def loss_fn(t):
        out = model.apply({"params": jtrainer.merge_params(t, frozen)}, batch)
        return out.loss, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable)
    return cfg, params, batch, out, grads


@pytest.fixture(scope="module")
def port_grads(jax_grads):
    cfg, params, batch, _, _ = jax_grads
    model = _port(params, cfg)
    trainable, _ = ttrainer.partition_params(model)
    out = model(_port_batch(batch))
    out.loss.backward()
    return model, trainable, out


@pytest.mark.parametrize("name", LOSSES)
def test_loss_terms_match(jax_grads, port_grads, name):
    ref = float(getattr(jax_grads[3], name))
    got = float(getattr(port_grads[2], name).detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_trainable_set_matches_jax_partition(jax_grads, port_grads):
    params = jax_grads[1]
    ref = set(flax_to_state_dict(jtrainer.partition_params(params)[0]))
    assert set(port_grads[1]) == ref
    assert any(n.endswith("q_proj.lora_a") for n in ref)
    model = port_grads[0]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert any("image_encoder" in n for n in frozen)
    assert "llm.model.layers.0.self_attn.q_proj.base.weight" in frozen


def test_trainable_gradients_match(jax_grads, port_grads):
    ref = flax_to_state_dict(jax_grads[4])
    trainable = port_grads[1]
    assert set(ref) == set(trainable)
    for name, r in ref.items():
        g = trainable[name].grad
        r = r.numpy()
        if g is None:  # off the loss path (the IoU head): JAX gives zeros
            assert not r.any(), name
            continue
        scale = float(np.abs(r).max())
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-3 * scale + 1e-6, (name, err, scale)
    # The adapters and the embedding table really receive gradient.
    for name in ("llm.model.layers.1.self_attn.v_proj.lora_a",
                 "llm.embed_tokens.weight", "text_fc1.weight"):
        assert trainable[name].grad.abs().max() > 0, name


def _opt_cfgs(accum):
    kw = dict(lr=0.1, warmup_steps=2, total_steps=6, weight_decay=0.1,
              grad_clip_norm=0.5, grad_accumulation_steps=accum)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


@pytest.mark.parametrize("accum", [1, 3])
def test_optimizer_matches_optax(accum):
    jcfg, tcfg = _opt_cfgs(accum)
    rng = np.random.default_rng(accum)
    init = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = jtrainer.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = ttrainer.make_optimizer(tcfg, tparams.values())
    applied = 0
    for _ in range(3 * accum):
        grads = {k: (2.0 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in init.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied += opt.update([torch.from_numpy(grads[k]) for k in tparams])
        for k in init:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert applied == 3
    assert not np.array_equal(tparams["a"].numpy(), init["a"])


def test_two_train_steps_match_jax(jax_grads):
    cfg, params, batch, _, _ = jax_grads
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=20,
              grad_accumulation_steps=1, remat=False)
    jcfg = JaxTrainConfig(model=cfg, **kw)
    model = JaxLisaModel(cfg=cfg)
    jtrain, jfrozen = jtrainer.partition_params(params)
    jstate = jtrainer.init_train_state(jcfg, jtrain)
    jstep = jax.jit(jtrainer.make_train_step(model, jcfg))

    port = _port(params, cfg)
    trainable, frozen = ttrainer.partition_params(port)
    frozen0 = {k: v.detach().clone() for k, v in frozen.items()}
    state = ttrainer.init_train_state(TrainConfig(**kw), trainable)
    step = ttrainer.make_train_step(port, TrainConfig(**kw))
    pbatch = _port_batch(batch)
    for _ in range(2):
        jstate, jm = jstep(jstate, jfrozen, batch, jax.random.PRNGKey(0))
        state, m = step(state, pbatch, 0)
        for key in LOSSES + ("grad_norm",):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
    # Step 1 ran at lr 0, so step 2's gradient is the fixture's, and its
    # Adam step is about lr * sign(g) per element. Where |g| lies within the
    # gradient tolerance of 0, the two frameworks' signs may differ: there
    # the parameters may differ by up to 2 lr.
    ref = flax_to_state_dict(jstate.trainable)
    grad0 = flax_to_state_dict(jax_grads[4])
    for name, p in trainable.items():
        g = np.abs(grad0[name].numpy())
        noisy = g <= 1e-3 * g.max() + 1e-6
        r = ref[name].numpy()
        diff = np.abs(p.detach().numpy() - r)
        assert (diff[~noisy] <= 1e-5 + 1e-3 * np.abs(r[~noisy])).all(), name
        assert (diff[noisy] <= 2 * kw["lr"] + 1e-5).all(), name
    assert all(torch.equal(frozen0[k], v) for k, v in frozen.items())
    assert state.step == 2


def test_remat_keeps_gradients_with_lora_dropout(jax_grads):
    params = jax_grads[1]
    cfg = _cfg(dropout=0.3)
    port = _port(params, cfg)
    trainable, _ = ttrainer.partition_params(port)
    batch = _port_batch(jax_grads[2])
    names = list(trainable)

    def grads(**kw):
        for p in trainable.values():
            p.grad = None
        out = port(batch, **kw)
        out.loss.backward()
        return out.loss.detach(), [trainable[n].grad for n in names]

    loss_det, _ = grads()
    loss_a, ga = grads(dropout_seed=7, remat=False)
    loss_b, gb = grads(dropout_seed=7, remat=True)
    assert float(loss_a) != float(loss_det)  # the dropout is active
    torch.testing.assert_close(loss_b, loss_a, rtol=0, atol=0)
    for n, a, b in zip(names, ga, gb):
        assert (a is None) == (b is None), n
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=n)


def test_eval_step_matches_jax_forward(jax_grads):
    """make_eval_step: the deterministic forward without autograd, equal to
    the JAX forward's loss terms and predictions."""
    cfg, params, batch, out, _ = jax_grads
    port = _port(params, cfg)
    ttrainer.partition_params(port)
    got = ttrainer.make_eval_step(port)(_port_batch(batch))
    assert got.loss.grad_fn is None
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(out, name)), rtol=1e-4)
    np.testing.assert_allclose(got.pred_taxonomies.numpy(),
                               np.asarray(out.pred_taxonomies), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.pred_masks_left.numpy(),
                               np.asarray(out.pred_masks_left), rtol=1e-3,
                               atol=1e-4)


def test_train_step_accumulates_before_applying(jax_grads):
    """grad_accumulation_steps=3 (JAX tests/test_trainer.py
    test_grad_accumulation_steps): two micro-steps leave the parameters
    as they were, the third applies the mean."""
    cfg, params, batch, _, _ = jax_grads
    port = _port(params, cfg)
    trainable, _ = ttrainer.partition_params(port)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=50,
                       grad_accumulation_steps=3)
    state = ttrainer.init_train_state(tcfg, trainable)
    step = ttrainer.make_train_step(port, tcfg)
    head = trainable["llm.lm_head.weight"]
    t0 = head.detach().clone()
    pbatch = _port_batch(batch)
    for _ in range(2):
        state, _ = step(state, pbatch, 0)
        assert torch.equal(head, t0)
    state, m = step(state, pbatch, 0)
    assert not torch.equal(head, t0) and state.step == 3
    assert np.isfinite(float(m["loss"]))


def test_unported_training_modes_raise(jax_grads):
    """A pipe mesh needs the decoder cut into its stages first
    (parallel.sharding.param_shardings); pipeline training itself runs
    (tests/test_torch_pipeline_train.py)."""
    cfg, params, _, _, _ = jax_grads
    port = _port(params, cfg)
    with pytest.raises(ValueError, match="pipeline"):
        ttrainer.make_train_step(port, TrainConfig(),
                                 mesh=Mesh((1, 2, 1, 1, 1, 1)))
