"""Training the CLIP tower or its projector
(`partition_params(extra=("vision_tower",))`, `("mm_projector",)`) at the
tiny preset against haff_tpu on the same bridged float32 weights and
batch: the trainable set and every gradient of the unfrozen module's
leaves (within 1e-3 of the leaf's largest magnitude, as
test_torch_train_encoder.py holds the SAM encoder's); a frozen tower keeps
no autograd graph; and the 7b dtype policy (trainable leaves held in
float32, the tower computing in bfloat16).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from haff_tpu_torch.train import trainer as ttrainer
from test_lisa_model import make_tiny_batch
from test_torch_train import _cfg, _params, _port, _port_batch

MODULES = ("vision_tower", "mm_projector")


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    return cfg, _params(cfg), make_tiny_batch(cfg)


@pytest.mark.parametrize("module", MODULES)
def test_clip_gradients_match_jax(setup, module):
    cfg, params, batch = setup
    model = JaxLisaModel(cfg=cfg)
    trainable, frozen = jtrainer.partition_params(params, extra=(module,))

    def loss_fn(t):
        return model.apply({"params": jtrainer.merge_params(t, frozen)},
                           batch).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    ref = flax_to_state_dict(grads)

    port = _port(params, cfg)
    ptrain, pfrozen = ttrainer.partition_params(port, extra=(module,))
    assert set(ptrain) == set(ref)
    assert not any(n.startswith(module + ".") for n in pfrozen)
    out = port(_port_batch(batch))
    np.testing.assert_allclose(float(out.loss.detach()), float(loss), rtol=1e-4)
    out.loss.backward()
    leaves = [n for n in ptrain if n.startswith(module + ".")]
    assert leaves
    for name in leaves:
        g, r = ptrain[name].grad, ref[name].numpy()
        assert g is not None, name
        scale = float(np.abs(r).max())
        err = float(np.abs(g.numpy() - r).max())
        assert scale > 0 and err <= 1e-3 * scale + 1e-7, (name, err, scale)


def test_frozen_clip_keeps_no_graph(setup):
    cfg, params, batch = setup
    port = _port(params, cfg)
    ttrainer.partition_params(port)
    tower = {}
    hook = port.mm_projector.register_forward_hook(
        lambda m, a, out: tower.update(out=out))
    port.splice_inputs(_port_batch(batch))
    assert not tower["out"].requires_grad
    ttrainer.partition_params(port, extra=("mm_projector",))
    port.splice_inputs(_port_batch(batch))
    assert tower["out"].requires_grad
    with torch.no_grad():
        port.splice_inputs(_port_batch(batch))
    hook.remove()
    assert not tower["out"].requires_grad


def test_bf16_model_holds_the_unfrozen_tower_in_float32(setup):
    """The 7b dtype policy with the CLIP tower unfrozen: its parameters are
    held in float32 and cast to bfloat16 at use, so the tower still
    computes in bfloat16 and every tower gradient is float32 and finite."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.model.lisa import LisaModel

    _, _, batch = setup
    pcfg = ModelConfig.preset("tiny")
    pcfg = pcfg.replace(llama=dataclasses.replace(pcfg.llama, lora_rank=2))
    port = LisaModel(pcfg, torch.bfloat16, device="cpu")
    trainable, frozen = ttrainer.partition_params(
        port, extra=("vision_tower",))
    tower = port.vision_tower
    assert tower.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tower.parameters())
    assert frozen["mm_projector.weight"].dtype == torch.bfloat16
    seen = []
    hook = tower.layers[0].register_forward_hook(
        lambda m, a, out: seen.append(out.dtype))
    out = port(_port_batch(batch))
    hook.remove()
    assert set(seen) == {torch.bfloat16}
    out.loss.backward()
    for name, p in trainable.items():
        if name.startswith("vision_tower."):
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
