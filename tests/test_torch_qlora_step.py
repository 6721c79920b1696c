"""One whole QLoRA train step at the tiny preset, 8 bits (the W8A8
straight-through backward under LoRA rank 2, float32): the port's
`make_train_step` over the model the train CLI quantizes in place against
JAX `make_train_step` over `quantize_dense_tree(frozen,
default_llm_predicate)`, on the same bridged weights and batch (set up as
tests/test_torch_qlora.py does): metrics within 1e-3 and the updated
adapters within 1e-3 relative."""

import jax
import numpy as np

from haff_tpu.core.config import TrainConfig as JaxTrainConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.nn import quant as jq
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import TrainConfig
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from haff_tpu_torch.train import trainer as ttrainer
from test_lisa_model import make_tiny_batch
from test_torch_qlora import GROUP, port_side
from test_torch_train import LOSSES, _cfg, _params, _port_batch


def test_qlora_train_step_matches_jax():
    bits = 8
    cfg = _cfg()
    params = _params(cfg)
    batch = make_tiny_batch(cfg)
    jtrain, frozen = jtrainer.partition_params(params)
    frozen_q = jq.quantize_dense_tree(frozen, jq.default_llm_predicate,
                                      bits=bits, group=GROUP)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=20,
              grad_accumulation_steps=1, remat=False)
    jstate = jtrainer.init_train_state(JaxTrainConfig(model=cfg, **kw),
                                       jtrain)
    jstep = jax.jit(jtrainer.make_train_step(
        JaxLisaModel(cfg=cfg), JaxTrainConfig(model=cfg, **kw)))
    jstate, jm = jstep(jstate, frozen_q, batch, jax.random.PRNGKey(0))
    model, trainable = port_side(params, cfg, bits)
    state = ttrainer.init_train_state(TrainConfig(**kw), trainable)
    state, m = ttrainer.make_train_step(model, TrainConfig(**kw))(
        state, _port_batch(batch), 0)
    for key in LOSSES + ("grad_norm",):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-3,
                                   err_msg=key)
    ref = flax_to_state_dict(jstate.trainable)
    for name, p in trainable.items():
        if name.endswith(("lora_a", "lora_b")):
            r = ref[name].numpy()
            err = np.abs(p.detach().numpy() - r)
            assert (err <= 1e-3 * np.abs(r) + 2 * kw["lr"] * 1e-3).all(), name
