"""QLoRA at the tiny preset (LoRA rank 2, float32): the port's train step
over a model whose frozen LLM projections the train CLI quantized in place
(`train.cli.frozen_predicate`, `nn.quant.quantize_model_`), against JAX
over `quantize_dense_tree(frozen, default_llm_predicate)` (4 bits: its
packed kernels dequantized, `dequantized_int4`), on the same bridged
weights and batch. The gradient reaches the adapters through the
quantized products' straight-through backward (JAX `_int8_matmul_ste`;
the int4 products' exact dequantized backward).

* the quantized set equals JAX's (the frozen partition's LLM projections;
  the trainable `lm_head` stays float), the int8 / packed int4 values
  bit-equal;
* loss terms within 1e-3 (relative) and every trainable gradient within
  1e-3 of the leaf's largest magnitude (+1e-6) against JAX
  `value_and_grad` over the trainable partition, for 8 and 4 bits;
(One whole 8-bit train step against JAX `make_train_step` is in
tests/test_torch_qlora_step.py.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.nn import quant as jq
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.nn import quant as tq
from haff_tpu_torch.nn.layers import QDense
from haff_tpu_torch.tools.bridge import _torch_name, flax_to_state_dict
from haff_tpu_torch.train import trainer as ttrainer
from haff_tpu_torch.train.cli import frozen_predicate
from test_lisa_model import make_tiny_batch
from test_torch_train import LOSSES, _cfg, _params, _port, _port_batch

GROUP = 16  # tiny widths divide by 16, not by 64


def dequantized_int4(tree):
    """The int4 tree with each packed kernel dequantized to float32 (JAX
    `dequantize_kernel_int4`): the function the W4A16 product computes,
    x @ the dequantized weight, with no activation rounding. JAX's own
    XLA int4 route is not differentiated here: under `value_and_grad` on
    the CPU it gives another loss on each call on the same inputs (11.60
    to 11.78 seen, against 11.70378 from its deterministic forward and
    from this tree)."""
    flat = traverse_util.flatten_dict(tree)
    out = dict(flat)
    for k, v in flat.items():
        if k[-1] == "kernel" and np.asarray(v).dtype == np.uint8:
            out[k] = jq.dequantize_kernel_int4(v, flat[k[:-1] + ("scale",)],
                                               GROUP, jnp.float32)
            del out[k[:-1] + ("scale",)]
    return traverse_util.unflatten_dict(out)


@functools.lru_cache(maxsize=None)
def jax_side(bits):
    cfg = _cfg()
    model = JaxLisaModel(cfg=cfg)
    params = _params(cfg)
    batch = make_tiny_batch(cfg)
    trainable, frozen = jtrainer.partition_params(params)
    frozen_q = jq.quantize_dense_tree(frozen, jq.default_llm_predicate,
                                      bits=bits, group=GROUP)
    frozen_ref = dequantized_int4(frozen_q) if bits == 4 else frozen_q

    def loss_fn(t):
        out = model.apply({"params": jtrainer.merge_params(t, frozen_ref)},
                          batch)
        return out.loss, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable)
    return cfg, params, batch, trainable, frozen_q, out, grads


def port_side(params, cfg, bits):
    model = _port(params, cfg)
    trainable, frozen = ttrainer.partition_params(model)
    tq.quantize_model_(model, frozen_predicate(frozen,
                                               tq.default_llm_predicate),
                       bits=bits, group=GROUP)
    return model, trainable


@pytest.fixture(scope="module", params=[8, 4])
def both(request):
    bits = request.param
    cfg, params, batch, jtrain, frozen_q, out, grads = jax_side(bits)
    model, trainable = port_side(params, cfg, bits)
    got = model(_port_batch(batch))
    got.loss.backward()
    return bits, cfg, params, batch, jtrain, frozen_q, out, grads, model, \
        trainable, got


def test_quantized_set_and_values_equal_jax(both):
    bits, *_, frozen_q, _, _, model, _, _ = both
    flat = traverse_util.flatten_dict(frozen_q)
    want = {p[:-1] for p in flat if p[-1] == "scale"
            and np.asarray(flat.get(p[:-1] + ("kernel",), 0)).dtype
            in (np.int8, np.uint8)}
    sd = flax_to_state_dict({k: v for k, v in frozen_q.items()})
    modules = dict(model.named_modules())
    got = {n for n, m in modules.items()
           if isinstance(m, QDense) and m.quantized}
    assert got == {_torch_name(p + ("kernel",)).rsplit(".", 1)[0]
                   for p in want} and got
    assert not any("lm_head" in n for n in got)
    assert model.llm.lm_head.weight.dtype == torch.float32
    for n in got:
        m = modules[n]
        assert m.weight.dtype == (torch.int8 if bits == 8 else torch.uint8)
        assert torch.equal(m.weight, sd[n + ".weight"])
        assert torch.equal(m.scale, sd[n + ".scale"])


@pytest.mark.parametrize("name", LOSSES)
def test_qlora_loss_terms_match(both, name):
    out, got = both[6], both[10]
    ref, val = float(getattr(out, name)), float(getattr(got, name).detach())
    assert np.isfinite(val)
    np.testing.assert_allclose(val, ref, rtol=1e-3, err_msg=name)


def test_qlora_gradients_match(both):
    grads, trainable = both[7], both[9]
    ref = flax_to_state_dict(grads)
    assert set(ref) == set(trainable)
    for name, r in ref.items():
        g = trainable[name].grad
        r = r.numpy()
        if g is None:
            assert not r.any(), name
            continue
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-3 * float(np.abs(r).max()) + 1e-6, (name, err)
    # the adapters under the quantized bases receive gradient
    for name in ("llm.model.layers.0.self_attn.q_proj.lora_a",
                 "llm.model.layers.1.self_attn.v_proj.lora_b"):
        assert trainable[name].grad.abs().max() > 0, name
