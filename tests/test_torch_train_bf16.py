"""The port's mixed-precision training forward (the dtype policy of the 7b
train step) at the tiny preset with LoRA rank 2: the model in bfloat16,
`partition_params` holding the trainable set in float32 and casting it to
bfloat16 at use, against the JAX model with dtype=bfloat16 and
param_dtype=float32 on the same bridged weights and batch.

* Loss terms within rtol 1e-3 of JAX's (bf16 rounding: 2^-8 relative per
  value; the terms are means over many values).
* Gradients, by group of the trainable set (LoRA adapters, embed_tokens,
  lm_head, [SEG] projection, each mask decoder): the relative L2 error
  against JAX's bf16 gradients within twice that of the port's own
  float32 run against them (what bf16 rounding alone moves) plus 1e-3.
  Single leaves are too noisy at bf16 to compare: leaves whose exact
  gradient is 0 carry only rounding.
* Every product that touches a trainable parameter runs in bfloat16:
  every dense layer and transposed convolution takes bf16 operands, and
  the trainable modules (adapters, embedding, dense layers, the decoders'
  two-way transformers and MLPs) emit bf16.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.train import trainer as jtrainer
from haff_tpu_torch.core.config import ModelConfig, TrainConfig
from haff_tpu_torch.model.lisa import LisaModel
from haff_tpu_torch.nn.layers import LayerNorm, QDense, ReluMLP
from haff_tpu_torch.nn.llama import Embed
from haff_tpu_torch.nn.lora import LoraDense
from haff_tpu_torch.nn.mask_decoder import MaskDecoder
from haff_tpu_torch.nn.two_way_transformer import TwoWayTransformer
from haff_tpu_torch.tools.bridge import flax_to_state_dict, load_jax_params
from haff_tpu_torch.train import trainer as ttrainer
from test_lisa_model import make_tiny_batch
from test_torch_train import LOSSES, _cfg, _params, _port_batch

GROUPS = ("lora_", "embed_tokens", "lm_head", "text_fc",
          "mask_decoder_left", "mask_decoder_right")
PRODUCTS = {F.linear: "linear", torch.conv_transpose2d: "conv_transpose2d"}


def _port(params, cfg, dtype):
    llama = dataclasses.replace(ModelConfig.preset("tiny").llama,
                                lora_rank=cfg.llama.lora_rank)
    model = LisaModel(dataclasses.replace(ModelConfig.preset("tiny"),
                                          llama=llama), dtype, device="cpu")
    return load_jax_params(model, params)


class _ProductDtypes(TorchFunctionMode):
    """Records the operand dtypes of every dense layer and transposed
    convolution."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.seen[(PRODUCTS[func], tuple(
                a.dtype for a in args if isinstance(a, torch.Tensor)))] += 1
        return func(*args, **(kwargs or {}))


def _watch_outputs(model):
    """Forward hooks recording the output dtypes of the trainable modules:
    each module with a trainable parameter of its own, and inside the mask
    decoders (whose masks and taxonomy are float32 by design) every module
    but the float32 LayerNorms."""
    seen = collections.defaultdict(set)

    def hook(mod, _inp, out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                seen[type(mod).__name__].add(t.dtype)

    decoders = [m for m in model.modules() if isinstance(m, MaskDecoder)]
    inside = {id(s) for m in decoders for s in m.modules()}
    for mod in model.modules():
        if id(mod) in inside:
            if not isinstance(mod, MaskDecoder) and type(mod) is not LayerNorm:
                mod.register_forward_hook(hook)
        elif any(p.requires_grad for p in mod.parameters(recurse=False)):
            mod.register_forward_hook(hook)
    return seen


@pytest.fixture(scope="module")
def runs():
    """JAX bf16 loss terms and gradients; the port's in float32 and in
    bfloat16 (the latter with its product and output dtypes recorded)."""
    cfg = _cfg()
    params = _params(cfg)
    batch = make_tiny_batch(cfg)
    model = JaxLisaModel(cfg=cfg, dtype=jnp.bfloat16,
                         param_dtype=jnp.float32)
    trainable, frozen = jtrainer.partition_params(params)

    def loss_fn(t):
        out = model.apply({"params": jtrainer.merge_params(t, frozen)}, batch)
        return out.loss, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable)
    port = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = _port(params, cfg, dtype)
        tr, fr = ttrainer.partition_params(m)
        outputs = _watch_outputs(m)
        with _ProductDtypes() as products:
            out = m(_port_batch(batch))
        out.loss.backward()
        port[dtype] = dict(model=m, trainable=tr, frozen=fr, out=out,
                           outputs=outputs, products=products.seen)
    return (cfg, params, batch), jout, flax_to_state_dict(jgrads), port


@pytest.mark.parametrize("name", LOSSES)
def test_bf16_loss_terms_match_jax(runs, name):
    _, jout, _, port = runs
    got = float(getattr(port[torch.bfloat16]["out"], name).detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(getattr(jout, name)), rtol=1e-3)


@pytest.mark.parametrize("group", GROUPS)
def test_bf16_gradients_match_jax(runs, group):
    _, _, jgrads, port = runs
    names = [n for n in jgrads if group in n]
    assert names

    def flat(grads):
        return np.concatenate([
            np.zeros(np.asarray(jgrads[n]).size, np.float32)
            if grads[n] is None else grads[n].float().numpy().ravel()
            for n in names])

    ref = np.concatenate([np.asarray(jgrads[n], np.float32).ravel()
                          for n in names])
    assert np.abs(ref).max() > 0
    rel = lambda g: float(np.linalg.norm(g - ref) / np.linalg.norm(ref))  # noqa: E731
    got = {dt: flat({n: port[dt]["trainable"][n].grad for n in names})
           for dt in port}
    assert rel(got[torch.bfloat16]) <= 2 * rel(got[torch.float32]) + 1e-3
    # Gradients of the float32 master copies are float32.
    assert all(port[torch.bfloat16]["trainable"][n].grad.dtype == torch.float32
               for n in names
               if port[torch.bfloat16]["trainable"][n].grad is not None)


def test_bf16_trainable_set_held_in_float32_and_cast_at_use(runs):
    run = runs[3][torch.bfloat16]
    assert all(p.dtype == torch.float32 for p in run["trainable"].values())
    assert all(p.dtype == torch.bfloat16 for p in run["frozen"].values())
    bf = torch.bfloat16
    assert {k for k, _ in run["products"]} == set(PRODUCTS.values())
    for (op, dtypes), n in run["products"].items():
        assert set(dtypes) == {bf}, (op, dtypes, n)
    outputs = run["outputs"]
    for name in (LoraDense, Embed, QDense, TwoWayTransformer, ReluMLP):
        assert outputs[name.__name__] == {bf}, (name.__name__,
                                                outputs[name.__name__])
    assert all(dts == {bf} for dts in outputs.values()), dict(outputs)


def test_float32_model_sets_no_compute_dtype(runs):
    """In a float32 model the partition changes only requires_grad, and
    its products run in float32."""
    run = runs[3][torch.float32]
    assert all(getattr(m, "compute_dtype", None) is None
               for m in run["model"].modules())
    for (_, dtypes), _ in run["products"].items():
        assert set(dtypes) == {torch.float32}


def test_bf16_train_steps_update_masters_only(runs):
    """Two train steps of the bf16 model: finite metrics, the float32
    masters change, the bf16 frozen weights stay bit-identical."""
    (cfg, params, batch), _, _, _ = runs
    m = _port(params, cfg, torch.bfloat16)
    trainable, frozen = ttrainer.partition_params(m)
    frozen0 = {k: v.detach().clone() for k, v in frozen.items()}
    train0 = {k: v.detach().clone() for k, v in trainable.items()}
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=20,
                       grad_accumulation_steps=1, remat=True)
    state = ttrainer.init_train_state(tcfg, trainable)
    step = ttrainer.make_train_step(m, tcfg)
    pbatch = _port_batch(batch)
    for _ in range(2):
        state, metrics = step(state, pbatch, 0)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(torch.equal(frozen0[k], v) for k, v in frozen.items())
    assert all(v.dtype == torch.float32 for v in trainable.values())
    assert not torch.equal(train0["llm.lm_head.weight"],
                           trainable["llm.lm_head.weight"])
