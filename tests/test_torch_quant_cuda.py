"""The external-scales quantization family on the card. Skipped where there
is no CUDA device; on the chip:

    python -m pytest -m cuda tests/test_torch_quant_cuda.py --noconftest

* random_quantized_like made on the card: the same seed gives the same
  tensors, each of its kind (int8 / packed uint8 with constant scales
  0.02 / sqrt(in), float normal(0, 0.02)); the card's model serves through
  the W8A8 / W4A16 kernels, and the same tensors on the CPU through the
  plain versions: identical tokens, masks within 1e-3.
* Dequantize at use (bind_quantized_tree_ + make_jitted_evaluate(
  quant_scales=)) at tiny in float32: the card's graphed evaluate equals
  its eager one (under DequantizeAtUse) bit for bit and the CPU's within 1e-4 (identical tokens),
  and no quantized kernel launches.
"""

import collections

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import IMAGE_TOKEN_INDEX, ModelConfig
from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
from haff_tpu_torch.kernels import _build
from haff_tpu_torch.model.lisa import LisaModel
from haff_tpu_torch.nn import quant

pytestmark = pytest.mark.cuda

GROUP = 16  # tiny widths divide by 16
T, EOS = 6, 248


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_quant_cuda.py --noconftest)")
    return torch.device("cuda")


def _requests(cfg, b=2, length=10):
    rng = np.random.RandomState(7)
    ids = rng.randint(5, 400, (b, length)).astype(np.int64)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    att = np.ones((b, length), np.int64)
    att[1, 7:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.randn(b, S, S, 3).astype(np.float32),
            rng.randn(b, C, C, 3).astype(np.float32), ids, att)


def _cpu_copy(model, cfg):
    """The same tensors in a CPU model of the same structure."""
    cpu = quant.random_quantized_like(cfg, lambda path: False,
                                      dtype=torch.float32, device="cpu")
    for name, mod in model.named_modules():
        if getattr(mod, "quantized", False):
            twin = cpu.get_submodule(name)
            twin.set_quantized_(mod.weight.cpu(), mod.scale.cpu())
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


@pytest.mark.parametrize("bits,predicate", [
    (8, quant.lisa_serving_predicate), (4, quant.default_llm_predicate)])
def test_random_quantized_like_on_the_card(dev, bits, predicate):
    cfg = ModelConfig.preset("tiny")
    make = lambda: quant.random_quantized_like(  # noqa: E731
        cfg, predicate, seed=5, bits=bits, group=GROUP, dtype=torch.float32,
        device=dev)
    model, again = make(), make()
    for (name, t), u in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(t, u), name
        if t.dtype == torch.int8:
            assert t.min() >= -127 and t.max() <= 127
        if name.endswith(".scale"):
            din = model.get_submodule(name[:-6]).in_features
            assert torch.all(t == 0.02 / din ** 0.5)
    kind = "w8a8_matmul" if bits == 8 else "w4a16_matmul"
    cpu = _cpu_copy(model, cfg)
    req = _requests(cfg)
    _build.LAUNCHES.clear()
    got = evaluate_fn(model, *req, T, EOS, kv_cache_8bit=bits == 8)
    assert _build.LAUNCHES[kind] > 0
    want = evaluate_fn(cpu, *req, T, EOS, kv_cache_8bit=bits == 8)
    assert torch.equal(got.output_ids.cpu(), want.output_ids)
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        torch.testing.assert_close(getattr(got, key).cpu(),
                                   getattr(want, key), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_at_use_on_the_card(dev, bits):
    cfg = ModelConfig.preset("tiny")
    model = LisaModel(cfg, torch.float32, device=dev,
                      generator=torch.Generator(dev).manual_seed(2))
    cpu = LisaModel(cfg, torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for m in (model, cpu):
        qstate, scales = quant.quantize_tree(m, quant.default_llm_predicate,
                                             bits=bits, group=GROUP)
        quant.bind_quantized_tree_(m, qstate, scales)
    req = _requests(cfg)
    _build.LAUNCHES.clear()
    with quant.DequantizeAtUse(model, scales, torch.bfloat16):
        eager = evaluate_fn(model, *req, T, EOS)
    graphed = make_jitted_evaluate(model, T, EOS, quant_scales=scales,
                                   quant_dtype=torch.bfloat16)
    results = [graphed(*req) for _ in range(2)]  # capture, then replay
    assert (graphed.captures, graphed.replays) == (1, 1)
    launched = collections.Counter(_build.LAUNCHES)
    assert launched["w8a8_matmul"] == launched["w4a16_matmul"] == 0
    assert launched["decode_attn"] > 0
    with quant.DequantizeAtUse(cpu, scales, torch.bfloat16):
        want = evaluate_fn(cpu, *req, T, EOS)
    for got in results:
        for key in ("output_ids", "gen_lengths", "pred_masks_left",
                    "pred_masks_right", "taxonomies"):
            assert torch.equal(getattr(got, key), getattr(eager, key)), key
    assert torch.equal(eager.output_ids.cpu(), want.output_ids)
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        torch.testing.assert_close(getattr(eager, key).cpu(),
                                   getattr(want, key), rtol=1e-4, atol=1e-4)
