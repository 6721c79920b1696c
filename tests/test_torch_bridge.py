"""Weight bridge: JAX parameter trees and export .npz files load into the
PyTorch port (haff_tpu_torch/tools/bridge.py), strictly and in the right
layout. Also holds the shared tiny-preset fixtures of the port's parity
tests (`jax_tiny_params`, `port_model`, `write_npz`)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.model.lisa import LisaModel as JaxLisaModel
from haff_tpu.model.lisa import TrainBatch
from haff_tpu.tools.export_params import load_exported_params
from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.model.lisa import LisaModel
from haff_tpu_torch.tools.bridge import (flax_to_state_dict, load_jax_params,
                                        load_npz, widen_bf16)

NPZ = "artifacts/overfit_small_params.npz"


def init_batch(cfg, b=1, seq=12):
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return TrainBatch(
        images_sam=jnp.zeros((b, S, S, 3)), images_clip=jnp.zeros((b, C, C, 3)),
        image_index=jnp.zeros((b,), jnp.int32),
        input_ids=jnp.ones((b, seq), jnp.int32),
        labels=jnp.ones((b, seq), jnp.int32),
        attention_mask=jnp.ones((b, seq), jnp.int32),
        masks_left=jnp.zeros((b, S, S)), masks_right=jnp.zeros((b, S, S)),
        taxonomies=jnp.zeros((b, 4)), valid_region=jnp.ones((b, S, S)),
        sample_weight=jnp.ones((b,)))


def random_like(shape_tree, seed):
    """Seeded numpy values for every leaf of a parameter-shape tree:
    fan-in-scaled kernels, near-one norm scales, small biases and
    moderate tables (rel-pos, positions, tokens), so every path of the
    model carries signal."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in sorted(traverse_util.flatten_dict(shape_tree).items()):
        shape, name = leaf.shape, path[-1]
        z = rng.standard_normal(shape)
        if name == "kernel":
            v = z / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "weight") and len(shape) == 1:
            v = 1.0 + 0.1 * z
        elif name == "bias":
            v = 0.1 * z
        elif name == "positional_encoding_gaussian_matrix":
            v = z
        else:
            v = 0.5 * z
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def jax_param_shapes(model, cfg):
    """The parameter tree `jax.jit(model.init)` gives, as shapes only
    (jax.eval_shape traces init without compiling it)."""
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), init_batch(cfg))
    return fnn.unbox(tree)["params"]


def jax_tiny_params(seed=0):
    """(JAX tiny LisaModel in float32, its seeded parameter tree)."""
    cfg = JaxModelConfig.preset("tiny")
    model = JaxLisaModel(cfg=cfg)
    return model, random_like(jax_param_shapes(model, cfg), seed)


def port_model(params, preset="tiny", **cfg_kw):
    """The port's LisaModel on the CPU in float32 with `params` bridged."""
    cfg = ModelConfig.preset(preset)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    return load_jax_params(LisaModel(cfg, torch.float32, device="cpu"),
                           params)


def write_npz(params, path) -> str:
    """A JAX parameter tree (boxed or not, under "params" or not) as the
    flat float32 .npz of haff_tpu/tools/export_params.py, for the port's
    `checkpoint=` arguments."""
    tree = fnn.unbox(params)
    tree = tree.get("params", tree)
    flat = {"/".join(k): np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(tree).items()}
    np.savez(path, **flat)
    return str(path)


def test_tiny_tree_loads_strict_with_layouts():
    model, params = jax_tiny_params()
    sd = flax_to_state_dict(params)
    port = port_model(params)
    got = port.state_dict()
    assert set(got) == set(sd)
    llm = params["llm"]["model"]["layers_0"]
    np.testing.assert_array_equal(
        got["llm.model.layers.0.self_attn.q_proj.base.weight"].numpy(),
        llm["self_attn"]["q_proj"]["base"]["kernel"].T)
    sam = params["visual_model"]
    conv = sam["image_encoder"]["neck_conv2"]["kernel"]          # HWIO
    np.testing.assert_array_equal(
        got["visual_model.image_encoder.neck_conv2.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))                               # OIHW
    convt = sam["mask_decoder_left"]["upscale_conv1"]["kernel"]  # (kh,kw,out,in)
    w = got["visual_model.mask_decoder_left.upscale_conv1.weight"].numpy()
    assert w.shape == (convt.shape[3], convt.shape[2], 2, 2)      # (in,out,kh,kw)
    np.testing.assert_array_equal(
        got["visual_model.mask_decoder_left.hyper_mlps.3.layers.2.bias"].numpy(),
        sam["mask_decoder_left"]["hyper_mlps_3"]["layers_2"]["bias"])
    np.testing.assert_array_equal(
        got["vision_tower.layers.0.layer_norm1.weight"].numpy(),
        params["vision_tower"]["layers_0"]["layer_norm1"]["scale"])


def test_bridge_rejects_missing_parameter():
    _, params = jax_tiny_params()
    del params["text_fc1"]["bias"]
    with pytest.raises(RuntimeError, match="text_fc1.bias"):
        port_model(params)


def test_npz_bf16_widening_matches_export_loader():
    ours = traverse_util.flatten_dict(load_npz(NPZ))
    ref = traverse_util.flatten_dict(load_exported_params(NPZ))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=str(k))


def test_widen_bf16_bits():
    bits = np.array([0x3F80, 0xC000, 0x7F80, 0x0001, 0x0000], np.uint16)
    np.testing.assert_array_equal(
        widen_bf16(bits), np.array([1.0, -2.0, np.inf, 9.183549615799121e-41,
                                    0.0], np.float32))


def test_npz_loads_into_small_port_model():
    port = port_model(NPZ, preset="small")
    ref = traverse_util.flatten_dict(load_npz(NPZ))
    np.testing.assert_array_equal(
        port.state_dict()["llm.lm_head.weight"].numpy(),
        ref[("llm", "lm_head", "kernel")].T)


def test_lora_tree_loads_strict():
    """A JAX tree with LoRA rank 2 (lora_a (in, r), lora_b (r, out) on
    q/v) loads strictly; the adapters keep the JAX layout unchanged."""
    cfg = JaxModelConfig.preset("tiny")
    cfg = cfg.replace(llama=dataclasses.replace(cfg.llama, lora_rank=2))
    params = random_like(jax_param_shapes(JaxLisaModel(cfg=cfg), cfg), 3)
    port = port_model(params, llama=dataclasses.replace(
        ModelConfig.preset("tiny").llama, lora_rank=2))
    got = port.state_dict()
    assert set(got) == set(flax_to_state_dict(params))
    attn = params["llm"]["model"]["layers_1"]["self_attn"]
    for proj in ("q_proj", "v_proj"):
        for leaf in ("lora_a", "lora_b"):
            np.testing.assert_array_equal(
                got[f"llm.model.layers.1.self_attn.{proj}.{leaf}"].numpy(),
                attn[proj][leaf])
    assert "llm.model.layers.1.self_attn.k_proj.lora_a" not in got


@pytest.mark.parametrize("bits,predicate,group", [
    (8, "lisa_serving_predicate", 64), (4, "default_llm_predicate", 16)])
def test_quantized_tree_loads_strict_and_equals_in_place_quantization(
        bits, predicate, group):
    """A tree `quantize_dense_tree` made loads strictly: int8 (in, out) /
    packed uint8 (in/2, out) kernels and their scales arrive transposed
    with their dtypes kept, a LayerNorm's `scale` still becomes `weight`;
    and quantizing the port's float model in place gives the same
    state_dict bit for bit."""
    from haff_tpu.nn import quant as jq
    from haff_tpu_torch.nn import quant as tq

    _, params = jax_tiny_params()
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(
        params, getattr(jq, predicate), bits=bits, group=group))
    sd = flax_to_state_dict(qtree)
    port = port_model(qtree)
    got = port.state_dict()
    assert set(got) == set(sd)
    q = qtree["llm"]["model"]["layers_1"]["mlp"]["down_proj"]
    name = "llm.model.layers.1.mlp.down_proj"
    want = np.int8 if bits == 8 else np.uint8
    assert q["kernel"].dtype == want
    assert got[name + ".weight"].numpy().dtype == want
    np.testing.assert_array_equal(got[name + ".weight"].numpy(), q["kernel"].T)
    assert got[name + ".scale"].dtype == torch.float32
    np.testing.assert_array_equal(got[name + ".scale"].numpy(), q["scale"].T)
    assert name + ".weight" not in dict(port.named_parameters())
    np.testing.assert_array_equal(          # a LayerNorm scale, untouched
        got["vision_tower.layers.0.layer_norm1.weight"].numpy(),
        params["vision_tower"]["layers_0"]["layer_norm1"]["scale"])
    in_place = tq.quantize_model_(port_model(params), getattr(tq, predicate),
                                  bits=bits, group=group).state_dict()
    assert set(in_place) == set(got)
    for k, v in got.items():
        assert in_place[k].dtype == v.dtype, k
        assert torch.equal(in_place[k], v), k


def test_quantized_tree_into_a_bfloat16_model_keeps_float32_scales():
    """LisaModel(cfg, bfloat16) casts floating parameters and buffers; the
    bridged scales stay float32 and the integer weights stay integer."""
    from haff_tpu.nn import quant as jq

    _, params = jax_tiny_params()
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(
        params, jq.lisa_serving_predicate, bits=8))
    port = load_jax_params(
        LisaModel(ModelConfig.preset("tiny"), torch.bfloat16, device="cpu"),
        qtree)
    port.to(torch.bfloat16)
    sd = port.state_dict()
    name = "visual_model.image_encoder.blocks.0.attn.qkv"
    assert sd[name + ".weight"].dtype == torch.int8
    assert sd[name + ".scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        sd[name + ".scale"].numpy(),
        qtree["visual_model"]["image_encoder"]["blocks_0"]["attn"]["qkv"][
            "scale"])
    assert sd[name + ".bias"].dtype == torch.bfloat16
    assert port.visual_model.image_encoder.blocks[0].attn.qkv.compute_dtype \
        == torch.bfloat16
