"""SAM modules of the port (haff_tpu_torch/nn/sam*.py, prompt encoder,
two-way transformer, mask decoder) against haff_tpu/nn with the same
bridged float32 weights: the image encoder (windowed + global blocks,
with and without window padding), the prompt encoder + dual mask decode
with the taxonomy head, and the canvas postprocess.

Tolerance 1e-4 abs + rel: float32 throughout, differences come from
summation order over encoder depth and the decoder's attention sums.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.nn.sam import Sam as JaxSam
from haff_tpu.nn.sam import postprocess_masks_padded as j_post
from haff_tpu.nn.sam import resize_to_original as j_resize
from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.nn.sam import Sam, postprocess_masks_padded, resize_to_original
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(image_size=None, seed=0):
    """(JAX Sam, its params, port Sam with the same weights)."""
    jcfg, pcfg = JaxModelConfig.preset("tiny"), ModelConfig.preset("tiny")
    jenc, penc = jcfg.sam_encoder, pcfg.sam_encoder
    if image_size is not None:
        jenc = dataclasses.replace(jenc, image_size=image_size)
        penc = dataclasses.replace(penc, image_size=image_size)
    jsam = JaxSam(encoder_cfg=jenc, decoder_cfg=jcfg.sam_decoder)
    S, d = jenc.image_size, jcfg.sam_decoder.prompt_embed_dim
    shapes = fnn.unbox(jax.eval_shape(
        jsam.init, jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
        jnp.zeros((1, 1, d))))["params"]
    params = random_like(shapes, seed)
    psam = Sam(penc, pcfg.sam_decoder)
    psam.load_state_dict(flax_to_state_dict(params), strict=True)
    return jsam, params, psam.eval()


@pytest.mark.parametrize("image_size", [128, 96])
def test_image_encoder_matches(image_size):
    """128: 8x8 grid in 4x4 windows; 96: 6x6 grid, windows padded to 8x8."""
    jsam, params, psam = _pair(image_size)
    x = np.random.default_rng(1).standard_normal(
        (2, image_size, image_size, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jsam.apply({"params": p}, x,
                                          method="encode_image"))(params, x)
    with torch.no_grad():
        got = psam.encode_image(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_prompt_encoder_and_dual_decode_match():
    jsam, params, psam = _pair()
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((3, 8, 8, 32)).astype(np.float32)
    text = rng.standard_normal((3, 1, 32)).astype(np.float32)
    ref = jax.jit(lambda p, e, t: jsam.apply(
        {"params": p}, e, t, method="decode_masks"))(params, emb, text)
    with torch.no_grad():
        got = psam.decode_masks(torch.from_numpy(emb), torch.from_numpy(text))
    assert len(got) == len(ref) == 5
    for name, g, r in zip(("masks_l", "masks_r", "iou_l", "iou_r", "taxonomy"),
                          got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)
    pe = jsam.apply({"params": params},
                    method=lambda m: m.prompt_encoder.get_dense_pe())
    np.testing.assert_allclose(psam.prompt_encoder.get_dense_pe().detach().numpy(),
                               np.asarray(pe), **TOL)


@pytest.mark.parametrize("low,size", [(32, 128), (24, 100)])
def test_postprocess_masks_padded_matches_jax_resize(low, size):
    x = np.random.default_rng(low).standard_normal(
        (2, 1, low, low)).astype(np.float32)
    np.testing.assert_allclose(
        postprocess_masks_padded(torch.from_numpy(x), size).numpy(),
        np.asarray(j_post(jnp.asarray(x), size)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("orig", [(250, 300), (90, 110)])
def test_resize_to_original_matches(orig):
    canvas = np.random.default_rng(0).standard_normal(
        (2, 128, 128)).astype(np.float32)
    np.testing.assert_allclose(resize_to_original(canvas, (100, 120), orig),
                               j_resize(canvas, (100, 120), orig),
                               rtol=1e-4, atol=1e-4)
