"""The SAM-only serving slice of the port against haff_tpu, float32 on the
CPU, from the same bridged weights and numpy inputs:

* data/transforms.py: equal arrays;
* nn/sam.py preprocess_image; the prompt encoder with points, a box,
  points + a box, a mask, and nothing;
* the image encoder at geometries evaluate() does not reach: a 256-pixel
  image (a 16 x 16 global grid, under 1024 tokens, goes through the fused
  window entry), `use_rel_pos=False`, the `small` preset (8 heads x 32,
  8 x 8 windows, a 32 x 32 global grid) forward and backward, with remat;
* infer/sam_predictor.py predict, predict_batch and infer/amg.py
  from_predictor at the tiny preset.

Tolerance 1e-4 abs + rel for modules (summation order over depth);
gradients within 1e-3 of each leaf's largest magnitude.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import ModelConfig as JaxModelConfig
from haff_tpu.core.config import SamEncoderConfig as JaxSamEncoderConfig
from haff_tpu.data import transforms as jtf
from haff_tpu.infer import amg as jamg
from haff_tpu.infer.sam_predictor import SamPredictor as JaxSamPredictor
from haff_tpu.nn.sam import Sam as JaxSam
from haff_tpu.nn.sam import preprocess_image as j_preprocess
from haff_tpu_torch.core.config import ModelConfig, SamEncoderConfig
from haff_tpu_torch.data import transforms as ttf
from haff_tpu_torch.infer import amg as tamg
from haff_tpu_torch.infer.sam_predictor import SamPredictor
from haff_tpu_torch.nn.sam import Sam, preprocess_image
from haff_tpu_torch.tools.bridge import load_jax_params
from test_torch_bridge import random_like

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(jenc=None, penc=None, seed=0, preset="tiny"):
    """(JAX Sam, its params, the port's Sam with the same weights); the
    decoder, and by default the encoder, are the preset's."""
    jcfg, pcfg = JaxModelConfig.preset(preset), ModelConfig.preset(preset)
    jenc, penc = jenc or jcfg.sam_encoder, penc or pcfg.sam_encoder
    jsam = JaxSam(encoder_cfg=jenc, decoder_cfg=jcfg.sam_decoder)
    S, d = jenc.image_size, jcfg.sam_decoder.prompt_embed_dim
    shapes = fnn.unbox(jax.eval_shape(
        jsam.init, jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
        jnp.zeros((1, 1, d))))["params"]
    params = random_like(shapes, seed)
    psam = load_jax_params(Sam(penc, pcfg.sam_decoder), params)
    return jsam, params, psam.eval()


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair()


# --------------------------------------------------------------------------
# Host transforms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(60, 90), (720, 1280), (300, 200)])
def test_transforms_equal_arrays(hw):
    rng = np.random.RandomState(hw[0])
    frame = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    assert ttf.get_preprocess_shape(*hw, 128) == jtf.get_preprocess_shape(*hw, 128)
    np.testing.assert_array_equal(ttf.resize_longest_side(frame, 128),
                                  jtf.resize_longest_side(frame, 128))
    got, ghw = ttf.sam_preprocess(frame, 128)
    ref, rhw = jtf.sam_preprocess(frame, 128)
    assert ghw == rhw
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ttf.clip_preprocess(frame, 32),
                                  jtf.clip_preprocess(frame, 32))
    mask = rng.rand(*hw) > 0.5
    np.testing.assert_array_equal(ttf.mask_to_canvas(mask, ghw, 128),
                                  jtf.mask_to_canvas(mask, rhw, 128))
    np.testing.assert_array_equal(ttf.valid_region(ghw, 128),
                                  jtf.valid_region(rhw, 128))


def test_preprocess_image_matches():
    x = (np.random.default_rng(0).random((2, 50, 70, 3)) * 255).astype(np.float32)
    np.testing.assert_allclose(preprocess_image(x, 96).numpy(),
                               np.asarray(j_preprocess(jnp.asarray(x), 96)),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# Prompt encoder
# --------------------------------------------------------------------------

def _prompts(kind):
    rng = np.random.default_rng(3)
    pts = (rng.random((2, 3, 2)) * 128).astype(np.float32)
    labels = np.array([[1, 0, -1], [0, 1, 1]], np.int32)
    boxes = (rng.random((2, 4)) * 128).astype(np.float32)
    masks = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    return {"points": dict(points=(pts, labels)),
            "box": dict(boxes=boxes),
            "points+box": dict(points=(pts, labels), boxes=boxes),
            "mask": dict(masks=masks, points=(pts, labels)),
            "none": {}}[kind]


@pytest.mark.parametrize("kind", ["points", "box", "points+box", "mask",
                                  "none"])
def test_prompt_encoder_matches(tiny_pair, kind):
    jsam, params, psam = tiny_pair
    kw = _prompts(kind)
    ref = jsam.apply({"params": params}, method=lambda m: m.prompt_encoder(
        **jax.tree_util.tree_map(jnp.asarray, kw)))
    as_t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    tkw = {k: tuple(as_t(x) for x in v) if isinstance(v, tuple) else as_t(v)
           for k, v in kw.items()}
    if "points" in tkw:
        tkw["points"] = (tkw["points"][0], tkw["points"][1].long())
    with torch.no_grad():
        got = psam.prompt_encoder(**tkw)
    for name, g, r in zip(("sparse", "dense"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   err_msg=name, **TOL)


# --------------------------------------------------------------------------
# Image encoder, other geometries
# --------------------------------------------------------------------------

def _encode_both(jsam, params, psam, x):
    ref = jax.jit(lambda p, x: jsam.apply({"params": p}, x,
                                          method="encode_image"))(params, x)
    with torch.no_grad():
        got = psam.encode_image(torch.from_numpy(x))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kw", [dict(image_size=256),
                                dict(use_rel_pos=False),
                                dict(image_size=96, use_rel_pos=False)])
def test_image_encoder_small_grid_and_no_rel_pos(kw):
    """256 pixels: a 16 x 16 global grid (< 1024 tokens) through the fused
    window entry; 96 without rel-pos: windows padded 6 -> 8."""
    jenc = dataclasses.replace(JaxSamEncoderConfig.preset("tiny"), **kw)
    penc = dataclasses.replace(SamEncoderConfig.preset("tiny"), **kw)
    jsam, params, psam = _pair(jenc, penc)
    if kw.get("use_rel_pos") is False:
        assert not any("rel_pos" in n for n, _ in psam.named_parameters())
    S = jenc.image_size
    x = np.random.default_rng(1).standard_normal((2, S, S, 3)).astype(np.float32)
    got, ref = _encode_both(jsam, params, psam, x)
    np.testing.assert_allclose(got, ref, **TOL)


def test_image_encoder_small_preset_forward_and_backward():
    """The small preset (256 wide, 8 heads x 32, window 8, global grid
    32 x 32): values, and the gradient of sum(emb * g) on every encoder
    parameter with each block recomputed (remat). The global blocks'
    rel-pos tables get exact zeros on both sides (the JAX fused global
    path runs there); the windowed blocks' tables get true gradients."""
    jenc = JaxSamEncoderConfig.preset("small")
    penc = SamEncoderConfig.preset("small")
    jsam, params, psam = _pair(preset="small")
    S = jenc.image_size
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    g = rng.standard_normal((1, 32, 32, jenc.out_chans)).astype(np.float32)

    def loss(enc_params):
        p = dict(params, image_encoder=enc_params)
        emb = jsam.apply({"params": p}, x, method="encode_image")
        return jnp.sum(emb * g), emb

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["image_encoder"])
    from haff_tpu_torch.tools.bridge import flax_to_state_dict
    jgrads = flax_to_state_dict(jgrads)

    enc = psam.image_encoder
    emb = enc(torch.from_numpy(x), remat=True)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(ref), **TOL)
    (emb * torch.from_numpy(g)).sum().backward()
    assert set(jgrads) == {n for n, _ in enc.named_parameters()}
    for name, p in enc.named_parameters():
        r = jgrads[name].numpy()
        if "rel_pos" in name and int(name.split(".")[1]) in penc.global_attn_indexes:
            assert not r.any() and not p.grad.numpy().any(), name
            continue
        scale = float(np.abs(r).max())
        err = float(np.abs(p.grad.numpy() - r).max())
        assert scale > 0 and err <= 1e-3 * scale + 1e-7, (name, err, scale)


# --------------------------------------------------------------------------
# SamPredictor and the automatic mask generator
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def predictors(tiny_pair):
    jsam, params, psam = tiny_pair
    S = 128
    frame = (np.random.RandomState(0).rand(60, 90, 3) * 255).astype(np.uint8)
    jp = JaxSamPredictor(jsam, {"params": params}, image_size=S)
    tp = SamPredictor(psam, image_size=S, device="cpu")
    jp.set_image(frame)
    tp.set_image(frame)
    return jp, tp, frame


def test_predictor_embedding_and_coords(predictors):
    jp, tp, _ = predictors
    np.testing.assert_allclose(tp._embedding.numpy(),
                               np.asarray(jp._embedding), **TOL)
    assert tp._input_hw == jp._input_hw and tp._orig_hw == jp._orig_hw
    pt = np.array([[90.0, 60.0]])
    np.testing.assert_array_equal(tp._transform_coords(pt),
                                  jp._transform_coords(pt))
    assert not tp._embedding.requires_grad


@pytest.mark.parametrize("kw", [
    dict(point_coords=np.array([[45.0, 30.0]]), point_labels=np.array([1]),
         multimask_output=True, hand="left"),
    dict(point_coords=np.array([[10.0, 8.0], [70.0, 50.0]]),
         point_labels=np.array([1, 0]), multimask_output=False, hand="right"),
    dict(box=np.array([10.0, 10.0, 70.0, 50.0]), multimask_output=False,
         hand="right"),
    dict(point_coords=np.array([[45.0, 30.0]]), point_labels=np.array([1]),
         box=np.array([10.0, 10.0, 70.0, 50.0]), multimask_output=True,
         hand="left"),
], ids=["point-left-multi", "points-right-single", "box-right", "point+box"])
def test_predict_matches(predictors, kw):
    jp, tp, frame = predictors
    ref = jp.predict(return_logits=True, **kw)
    got = tp.predict(return_logits=True, **kw)
    n = 3 if kw["multimask_output"] else 1
    assert got[0].shape == (n, *frame.shape[:2]) and got[1].shape == (n,)
    for name, g, r in zip(("masks", "iou", "taxonomy"), got, ref):
        assert (g is None) == (r is None), name
        if g is not None:
            np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)
    assert (got[2] is None) == (kw["hand"] == "right")
    binary = tp.predict(**kw)[0]
    assert binary.dtype == bool
    np.testing.assert_array_equal(binary, got[0] > 0)


def test_predict_batch_matches_and_equals_per_prompt(predictors):
    jp, tp, frame = predictors
    pts = np.array([[10.0, 8.0], [32.0, 24.0], [50.0, 40.0]])
    ref = jp.predict_batch(pts, multimask_output=True, return_logits=True,
                           hand="left")
    got = tp.predict_batch(pts, multimask_output=True, return_logits=True,
                           hand="left")
    assert got[0].shape == (3, 3, *frame.shape[:2])
    assert got[1].shape == (3, 3) and got[2].shape == (3, 4)
    for name, g, r in zip(("masks", "iou", "taxonomy"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)
    for k in range(3):
        m, i, t = tp.predict(point_coords=pts[k:k + 1],
                             point_labels=np.array([1]), multimask_output=True,
                             return_logits=True, hand="left")
        np.testing.assert_allclose(got[0][k], m, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got[1][k], i, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[2][k], t, rtol=1e-5, atol=1e-5)


def test_amg_from_predictor_matches(predictors, monkeypatch):
    """The whole 4 x 4 grid is one decode; the records equal the JAX
    generator's (same masks within tolerance give the same RLE here: the
    comparison is on areas, boxes and scores)."""
    jp, tp, frame = predictors
    calls = []
    inner = tp._decode
    monkeypatch.setattr(tp, "_decode", lambda *a, **k: calls.append(1)
                        or inner(*a, **k))
    kw = dict(hand="left", points_per_side=4, pred_iou_thresh=-1e9,
              stability_thresh=0.0, box_nms_thresh=0.7)
    got = tamg.from_predictor(tp, **kw).generate(frame.shape[:2])
    ref = jamg.from_predictor(jp, **kw).generate(frame.shape[:2])
    assert len(calls) == 1
    assert len(got) == len(ref) and got
    for g, r in zip(got, ref):
        assert set(g) == set(r) and "_bbox_xyxy" not in g
        assert g["point_coords"] == r["point_coords"]
        assert abs(g["predicted_iou"] - r["predicted_iou"]) < 1e-4
        assert abs(g["area"] - r["area"]) <= 2          # pixels at logit ~ 0
        assert max(abs(a - b) for a, b in zip(g["bbox"], r["bbox"])) <= 1
        assert g["segmentation"]["size"] == list(frame.shape[:2])


def test_amg_primitives_equal():
    np.testing.assert_array_equal(tamg.build_point_grid(5),
                                  jamg.build_point_grid(5))
    rng = np.random.RandomState(0)
    m = rng.rand(13, 17) > 0.5
    assert tamg.mask_to_rle(m) == jamg.mask_to_rle(m)
    assert tamg.mask_to_box(m) == jamg.mask_to_box(m)
    assert tamg.box_xyxy_to_xywh([5, 3, 14, 7]) == [5, 3, 9, 4]
    logits = rng.randn(16, 16) * 3
    assert tamg.stability_score(logits) == jamg.stability_score(logits)
    recs = [dict(_bbox_xyxy=[0, 0, 10, 10], predicted_iou=0.9),
            dict(_bbox_xyxy=[1, 1, 11, 11], predicted_iou=0.8),
            dict(_bbox_xyxy=[20, 20, 30, 30], predicted_iou=0.7)]
    kept = tamg.nms([dict(r) for r in recs], 0.5)
    assert [r["predicted_iou"] for r in kept] == [0.9, 0.7]


def test_bridge_fills_a_sam_from_a_whole_model_export():
    """`scope="visual_model"`: a `Sam` alone from the exported whole-model
    .npz (the trained small-preset artifact), equal to the whole model's."""
    import os

    from haff_tpu_torch.model.lisa import LisaModel

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "overfit_small_params.npz")
    cfg = ModelConfig.preset("small")
    sam = load_jax_params(Sam(cfg.sam_encoder, cfg.sam_decoder), path,
                          scope="visual_model")
    whole = load_jax_params(LisaModel(cfg, torch.float32, device="cpu"), path)
    ref = whole.visual_model.state_dict()
    got = sam.state_dict()
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert got["image_encoder.blocks.0.attn.qkv.weight"].abs().max() > 0


def test_predictor_defaults_to_the_card(tiny_pair):
    psam = tiny_pair[2]
    with pytest.raises(RuntimeError, match="set_image"):
        SamPredictor(psam, device="cpu").predict(box=np.zeros(4))
    if torch.cuda.is_available():
        assert SamPredictor(psam).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            SamPredictor(psam)
    psam.to("cpu")
