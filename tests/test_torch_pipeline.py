"""The port's 2HANDS pipeline (haff_tpu_torch.pipeline: ops, defaults,
orchestrate, annotations) against haff_tpu.pipeline on the same seeded
inputs, on the CPU.

Tolerances: the ops, the temporal fill and every host step are exact.
Propagation's window sums run in another order than XLA's, so a shift
whose cost ties another's to rounding, or a gate test on its threshold,
may go the other way: the masks must agree on all but at most 0.1% of
the pixels of every frame (on these clips they agree on every pixel).
The diffusion fill may differ by 1 (of 255) where its float sum rounds
across an integer before the uint8 cast.
"""

import json
import os
import sys

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.pipeline import annotations as JA
from haff_tpu.pipeline import defaults as JD
from haff_tpu.pipeline import ops as JO
from haff_tpu.pipeline import orchestrate as JR
from haff_tpu_torch.pipeline import annotations as TA
from haff_tpu_torch.pipeline import defaults as TD
from haff_tpu_torch.pipeline import ops as TO
from haff_tpu_torch.pipeline import orchestrate as TR

sys.path.insert(0, os.path.dirname(__file__))
from test_pipeline_annotations import NARRATION_ROWS, _visor_export  # noqa: E402
from test_pipeline_quality import _camera_clip, _make_clip, _sweeping_hand  # noqa: E402

# Share of a frame's pixels on which propagated masks may differ.
PROPAGATE_PIXEL_TOL = 1e-3


def T(a):
    return torch.as_tensor(np.asarray(a))


def _masks(seed, shape, p=0.9):
    return (np.random.RandomState(seed).rand(*shape) > p).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 3, 4, 5, 10])
def test_dilate_masks_equals_jax(factor):
    m = _masks(factor, (3, 37, 29), 0.97)
    np.testing.assert_array_equal(
        TO.dilate_masks(T(m), factor).numpy(),
        np.asarray(JO.dilate_masks(jnp.asarray(m), factor)))


def test_dilate_masks_anchor_is_jaxs():
    """JAX's window [i - pad_lo, i + pad_hi], pad_lo = factor - 1 -
    factor // 2: a pixel dilates factor // 2 before it and the rest after.
    That equals cv2.dilate for odd factors; for even ones cv2 puts the
    extra pixel on the other side (a pixel at 8 spreads to 7..10 at factor
    4), and the port keeps JAX's 6..9."""
    m = np.zeros((1, 16, 16), np.float32)
    m[0, 8, 8] = 1
    for factor, span in ((4, (6, 9)), (5, (6, 10)), (2, (7, 8))):
        out = TO.dilate_masks(T(m), factor).numpy()[0]
        ys, xs = np.nonzero(out)
        assert (ys.min(), ys.max()) == (xs.min(), xs.max()) == span
        if factor % 2:
            ref = cv2.dilate(m[0].astype(np.uint8),
                             np.ones((factor, factor), np.uint8))
            np.testing.assert_array_equal(out, ref.astype(np.float32))


def test_recolor_and_affordance_equal_jax():
    rng = np.random.RandomState(1)
    a = rng.randint(0, 3, (2, 9, 11)).astype(np.float32)
    b = rng.randint(0, 2, (2, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(TO.recolor_white(T(a)).numpy(),
                                  np.asarray(JO.recolor_white(jnp.asarray(a))))
    np.testing.assert_array_equal(
        TO.extract_affordance(T(a), T(b)).numpy(),
        np.asarray(JO.extract_affordance(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (2, 6, 4, 3), (1, 5, 5, 3),
                                   (2, 7, 3)])
def test_pad_to_square_equals_jax(shape):
    x = np.random.RandomState(2).randint(1, 255, shape).astype(np.uint8)
    np.testing.assert_array_equal(TO.pad_to_square(T(x)).numpy(),
                                  np.asarray(JO.pad_to_square(jnp.asarray(x))))


@pytest.mark.parametrize("batched", [False, True])
def test_horizontal_flip_sample_equals_jax(batched):
    rng = np.random.RandomState(3)
    lead = (2,) if batched else ()
    img = rng.rand(*lead, 5, 7, 3).astype(np.float32)
    ml, mr = _masks(4, lead + (5, 7)), _masks(5, lead + (5, 7))
    tax = rng.rand(*lead, 4).astype(np.float32)
    got = TO.horizontal_flip_sample(T(img), T(ml), T(mr), T(tax))
    want = JO.horizontal_flip_sample(jnp.asarray(img), jnp.asarray(ml),
                                     jnp.asarray(mr), jnp.asarray(tax))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_crop_bgr_area_and_narration_gates_equal_jax():
    img = np.random.RandomState(6).randint(0, 255, (40, 60, 3), np.uint8)
    for box, off in (((10, 5, 30, 20), 4), ((0, 0, 60, 40), 50),
                     ((50, 30, 59, 39), 20)):
        np.testing.assert_array_equal(TO.crop_around_bbox(img, box, off),
                                      JO.crop_around_bbox(img, box, off))
    np.testing.assert_array_equal(TO.bgr_to_rgb(T(img[None])).numpy(),
                                  np.asarray(JO.bgr_to_rgb(jnp.asarray(img[None]))))
    for area in (0, 20, 21, 29999, 30000):
        m = np.zeros(40000, np.uint8)
        m[:area] = 1
        assert TO.mask_area_ok(m) == JO.mask_area_ok(m)
    for narr, verb in (("cut onion", None), ("eat apple", None), ("", None),
                       ("null", None), ("None", "cut"), ("Look at", None),
                       ("open door", "wait"), ("open door", "open")):
        assert TO.narration_ok(narr, verb) == JO.narration_ok(narr, verb)
    assert TO.EXCLUDED_VERBS == JO.EXCLUDED_VERBS


def test_color_jitter_equals_jax_on_jaxs_factors():
    """JAX's factors, drawn from its key as its color_jitter draws them,
    through the port's arithmetic; and the port's own draw in range."""
    imgs = np.random.RandomState(7).randint(0, 256, (3, 12, 10, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    kb, kc, ks = jax.random.split(key, 3)
    factors = [T(1.0 + jax.random.uniform(k, (3, 1, 1, 1), minval=-a,
                                          maxval=a))
               for k, a in ((kb, 0.2), (kc, 0.3), (ks, 0.1))]
    got = TO.apply_color_jitter(T(imgs), *factors).numpy()
    want = np.asarray(JO.color_jitter(jnp.asarray(imgs), key, 0.2, 0.3, 0.1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = TO.color_jitter(T(imgs), g1, 0.2, 0.3, 0.1)
    fb, fc, fs = TO.jitter_factors(3, g2, 0.2, 0.3, 0.1)
    assert torch.equal(a, TO.apply_color_jitter(T(imgs), fb, fc, fs))
    for f, r in ((fb, 0.2), (fc, 0.3), (fs, 0.1)):
        assert f.shape == (3, 1, 1, 1)
        assert ((f >= 1 - r) & (f <= 1 + r)).all()


# ---------------------------------------------------------------------------
# defaults
# ---------------------------------------------------------------------------

def _textured_frame(size=96, seed=0):
    """A smooth random texture (blurred noise) with a bright object, the
    stand-in for a real frame in JAX's camera-motion quality clips."""
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (size, size, 3)).astype(
        np.uint8), (7, 7), 2.0)
    obj = np.zeros((size, size), np.uint8)
    obj[30:62, 36:70] = 1
    img[obj > 0] = np.clip(img[obj > 0].astype(int) + 90, 0, 255)
    return img, obj


def _clips():
    """JAX's quality clips, cut short: the moving square (with and without
    the occluder crossing it) and a panning/rotating/zooming camera."""
    square = _make_clip(n=10, size=96)
    occluded = _make_clip(n=14, size=96, occlude=True, seed=1)
    img, obj = _textured_frame()
    panning = _camera_clip(img, obj, n=8)
    return {"square": square, "occluded": occluded, "panning": panning}


@pytest.mark.parametrize("clip", ["square", "occluded", "panning"])
def test_propagate_masks_equals_jax(clip):
    frames, gts = _clips()[clip]
    seeds = np.stack([gts[0], 1 - gts[0]]).astype(np.float32)
    want = np.asarray(JD.propagate_masks(jnp.asarray(frames),
                                         jnp.asarray(seeds)))
    got = TD.propagate_masks(T(frames), T(seeds)).numpy()
    assert got.shape == want.shape == (len(frames), 2) + gts.shape[1:]
    off = (got != want).reshape(len(frames), -1).mean(-1)
    assert off.max() <= PROPAGATE_PIXEL_TOL, off


def test_propagate_masks_edges_and_gate():
    """Radius, window and gate other than the defaults; a seed at the
    border (the 'edge' padding) and a clip cut to black (every pixel
    gated out)."""
    frames, gts = _make_clip(n=5, size=48, obj=12, step=(1, 2), seed=3)
    frames = frames.copy()
    frames[4] = 0
    seeds = np.zeros((1, 48, 48), np.float32)
    seeds[0, :10, :6] = 1
    for radius, window, gate in ((2, 3, 0.1), (6, 9, 0.25), (3, 5, 0.05)):
        want = np.asarray(JD.propagate_masks(
            jnp.asarray(frames), jnp.asarray(seeds), radius=radius,
            window=window, color_gate=gate))
        got = TD.propagate_masks(T(frames), T(seeds), radius=radius,
                                 window=window, color_gate=gate).numpy()
        np.testing.assert_array_equal(got, want)


def test_temporal_inpaint_equals_jax():
    """A static camera under a sweeping hand (every pixel visible in some
    frame: exact), a panning camera (the forward and backward fills), and
    a patch masked in every frame (the diffusion fill)."""
    img, obj = _textured_frame(seed=2)
    aff = np.zeros_like(obj)
    aff[20:44, 10:30] = 1
    cases = []
    static = np.repeat(img[None], 8, 0)
    cases.append((static, _sweeping_hand(aff, 8)))
    panning, _ = _camera_clip(img, obj, n=8)
    hand = _sweeping_hand(aff, 8)
    hand[:, 70:90, 70:90] = 1       # never visible: diffusion
    cases.append((panning, hand))
    for frames, masks in cases:
        corrupted = frames.copy()
        corrupted[masks > 0] = 0
        want = np.asarray(JD.temporal_inpaint(jnp.asarray(corrupted),
                                              jnp.asarray(masks)))
        got = TD.temporal_inpaint(T(corrupted), T(masks)).numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        never = ~(masks == 0).any(0)
        assert not diff[:, ~never].any()
        assert diff.max() <= 1


def test_default_wrappers_equal_jax_on_the_cpu():
    frames, gts = _make_clip(n=6, size=64, obj=16)
    left = np.zeros_like(gts[0])
    left[5:15, 5:15] = 1
    got = TD.default_propagate(frames, left, 1 - left, gts[0], device="cpu")
    want = JD.default_propagate(frames, left, 1 - left, gts[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        TD.default_inpaint(frames, gts, device="cpu"),
        JD.default_inpaint(frames, gts))


# ---------------------------------------------------------------------------
# orchestrate
# ---------------------------------------------------------------------------

def test_contours_taxonomy_and_filter_equal_jax():
    m = np.zeros((32, 40), np.uint8)
    m[4:12, 5:20] = 1
    m[20:30, 25:35] = 1
    m[22:24, 27:29] = 0
    assert TR.mask_to_contours(m) == JR.mask_to_contours(m)
    for tax in ([1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.25, 0.25]):
        for hl in (False, True):
            for hr in (False, True):
                assert (TR.expand_taxonomy(tax, hl, hr)
                        == JR.expand_taxonomy(tax, hl, hr))
    big = np.ones((200, 200), np.uint8)
    for tax in ([1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0]):
        for al, ar in ((m, None), (None, m), (m, m), (big, m), (None, None)):
            for narr in ("cut onion", "eat it"):
                kw = dict(inpainted=np.zeros((32, 40, 3), np.uint8),
                          narration=narr, taxonomy=tax, aff_left=al,
                          aff_right=ar)
                assert (TR.filter_record(TR.FrameRecord(**kw))
                        == JR.filter_record(JR.FrameRecord(**kw)))


def _scene(n=6, H=64, W=64):
    """JAX's end-to-end clip: a static object overlapped by both hands."""
    frames = np.full((n, H, W, 3), 40, np.uint8)
    seed_obj = np.zeros((H, W), np.uint8)
    seed_l = np.zeros((H, W), np.uint8)
    seed_r = np.zeros((H, W), np.uint8)
    frames[:, 24:40, 24:40] = 220
    seed_obj[24:40, 24:40] = 1
    frames[:, 28:36, 20:28] = 140
    seed_l[28:36, 20:28] = 1
    frames[:, 28:36, 36:44] = 160
    seed_r[28:36, 36:44] = 1
    return frames, seed_l, seed_r, seed_obj


def read_shards(out_dir):
    """{relative path: contents} of a shard directory: every h5 dataset
    (strings decoded) and every json."""
    got = {}
    for sub in ("h5", "jsons"):
        d = os.path.join(out_dir, sub)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            path = os.path.join(d, name)
            if name.endswith(".h5"):
                with h5py.File(path, "r") as f:
                    for k, v in f["data"].items():
                        a = v[()]
                        got[f"{sub}/{name}/{k}"] = (
                            [x.decode() if isinstance(x, bytes) else x
                             for x in a] if a.dtype == object else a)
            else:
                with open(path, "rb") as f:
                    got[f"{sub}/{name}"] = f.read()
    return got


def assert_same_shards(got_dir, want_dir):
    got, want = read_shards(got_dir), read_shards(want_dir)
    assert sorted(got) == sorted(want) and got
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _completion(apply_cls):
    """A SAM stand-in for stage 5: a disc of radius 9 around each
    prompted point, as logits; the same for both packages."""
    def sam_apply(images, pts, labels):
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        yy, xx = np.mgrid[:h, :w]
        out = np.zeros((b, 1, h, w), np.float32) - 1
        for i in range(b):
            x, y = pts[i, 0]
            out[i, 0][(yy - y) ** 2 + (xx - x) ** 2 < 81] = 1
        assert (labels == 1).all()
        return out

    return lambda frames, objs: apply_cls(sam_apply, frames, objs)


@pytest.mark.parametrize("complete", [False, True])
def test_run_pipeline_from_video_equals_jax(tmp_path, complete):
    """Seeds -> propagate -> inpaint -> dilate -> (completion) ->
    affordance -> filter -> shards: the h5 datasets and the json byte for
    byte, several shards, and the port's AffDataset reads them."""
    from haff_tpu_torch.data.aff_dataset import AffDataset

    frames, sl, sr, so = _scene()
    kw = dict(shard_size=4, dilate_factor=3, shard_name="P07")
    js = JR.PipelineStages(complete_masks=_completion(
        JR.sam_mask_completion) if complete else None)
    ts = TR.PipelineStages(complete_masks=_completion(
        TR.sam_mask_completion) if complete else None)
    want = JR.run_pipeline_from_video(frames, sl, sr, so, "cut onion",
                                      [0.0, 1.0, 0.0], str(tmp_path / "j"),
                                      stages=js, **kw)
    got = TR.run_pipeline_from_video(frames, sl, sr, so, "cut onion",
                                     [0.0, 1.0, 0.0], str(tmp_path / "t"),
                                     stages=ts, device="cpu", **kw)
    assert [tuple(os.path.basename(p) for p in s) for s in got] == [
        tuple(os.path.basename(p) for p in s) for s in want]
    assert len(got) == 2
    assert_same_shards(str(tmp_path / "t"), str(tmp_path / "j"))
    ds = AffDataset(str(tmp_path / "t"), samples_per_epoch=2, seed=0)
    s = ds.get(0)
    assert "cut onion" in s.question
    assert np.asarray(s.mask_left).sum() > 0 or np.asarray(s.mask_right).sum() > 0


def test_records_then_packing_equal_the_entry_points(tmp_path):
    """video_records + pack_shards write what run_pipeline_from_video
    writes, and build_records gives the records run_pipeline packs:
    the same h5 datasets and json, byte for byte."""
    frames, sl, sr, so = _scene(n=3)
    n = frames.shape[0]
    vid = (frames, sl, sr, so, "open jar", [0.0, 0.0, 1.0])
    TR.run_pipeline_from_video(*vid, str(tmp_path / "a"), dilate_factor=4,
                               device="cpu", shard_size=2)
    recs = TR.video_records(*vid, dilate_factor=4, device="cpu")
    TR.pack_shards(recs, str(tmp_path / "b"), shard_size=2)
    assert_same_shards(str(tmp_path / "b"), str(tmp_path / "a"))
    args = (frames, np.repeat(sl[None], n, 0), np.repeat(sr[None], n, 0),
            np.repeat(so[None], n, 0), ["open jar"] * n,
            np.tile(np.float32([0, 0, 1]), (n, 1)))
    TR.run_pipeline(*args, str(tmp_path / "c"), dilate_factor=4,
                    device="cpu")
    recs = TR.build_records(*args, dilate_factor=4, device="cpu")
    assert len(recs) == n and all(r.taxonomy == [0.0, 0.0, 0.0, 1.0]
                                  for r in recs)
    TR.pack_shards(recs, str(tmp_path / "d"))
    assert_same_shards(str(tmp_path / "d"), str(tmp_path / "c"))


def test_sam_mask_completion_equals_jax():
    objs = np.zeros((3, 40, 50), np.uint8)
    objs[0, 5:15, 10:30] = 1
    objs[2, 30:38, 40:48] = 1          # frame 1 has no object: point (0, 0)
    imgs = np.zeros((3, 40, 50, 3), np.uint8)
    seen = []

    def apply(images, pts, labels):
        """Logits > 0 left of each prompt's x."""
        seen.append(pts.copy())
        cols = np.arange(50)[None, None, None, :]
        return np.where(cols < pts[:, :, :1, None], 1.0, -1.0) * np.ones(
            (1, 1, 40, 1))

    got = TR.sam_mask_completion(apply, imgs, objs)
    want = JR.sam_mask_completion(apply, imgs, objs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(seen[0], seen[1])
    np.testing.assert_allclose(seen[0][0, 0], (19.5, 9.5))
    assert got.dtype == np.uint8 and got.shape == (3, 40, 50)


def test_entry_points_need_a_device_or_the_cpu(tmp_path, monkeypatch):
    """Without a card the pipeline raises "no CUDA device" (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames, sl, sr, so = _scene(n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.run_pipeline_from_video(frames, sl, sr, so, "cut onion",
                                   [1, 0, 0], str(tmp_path))


# ---------------------------------------------------------------------------
# annotations
# ---------------------------------------------------------------------------

def test_annotations_to_records_equal_jax(tmp_path):
    """VISOR export -> annotations -> narration join -> json files and
    back -> object vocab -> FrameRecords, each step equal to JAX's."""
    exp = _visor_export()
    ja, ta = JA.visor_to_annotations(exp), TA.visor_to_annotations(exp)
    JA.add_narrations(ja, NARRATION_ROWS)
    TA.add_narrations(ta, NARRATION_ROWS)
    as_json = lambda a: {v: {f: x.to_json() for f, x in fr.items()}  # noqa: E731
                         for v, fr in a.items()}
    assert as_json(ta) == as_json(ja)
    csv_path = tmp_path / "n.csv"
    csv_path.write_text("video_id,start_frame,stop_frame,narration,verb,noun\n"
                        "P01_01,40,120,cut the vegetables,cut,vegetables\n")
    assert TA.read_narration_csv(str(csv_path)) == JA.read_narration_csv(
        str(csv_path))
    tp = TA.write_annotation_jsons(ta, str(tmp_path / "t"))
    jp = JA.write_annotation_jsons(ja, str(tmp_path / "j"))
    assert [os.path.relpath(p, tmp_path / "t") for p in tp] == [
        os.path.relpath(p, tmp_path / "j") for p in jp]
    for a, b in zip(tp, jp):
        assert open(a).read() == open(b).read()
    assert as_json(TA.load_annotation_jsons(str(tmp_path / "t"))) == as_json(
        JA.load_annotation_jsons(str(tmp_path / "j")))
    assert TA.object_id_vocab(ta) == JA.object_id_vocab(ja)
    for name in ("P01_01_frame_0000000050.jpg", "x_0001000_y.png"):
        assert TA.frame_id_from_name(name) == JA.frame_id_from_name(name)

    rng = np.random.RandomState(9)
    fids = sorted(ta["P01_01"])
    frames = {f: rng.randint(0, 255, (16, 16, 3)).astype(np.uint8)
              for f in fids}
    aff_l = {fids[0]: _masks(1, (16, 16), 0.5), fids[1]: np.zeros((16, 16))}
    aff_r = {fids[1]: _masks(2, (16, 16), 0.5)}
    obj_l = {fids[0]: _masks(3, (16, 16), 0.5)}
    kw = dict(aff_left=aff_l, aff_right=aff_r, obj_left=obj_l,
              object_ids=TA.object_id_vocab(ta))
    got = TA.records_from_annotations(frames, ta["P01_01"], **kw)
    want = JA.records_from_annotations(frames, ja["P01_01"], **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ("narration", "taxonomy", "noun", "verb", "obj_id_left",
                      "obj_id_right"):
            assert getattr(g, field) == getattr(w, field), field
        for field in ("inpainted", "aff_left", "aff_right", "obj_left",
                      "obj_right"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    TR.pack_shard(got, str(tmp_path / "ts"), shard_name="A")
    JR.pack_shard(want, str(tmp_path / "js"), shard_name="A")
    assert_same_shards(str(tmp_path / "ts"), str(tmp_path / "js"))
    with open(os.path.join(tmp_path, "ts", "jsons", "0-1_A.json")) as f:
        assert set(json.load(f)) == {"0", "1"}
