"""The port's evaluation (haff_tpu_torch/eval/metrics.py, annotations.py,
benchmark.py) against haff_tpu's on seeded masks and on annotation files
and benchmark folders the tests write: the same numbers, the same files,
as tests/test_metrics.py and tests/test_annotations.py check them."""

import io
import json
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.eval import annotations as JA
from haff_tpu.eval import benchmark as JB
from haff_tpu.eval import metrics as JM
from haff_tpu_torch.eval import annotations as TA
from haff_tpu_torch.eval import benchmark as TB
from haff_tpu_torch.eval import metrics as TM


def mask_pairs():
    """(pred, gt) pairs: seeded blobs and noise, both empty, one-sided
    empties, identical, disjoint, several components."""
    rng = np.random.RandomState(0)
    z = np.zeros((24, 32), np.uint8)
    blob = z.copy()
    blob[4:12, 6:20] = 1
    other = z.copy()
    other[8:20, 10:28] = 1
    two = other.copy()
    two[1:3, 1:3] = 1
    far = z.copy()
    far[18:22, 26:30] = 1
    pairs = [(blob, other), (z, z), (z, blob), (blob, z), (blob, blob),
             (blob, far), (two, blob), (blob, two)]
    for _ in range(4):
        pairs.append(((rng.rand(24, 32) > 0.7).astype(np.uint8),
                      (rng.rand(24, 32) > 0.6).astype(np.uint8)))
    return pairs


@pytest.mark.parametrize("k", range(12))
def test_metrics_equal_jax(k):
    pred, gt = mask_pairs()[k]
    assert TM.iou(pred, gt) == JM.iou(pred, gt)
    assert TM.iocm(pred, gt) == JM.iocm(pred, gt)
    assert TM.hausdorff(pred, gt) == JM.hausdorff(pred, gt)
    got = TM._first_external_contour(pred)
    want = JM._first_external_contour(pred)
    assert (got is None and want is None) or np.array_equal(got, want)
    if got is not None and JM._first_external_contour(gt) is not None:
        g = JM._first_external_contour(gt)
        assert TM.directed_hausdorff(got, g) == JM.directed_hausdorff(want, g)
    # the left|right union, with each hand given one of the pair
    assert TM.union_metrics(pred, gt, gt, pred) == JM.union_metrics(
        pred, gt, gt, pred)
    assert TM.union_metrics(pred, np.zeros_like(pred), gt, gt) == \
        JM.union_metrics(pred, np.zeros_like(pred), gt, gt)


def test_threshold_sweep_equal_jax():
    rng = np.random.RandomState(1)
    ll = rng.randn(24, 32).astype(np.float32) * 3
    lr = rng.randn(24, 32).astype(np.float32) * 3
    gl = (rng.rand(24, 32) > 0.7).astype(np.uint8)
    gr = np.zeros((24, 32), np.uint8)
    for ths in ((0.1, 0.2, 0.3, 0.5, 0.7), (0.5,), (0.9, 0.05)):
        assert TM.threshold_sweep(ll, lr, gl, gr, ths) == JM.threshold_sweep(
            ll, lr, gl, gr, ths)


def test_batched_metrics_equal_jax():
    pairs = mask_pairs()
    pred = np.stack([p for p, _ in pairs])
    gt = np.stack([g for _, g in pairs])
    for t_fn, j_fn in ((TM.iou_batch, JM.iou_batch),
                       (TM.iocm_batch, JM.iocm_batch)):
        got = t_fn(torch.from_numpy(pred), torch.from_numpy(gt))
        want = np.asarray(j_fn(jnp.asarray(pred), jnp.asarray(gt)))
        assert got.dtype == torch.float32 and got.shape == (len(pairs),)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
        # each row equals the host metric
        host = [TM.iou(p, g) if t_fn is TM.iou_batch else TM.iocm(p, g)
                for p, g in pairs]
        np.testing.assert_allclose(got.numpy(), host, rtol=1e-6)


def test_annotation_masks_equal_jax():
    polys = [[4, 4, 20, 4, 20, 20, 4, 20], [25.4, 2.6, 30.5, 9.5, 22, 11]]
    assert np.array_equal(TA.polygons_to_mask(polys, (32, 32)),
                          JA.polygons_to_mask(polys, (32, 32)))
    rng = np.random.RandomState(0)
    mask = (rng.rand(7, 9) > 0.6).astype(np.uint8)
    flat, counts, val, run = mask.T.reshape(-1), [], 0, 0
    for x in flat:
        if x == val:
            run += 1
        else:
            counts.append(run)
            val, run = x, 1
    counts.append(run)
    rle = {"counts": counts, "size": [7, 9]}
    got = TA.rle_to_mask(rle)
    assert np.array_equal(got, JA.rle_to_mask(rle)) and np.array_equal(
        got, mask)
    for ann in ({"segmentation": rle}, {"segmentation": polys}):
        assert np.array_equal(TA.coco_annotation_to_mask(ann, (7, 9)),
                              JA.coco_annotation_to_mask(ann, (7, 9)))


def tree_files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_extract_annotations_equal_jax(tmp_path):
    toras = [
        {"image": "123", "vid": "P01_01", "size": [40, 50],
         "polygons": {"left": [[5, 5, 15, 5, 15, 15, 5, 15]], "right": []}},
        {"frame": "frame_b", "size": [30, 30], "shapes": [
            {"label": "Left hand", "points": [[2, 2], [12, 2], [12, 9]]},
            {"label": "right", "points": [[14, 14], [28, 14], [28, 28],
                                          [14, 28]]}]}]
    (tmp_path / "toras.json").write_text(json.dumps(toras))
    coco = {
        "images": [{"id": 1, "file_name": "0000007.png", "height": 30,
                    "width": 30, "video": "P02_02"},
                   {"id": 2, "file_name": "x/0000008.jpg", "height": 20,
                    "width": 25}],
        "categories": [{"id": 1, "name": "hand_left"},
                       {"id": 2, "name": "hand_right"}],
        "annotations": [
            {"image_id": 1, "category_id": 2,
             "segmentation": [[2, 2, 10, 2, 10, 10, 2, 10]]},
            {"image_id": 1, "category_id": 2,
             "segmentation": [[12, 12, 20, 12, 20, 20]]},
            {"image_id": 2, "category_id": 1,
             "segmentation": {"counts": [30, 50, 420], "size": [20, 25]}},
            {"image_id": 9, "category_id": 1, "segmentation": []}]}
    (tmp_path / "coco.json").write_text(json.dumps(coco))
    for name, mod in (("port", TA), ("jax", JA)):
        assert mod.extract_toras_masks(str(tmp_path / "toras.json"),
                                       str(tmp_path / name / "t")) == 2
        assert mod.extract_coco_masks(str(tmp_path / "coco.json"),
                                      str(tmp_path / name / "c")) == 3
    got, want = tree_files(tmp_path / "port"), tree_files(tmp_path / "jax")
    assert got == want and len(got) == 5


@pytest.fixture(scope="module")
def bench_dirs(tmp_path_factory):
    """A benchmark folder (EPIC and ego videos, a frame with one hand, a
    frame without GT, obj masks for --intersection) and a comparison base
    with two threshold subfolders, predictions at another resolution."""
    import cv2

    root = tmp_path_factory.mktemp("bench")
    rng = np.random.RandomState(3)
    frames = [("P01_101", "0000001"), ("P01_101", "0000002"),
              ("ego_7", "0000010"), ("ego_7", "0000011")]
    for k, (vid, frame) in enumerate(frames):
        fdir = root / "bench" / vid / frame
        fdir.mkdir(parents=True)
        cv2.imwrite(str(fdir / "inpainting.png"),
                    rng.randint(0, 255, (60, 80, 3)).astype(np.uint8))
        if k != 3:  # the last frame has no GT at all
            gt = np.zeros((60, 80), np.uint8)
            gt[10 + k:40, 15:50 + k] = 255
            cv2.imwrite(str(fdir / "aff_left.png"), gt)
            if k != 1:
                cv2.imwrite(str(fdir / "aff_right.png"), np.roll(gt, 9, 1))
        obj = np.zeros((60, 80), np.uint8)
        obj[5:50, 5:70] = 255
        if k != 2:
            cv2.imwrite(str(fdir / "obj_left.png"), obj)
            cv2.imwrite(str(fdir / "obj_right.png"), obj)
        for th, shift in (("0.3", 0), ("0.5", 4)):
            cdir = root / "vis" / th / vid / frame
            cdir.mkdir(parents=True)
            pr = np.zeros((30, 40), np.uint8)
            pr[6 + shift:22, 8:26 + k] = 200
            cv2.imwrite(str(cdir / "aff_left.png"), pr)
            if k % 2 == 0:
                cv2.imwrite(str(cdir / "aff_right.png"),
                            (rng.rand(30, 40) > 0.8).astype(np.uint8) * 255)
            # siblings layout "<base><th>" as the inference CLI writes it
            sib = root / f"sib{th}" / vid / frame
            sib.mkdir(parents=True)
            cv2.imwrite(str(sib / "aff_left.png"), pr)
    return root


@pytest.mark.parametrize("kw", [
    {"default_size": (60, 80)}, {"cropped": True},
    {"only": "epic", "default_size": (60, 80)},
    {"only": "ego", "cropped": True},
    {"intersection": True, "cropped": True}])
def test_evaluate_folder_and_map_equal_jax(bench_dirs, kw, tmp_path):
    b = str(bench_dirs / "bench")
    c = str(bench_dirs / "vis" / "0.5")
    got = TB.evaluate_folder(b, c, vis_dir=str(tmp_path / "tv"), **kw)
    want = JB.evaluate_folder(b, c, vis_dir=str(tmp_path / "jv"), **kw)
    assert got == want and got["frames"] > 0
    assert tree_files(tmp_path / "tv") == tree_files(tmp_path / "jv")
    for base in (str(bench_dirs / "vis"), str(bench_dirs / "sib")):
        got = TB.evaluate_map(b, base, (0.3, 0.5), **kw)
        assert got == JB.evaluate_map(b, base, (0.3, 0.5), **kw)
        assert len(got["per_threshold"]) == 2


@pytest.mark.parametrize("argv", [
    ["--map", "--thresholds", "0.3", "0.5", "--cropped"],
    ["--only", "epic", "--cropped"], ["--intersection", "--cropped"]])
def test_benchmark_main_equal_jax(bench_dirs, argv):
    b = str(bench_dirs / "bench")
    c = str(bench_dirs / ("vis" if "--map" in argv else "vis/0.3"))
    outs = []
    for mod in (TB, JB):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main(["--benchmark_dir", b, "--comparison_dir", c, *argv])
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1]
    assert (outs[0].get("best") or outs[0])["frames"] > 0
