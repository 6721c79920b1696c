"""The port's benchmark tooling (haff_tpu_torch/eval/tools.py) against
haff_tpu/eval/tools.py: each function runs on its own copy of the same
seeded folders, and the two trees that come out are equal file for file
(PNGs pixel for pixel, JSON as parsed), as are the returned counts and
arrays."""

import json
import os
import shutil

import cv2
import numpy as np
import pytest

from haff_tpu.eval import tools as J
from haff_tpu_torch.eval import tools as T


def _tree(root):
    """{relative path: contents} of every file under root (images decoded
    unchanged, JSON parsed)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".png"):
                out[rel] = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            elif f.endswith(".json"):
                with open(p) as fh:
                    out[rel] = json.load(fh)
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for k in tb:
        if isinstance(tb[k], np.ndarray):
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        else:
            assert ta[k] == tb[k], k


def _both(tmp_path, build, run):
    """Build the input folders once, copy them for each package, run
    `run(module, root)` in each; returns (port result, JAX result, port
    root, JAX root)."""
    src = tmp_path / "src"
    src.mkdir()
    build(str(src))
    roots = []
    for name in ("t", "j"):
        shutil.copytree(str(src), str(tmp_path / name))
        roots.append(str(tmp_path / name))
    got = run(T, roots[0])
    want = run(J, roots[1])
    return got, want, roots[0], roots[1]


RNG = np.random.RandomState(0)
IMG = RNG.randint(0, 255, (48, 64, 3)).astype(np.uint8)


def _mask(h, w, box):
    m = np.zeros((h, w), np.uint8)
    y0, y1, x0, x1 = box
    m[y0:y1, x0:x1] = 255
    return m


def test_video_and_frames_to_benchmark(tmp_path):
    vid = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for i in range(5):
        vw.write(np.roll(IMG, 3 * i, axis=1))
    vw.release()

    def run(mod, root):
        return (mod.video_to_frames(vid, os.path.join(root, "v"), "cut onion",
                                    stride=2),
                mod.frames_to_benchmark([IMG, IMG[::-1]],
                                        os.path.join(root, "f"), "open jar"))

    got, want, a, b = _both(tmp_path, lambda r: None, run)
    assert got == want == (3, 2)
    assert_same_tree(a, b)


@pytest.mark.parametrize("ksize,sigma", [(15, 0.0), (5, 1.5)])
def test_gaussian_restore_crop_overlay(ksize, sigma):
    m = _mask(40, 40, (5, 30, 8, 20)).astype(np.float32)
    np.testing.assert_array_equal(T.gaussian_postprocess(m, ksize, sigma),
                                  J.gaussian_postprocess(m, ksize, sigma))
    np.testing.assert_array_equal(T.gaussian_postprocess(m / 255.0),
                                  J.gaussian_postprocess(m / 255.0))
    box = (10, 6, 50, 40)
    np.testing.assert_array_equal(T.restore_padding(m > 0, box, (60, 70)),
                                  J.restore_padding(m > 0, box, (60, 70)))
    for b, size in ((box, 64), ((0, 0, 30, 48), 40), ((20, 0, 40, 20), 33)):
        np.testing.assert_array_equal(T.crop_and_pad_frame(IMG, b, size),
                                      J.crop_and_pad_frame(IMG, b, size))
    ml = _mask(48, 64, (0, 20, 0, 30)) > 0
    np.testing.assert_array_equal(T.overlay_results(IMG, ml, ~ml, 0.4),
                                  J.overlay_results(IMG, ml, ~ml, 0.4))


def test_join_and_external_affordances(tmp_path):
    def build(root):
        for frame in ("0000012", "0000013", "0000020"):
            d = os.path.join(root, "bench", frame)
            os.makedirs(d)
            cv2.imwrite(os.path.join(d, "inpainted_frame.png"), IMG)
            with open(os.path.join(d, "annotation.json"), "w") as f:
                json.dump({"narration": frame}, f)
        for frame in ("12", "13", "99"):
            d = os.path.join(root, "pred", frame)
            os.makedirs(d)
            cv2.imwrite(os.path.join(d, "aff_left.png"),
                        _mask(48, 64, (1, 9, 2, 7)))
        for hand in ("left", "right"):
            d = os.path.join(root, "flat", hand)
            os.makedirs(d)
            for frame in ("0000012", "0000020", "0000077"):
                cv2.imwrite(os.path.join(d, f"{frame}.png"),
                            _mask(48, 64, (3, 5, 3, 9)))
        os.makedirs(os.path.join(root, "mirror", "0000013"))
        cv2.imwrite(os.path.join(root, "mirror", "0000013", "aff_right.png"),
                    _mask(48, 64, (0, 4, 0, 4)))

    def run(mod, root):
        j = lambda p: os.path.join(root, p)  # noqa: E731
        return (mod.join_prediction_folders(j("pred"), j("bench"), j("joined")),
                mod.add_external_affordances(j("bench"), j("flat"), j("ext")),
                mod.add_external_affordances(j("bench"), j("mirror"), j("ext")),
                mod.add_external_affordances(j("bench"), j("flat"), j("ext")))

    got, want, a, b = _both(tmp_path, build, run)
    assert got == want and got[0] == 2 and got[1] == 4
    assert_same_tree(a, b)


def test_benchmark_assembly(tmp_path):
    """rename, insert inpainting (channel reversal), copy annotations,
    target-box json, object masks (top/left square padding), cropped
    annotations with and without cropping the images."""
    def build(root):
        frames = os.path.join(root, "frames")
        for name in ("12", "0000007", "x"):
            os.makedirs(os.path.join(frames, name))
        src = os.path.join(root, "inpaint")
        os.makedirs(src)
        for name in ("0000012", "0000007", "0000044"):
            cv2.imwrite(os.path.join(src, f"{name}.png"),
                        np.roll(IMG, int(name), axis=0))
        ann = os.path.join(root, "ann")
        for name in ("0000012", "0000007"):
            os.makedirs(os.path.join(ann, name))
            with open(os.path.join(ann, name, "annotation.json"), "w") as f:
                json.dump({"narration": f"n{name}", "taxonomy": [1, 0, 0, 0]},
                          f)
        obj = os.path.join(root, "obj")
        for hand, box in (("left", (4, 20, 6, 30)), ("right", (10, 40, 30, 60))):
            os.makedirs(os.path.join(obj, hand))
            for name in ("0000012", "0000007", "0000099"):
                cv2.imwrite(os.path.join(obj, hand, f"{name}.png"),
                            _mask(48, 64, box))
        os.makedirs(os.path.join(obj, "left_tall"))
        cv2.imwrite(os.path.join(obj, "left_tall", "t.png"),
                    _mask(64, 40, (1, 2, 3, 4)))

    def run(mod, root):
        j = lambda p: os.path.join(root, p)  # noqa: E731
        frames = j("frames")
        counts = [mod.rename_frames_7digit(frames),
                  mod.insert_inpainting_frames(frames, j("inpaint")),
                  mod.copy_annotations(frames, j("ann")),
                  mod.add_object_masks(frames, j("obj")),
                  mod.copy_json_with_target_box(
                      os.path.join(frames, "0000007", "annotation.json"),
                      j("boxed/a.json"), (1.0, 2, 3.7, 4)),
                  mod.copy_json_with_target_box(j("missing.json"),
                                                j("boxed/b.json"), (0, 0, 1, 1)),
                  mod.assemble_cropped_annotations(frames, j("cropped"),
                                                   offset=5),
                  mod.assemble_cropped_annotations(frames, j("cropped_img"),
                                                   offset=3, crop_images=True)]
        tall = mod._pad_to_square_topleft(cv2.imread(
            j("obj/left_tall/t.png"), cv2.IMREAD_GRAYSCALE))
        return counts, tall

    (got, tall_t), (want, tall_j), a, b = _both(tmp_path, build, run)
    assert got == want
    assert got[:4] == [1, 2, 2, 4] and got[6] == got[7] == 2
    np.testing.assert_array_equal(tall_t, tall_j)
    assert tall_t.shape == (64, 64)
    assert_same_tree(a, b)
