"""The port's pipeline CLI (haff_tpu_torch.pipeline.cli, --device cpu)
against haff_tpu.pipeline.cli in its three modes: a frame tree
(--frames_dir, with --flip_augment), a raw clip (--video) and an EPIC
frame tar (--epic, through a file:// URL). The shards are equal: every h5
dataset and every json byte for byte; the port's AffDataset reads them."""

import os
import sys
import tarfile

import cv2
import numpy as np
import pytest
import torch

from haff_tpu.pipeline import cli as jcli
from haff_tpu_torch.data.aff_dataset import AffDataset
from haff_tpu_torch.pipeline import cli as tcli

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_pipeline import assert_same_shards  # noqa: E402

H, W = 64, 64
BOXES = {"hand_left.png": (28, 36, 20, 28), "hand_right.png": (28, 36, 36, 44),
         "object.png": (24, 40, 24, 40)}


def _frame(shift=0):
    img = np.full((H, W, 3), 40, np.uint8)
    img[24:40, 24 + shift:40 + shift] = 220
    img[28:36, 20:28] = 140
    img[28:36, 36:44] = 160
    return img


def _write_masks(d, shift=0, skip=()):
    for name, (y0, y1, x0, x1) in BOXES.items():
        if name in skip:
            continue
        m = np.zeros((H, W), np.uint8)
        m[y0:y1, x0 + (shift if name == "object.png" else 0):
          x1 + (shift if name == "object.png" else 0)] = 255
        cv2.imwrite(os.path.join(d, name), m)


def _seeds(tmp_path, narration):
    seeds = tmp_path / "seeds"
    seeds.mkdir()
    _write_masks(str(seeds))
    (seeds / "annotation.json").write_text(
        '{"narration": "%s", "taxonomy3": [0.0, 1.0, 0.0]}' % narration)
    return str(seeds)


def _both(tmp_path, args):
    """Run both CLIs with `args` + their own --out_dir; returns the dirs."""
    outs = []
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"out_{name}")
        main(args + ["--out_dir", out] + extra)
        outs.append(out)
    return outs


def test_frames_dir_with_flip_augment_equals_jax(tmp_path):
    """Four sequences (one without a right hand, one with a filtered
    narration), packed in shards of 2, then their mirrored copies."""
    import json

    root = tmp_path / "frames"
    specs = [("cut onion", [0, 1, 0], 0, ()),
             ("open jar", [1, 0, 0], 2, ("hand_right.png",)),
             ("eat apple", [0, 0, 1], 0, ()),
             ("stir pot", [0, 0, 1], -2, ())]
    for i, (narr, tax, shift, skip) in enumerate(specs):
        d = root / f"seq{i:02d}"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "frame.png"),
                    cv2.cvtColor(_frame(shift), cv2.COLOR_RGB2BGR))
        _write_masks(str(d), shift, skip)
        (d / "annotation.json").write_text(json.dumps(
            {"narration": narr, "taxonomy3": tax}))
    jax_out, torch_out = _both(tmp_path, [
        "--frames_dir", str(root), "--shard_size", "2", "--dilate", "3",
        "--flip_augment", "--shard_name", "P09"])
    assert_same_shards(torch_out, jax_out)
    names = sorted(os.listdir(os.path.join(torch_out, "h5")))
    assert any(n.startswith("0-") for n in names)
    assert any("flipped_P09" in n for n in names)
    ds = AffDataset(torch_out, samples_per_epoch=2, seed=0)
    assert ds.get(0).image.shape[2] == 3


def test_video_mode_equals_jax(tmp_path):
    frames = np.stack([_frame(s) for s in (0, 1, 2, 3, 4, 5)])
    vid = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    np.testing.assert_array_equal(tcli.acquire_video(vid, stride=2),
                                  jcli.acquire_video(vid, stride=2))
    jax_out, torch_out = _both(tmp_path, [
        "--video", vid, "--seeds_dir", _seeds(tmp_path, "cut onion"),
        "--shard_size", "4", "--dilate", "3", "--max_frames", "5"])
    assert_same_shards(torch_out, jax_out)
    assert "cut onion" in AffDataset(torch_out, samples_per_epoch=2,
                                     seed=0).get(0).question


def test_epic_mode_equals_jax(tmp_path):
    src = tmp_path / "srv"
    src.mkdir()
    for i in range(4):
        cv2.imwrite(str(src / f"frame_{i:010d}.jpg"),
                    cv2.cvtColor(_frame(i % 2), cv2.COLOR_RGB2BGR))
    with tarfile.open(src / "P07_04.tar", "w") as tf:
        for i in range(4):
            tf.add(str(src / f"frame_{i:010d}.jpg"),
                   arcname=f"frame_{i:010d}.jpg")
    seeds = _seeds(tmp_path, "peel carrot")
    outs = []
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"out_{name}")
        main(["--epic", "P07", "P07_04", "--data_dir",
              str(tmp_path / f"EPIC_{name}"), "--epic_base_url", src.as_uri(),
              "--seeds_dir", seeds, "--out_dir", out, "--shard_size", "8",
              "--dilate", "3"] + extra)
        outs.append(out)
    assert_same_shards(outs[1], outs[0])
    # acquisition only: no device, no output dir; the directory exists, so
    # a dead mirror is never asked
    tcli.main(["--epic", "P07", "P07_04", "--data_dir",
               str(tmp_path / "EPIC_torch"), "--epic_base_url",
               "file:///nonexistent"])


def test_cli_without_a_card_raises_no_cuda_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "frames").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--frames_dir", str(tmp_path / "frames"), "--out_dir",
                   str(tmp_path / "out")])
