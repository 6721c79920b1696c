"""ActAffordance benchmark tooling (port of haff_tpu/eval/tools.py;
host-side, the same numpy and cv2 code; `crop_and_pad_frame` pads with the
pipeline's `pad_to_square` on tensors).

Capability parity with reference ActAffordance/scripts/data_processing/*
and scripts/utils/*:

  * video_to_frames      — video clip -> per-frame <vid>/<frame>/
                           {inpainting.png, annotation.json{narration}}
                           folders (preprocess_video.py:7-50)
  * gaussian_postprocess — Gaussian blur + 0.5 threshold of predicted
                           masks (utils/gaussian.py:8-33)
  * restore_padding      — un-crop predictions back to the full canvas
                           using annotation target_box
                           (utils/restore_image_padding.py:9-46)
  * crop_and_pad_frame   — benchmark image crop + square pad
                           (configure_bench.py:245-317)
  * overlay_results      — red=left / blue=right qualitative overlays
                           (show_lab_results.py:6-89)
  * rename_frames        — 7-digit frame ids (configure_bench.py:9-28)
  * the benchmark assembly of configure_bench.py:30-317
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np


def video_to_frames(video_path: str, out_dir: str, narration: str,
                    vid: Optional[str] = None, stride: int = 1) -> int:
    """Explode a clip into per-frame benchmark folders. Returns frame
    count."""
    import cv2

    vid = vid or os.path.splitext(os.path.basename(video_path))[0]
    cap = cv2.VideoCapture(video_path)
    n = 0
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            fdir = os.path.join(out_dir, vid, f"{idx:07d}")
            os.makedirs(fdir, exist_ok=True)
            cv2.imwrite(os.path.join(fdir, "inpainting.png"), frame)
            with open(os.path.join(fdir, "annotation.json"), "w") as f:
                json.dump({"narration": narration}, f)
            n += 1
        idx += 1
    cap.release()
    return n


def frames_to_benchmark(frames: Sequence[np.ndarray], out_dir: str,
                        narration: str, vid: str = "clip") -> int:
    """In-memory RGB frames -> the same folder protocol."""
    import cv2

    for idx, frame in enumerate(frames):
        fdir = os.path.join(out_dir, vid, f"{idx:07d}")
        os.makedirs(fdir, exist_ok=True)
        cv2.imwrite(os.path.join(fdir, "inpainting.png"),
                    cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2BGR))
        with open(os.path.join(fdir, "annotation.json"), "w") as f:
            json.dump({"narration": narration}, f)
    return len(frames)


def gaussian_postprocess(mask: np.ndarray, ksize: int = 15,
                         sigma: float = 0.0,
                         threshold: float = 0.5) -> np.ndarray:
    """Blur + threshold (reference utils/gaussian.py:8-33)."""
    import cv2

    m = np.asarray(mask, np.float32)
    if m.max() > 1:
        m = m / 255.0
    blurred = cv2.GaussianBlur(m, (ksize, ksize), sigma)
    return (blurred > threshold).astype(np.uint8) * 255


def restore_padding(mask: np.ndarray, target_box: Sequence[int],
                    canvas: Tuple[int, int] = (850, 850)) -> np.ndarray:
    """Place a cropped prediction back onto the full canvas at
    target_box = [x0, y0, x1, y1] (reference
    utils/restore_image_padding.py:9-46)."""
    import cv2

    x0, y0, x1, y1 = [int(v) for v in target_box]
    out = np.zeros(canvas, np.uint8)
    region = cv2.resize(np.asarray(mask, np.uint8),
                        (x1 - x0, y1 - y0),
                        interpolation=cv2.INTER_NEAREST)
    out[y0:y1, x0:x1] = region
    return out


def crop_and_pad_frame(image: np.ndarray, target_box: Sequence[int],
                       out_size: int = 855) -> np.ndarray:
    """Crop to the target box, pad to square, resize (reference
    configure_bench.py:245-317)."""
    import cv2
    import torch

    from ..pipeline.ops import pad_to_square

    x0, y0, x1, y1 = [int(v) for v in target_box]
    crop = np.ascontiguousarray(np.asarray(image)[y0:y1, x0:x1])
    sq = pad_to_square(torch.from_numpy(crop)[None])[0].numpy()
    return cv2.resize(sq, (out_size, out_size),
                      interpolation=cv2.INTER_LINEAR)


def overlay_results(image: np.ndarray, mask_left: Optional[np.ndarray],
                    mask_right: Optional[np.ndarray],
                    alpha: float = 0.5) -> np.ndarray:
    """Qualitative overlay: red = left hand, blue = right hand (reference
    show_lab_results.py:6-89, chat.py save path). RGB uint8 in/out."""
    out = np.asarray(image, np.float32).copy()
    if mask_left is not None:
        m = np.asarray(mask_left, bool)
        out[m] = out[m] * (1 - alpha) + np.array([255.0, 0, 0]) * alpha
    if mask_right is not None:
        m = np.asarray(mask_right, bool)
        out[m] = out[m] * (1 - alpha) + np.array([0, 0, 255.0]) * alpha
    return out.astype(np.uint8)


def join_prediction_folders(pred_dir: str, bench_dir: str,
                            out_dir: str) -> int:
    """Join a baseline method's per-frame prediction folders with the
    benchmark's frame folders into one scoreable layout (reference
    prepare_folders.py:1-67). Frame ids are matched leading-zero-
    insensitively; the output keeps pred_dir's folder names. Copies
    aff_left.png / aff_right.png from pred_dir and inpainted_frame.png /
    annotation.json from bench_dir. Returns the number of joined
    frames."""
    import shutil

    def key(name):
        return name.lstrip("0") or "0"

    bench = {key(n): n for n in os.listdir(bench_dir)
             if os.path.isdir(os.path.join(bench_dir, n))}
    n_joined = 0
    for name in sorted(os.listdir(pred_dir)):
        src = os.path.join(pred_dir, name)
        if not os.path.isdir(src) or key(name) not in bench:
            continue
        bsrc = os.path.join(bench_dir, bench[key(name)])
        dst = os.path.join(out_dir, name)
        os.makedirs(dst, exist_ok=True)
        for fname, root in (("aff_left.png", src), ("aff_right.png", src),
                            ("inpainted_frame.png", bsrc),
                            ("annotation.json", bsrc)):
            fsrc = os.path.join(root, fname)
            if os.path.exists(fsrc):
                shutil.copy(fsrc, dst)
            elif root == bsrc:
                print(f"Warning: {fsrc} does not exist")
        n_joined += 1
    return n_joined


def add_external_affordances(bench_dir: str, masks_dir: str,
                             out_dir: str) -> int:
    """Bring an external method's affordance masks into the benchmark
    layout as aff_left.png / aff_right.png (reference add_affex.py:1-107).

    Two input layouts are accepted, mirroring the reference:
      1. masks_dir/{left,right}/<frame>.png   (flat per-hand folders)
      2. masks_dir/<frame>/aff_{left,right}.png (mirrors bench_dir)
    Only frames that exist in bench_dir are taken; existing outputs are
    never overwritten. Returns the number of files copied."""
    import shutil

    copied = 0

    def place(src, frame, hand):
        nonlocal copied
        if not os.path.isdir(os.path.join(bench_dir, frame)):
            return
        dst_dir = os.path.join(out_dir, frame)
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, f"aff_{hand}.png")
        if not os.path.exists(dst):
            shutil.copy(src, dst)
            copied += 1

    left_dir = os.path.join(masks_dir, "left")
    right_dir = os.path.join(masks_dir, "right")
    if os.path.isdir(left_dir) and os.path.isdir(right_dir):
        for hand, hdir in (("left", left_dir), ("right", right_dir)):
            for fname in sorted(os.listdir(hdir)):
                if fname.endswith(".png"):
                    place(os.path.join(hdir, fname),
                          fname.split(".")[0], hand)
    else:
        for frame in sorted(os.listdir(bench_dir)):
            msub = os.path.join(masks_dir, frame)
            if not os.path.isdir(msub):
                continue
            for hand in ("left", "right"):
                src = os.path.join(msub, f"aff_{hand}.png")
                if os.path.exists(src):
                    place(src, frame, hand)
    return copied


def rename_frames_7digit(vid_dir: str) -> int:
    """Normalize frame folder names to 7-digit ids (reference
    configure_bench.py:9-28)."""
    n = 0
    for name in sorted(os.listdir(vid_dir)):
        src = os.path.join(vid_dir, name)
        if not os.path.isdir(src) or not name.isdigit():
            continue
        dst = os.path.join(vid_dir, f"{int(name):07d}")
        if src != dst:
            os.rename(src, dst)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Benchmark assembly (reference configure_bench.py:30-243 — the steps
# that build the <vid>/<frame>/ benchmark layout from raw folders)
# ---------------------------------------------------------------------------

def insert_inpainting_frames(frame_dir: str, source_dir: str) -> int:
    """Copy '<id>.png' from a flat source dir into the matching
    '<frame_dir>/<id>/inpainting.png', reversing the color channels
    exactly like the reference (configure_bench.py add_inpainting:30-62
    reads BGR then does img[:, :, ::-1] before writing). Returns the
    number of frames inserted."""
    import cv2

    n = 0
    for fname in sorted(os.listdir(source_dir)):
        if not fname.endswith(".png"):
            continue
        base = fname.split(".")[0]
        fdir = os.path.join(frame_dir, base)
        if not os.path.isdir(fdir):
            continue
        img = cv2.imread(os.path.join(source_dir, fname))
        if img is None:
            continue
        cv2.imwrite(os.path.join(fdir, "inpainting.png"), img[:, :, ::-1])
        n += 1
    return n


def copy_annotations(frame_dir: str, annotation_dir: str) -> int:
    """Copy '<annotation_dir>/<id>/annotation.json' into the matching
    frame folder (configure_bench.py add_annotations:129-155)."""
    import shutil

    n = 0
    for folder in sorted(os.listdir(annotation_dir)):
        src = os.path.join(annotation_dir, folder, "annotation.json")
        dst_dir = os.path.join(frame_dir, folder)
        if os.path.isfile(src) and os.path.isdir(dst_dir):
            shutil.copy(src, os.path.join(dst_dir, "annotation.json"))
            n += 1
    return n


def copy_json_with_target_box(source_path: str, destination_path: str,
                              target_box: Sequence[int]) -> bool:
    """Copy an annotation json adding an int 'target_box'
    [x0, y0, x1, y1] field (configure_bench.py:93-127)."""
    try:
        with open(source_path) as f:
            data = json.load(f)
        data["target_box"] = [int(v) for v in target_box]
        os.makedirs(os.path.dirname(destination_path), exist_ok=True)
        with open(destination_path, "w") as f:
            json.dump(data, f, indent=4)
        return True
    except (OSError, json.JSONDecodeError):
        return False


def _pad_to_square_topleft(mask: np.ndarray) -> np.ndarray:
    """Pad a 2-d mask square: left pad when taller, top pad when wider
    (configure_bench.py pad_to_square:64-91 — note this pads the
    OPPOSITE sides from the model's bottom/right input padding)."""
    h, w = mask.shape
    if h > w:
        return np.pad(mask, ((0, 0), (h - w, 0)))
    if w > h:
        return np.pad(mask, ((w - h, 0), (0, 0)))
    return mask


def add_object_masks(frame_dir: str, object_dir: str) -> int:
    """'<object_dir>/{left,right}/<id>.png' -> square-padded
    '<frame_dir>/<id>/obj_{left,right}.png'
    (configure_bench.py add_objects:157-182)."""
    import cv2

    frames = set(os.listdir(frame_dir))
    n = 0
    for hand in ("left", "right"):
        hdir = os.path.join(object_dir, hand)
        if not os.path.isdir(hdir):
            continue
        for fname in sorted(os.listdir(hdir)):
            base = fname.split(".")[0]
            if base not in frames:
                continue
            mask = cv2.imread(os.path.join(hdir, fname),
                              cv2.IMREAD_GRAYSCALE)
            if mask is None:
                continue
            cv2.imwrite(
                os.path.join(frame_dir, base, f"obj_{hand}.png"),
                _pad_to_square_topleft(mask))
            n += 1
    return n


def _mask_bbox(mask: np.ndarray):
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    if len(xs) == 0:
        return None
    return (int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))


def _merge_boxes(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), min(a[1], b[1]),
            max(a[2], b[2]), max(a[3], b[3]))


def assemble_cropped_annotations(bench_dir: str, out_dir: str,
                                 offset: int = 50,
                                 crop_images: bool = False) -> int:
    """Build the cropped-benchmark annotation layout: per leaf frame
    folder, merge the obj_left/obj_right mask bounding boxes, grow by
    `offset` clamped to the mask shape, and write annotation.json with
    the merged 'target_box' into the mirrored out_dir tree
    (configure_bench.py crop_and_save_images:245-317). With
    crop_images=True also crop every PNG (except bench_frame_overlay)
    to the box after resizing to the mask shape — the step the
    reference ran to produce its data_zipped 'cropped/' images (left
    commented in the checked-in script). Returns frames processed."""
    import cv2

    n = 0
    for root, dirs, files in sorted(os.walk(bench_dir)):
        if any(os.path.isdir(os.path.join(root, d)) for d in dirs):
            continue
        shape = None
        box = None
        for hand in ("left", "right"):
            p = os.path.join(root, f"obj_{hand}.png")
            if os.path.exists(p):
                m = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
                if m is not None:
                    box = _merge_boxes(box, _mask_bbox(m))
                    shape = m.shape
        if box is None or shape is None:
            continue
        h, w = shape
        x0 = max(box[0] - offset, 0)
        y0 = max(box[1] - offset, 0)
        x1 = min(box[2] + offset, w)
        y1 = min(box[3] + offset, h)
        rel = os.path.relpath(root, bench_dir)
        out_leaf = os.path.join(out_dir, rel)
        ann = os.path.join(root, "annotation.json")
        if os.path.exists(ann):
            copy_json_with_target_box(
                ann, os.path.join(out_leaf, "annotation.json"),
                (x0, y0, x1, y1))
        if crop_images:
            os.makedirs(out_leaf, exist_ok=True)
            for fname in files:
                if (not fname.endswith(".png")
                        or fname == "bench_frame_overlay.png"):
                    continue
                img = cv2.imread(os.path.join(root, fname),
                                 cv2.IMREAD_UNCHANGED)
                if img is None:
                    continue
                if img.shape[:2] != (h, w):
                    # target_box is in the SQUARE-PADDED mask canvas
                    # (add_object_masks pads top/left), so non-square
                    # images must be padded the same way, not resized —
                    # the reference's commented-out crop resizes
                    # (configure_bench.py:287) which stretches
                    # non-square frames out of register with the box.
                    ih, iw = img.shape[:2]
                    pt, pl_ = max(h - ih, 0), max(w - iw, 0)
                    pad_spec = ((pt, 0), (pl_, 0)) + (((0, 0),)
                                                      * (img.ndim - 2))
                    # Pad top/left and, for OVERSIZED frames, keep the
                    # bottom-right h x w window — the same anchoring as
                    # the pad, so content stays registered with the
                    # target_box either way.
                    img = np.pad(img, pad_spec)[-h:, -w:]
                cv2.imwrite(os.path.join(out_leaf, fname),
                            img[y0:y1, x0:x1])
        n += 1
    return n
