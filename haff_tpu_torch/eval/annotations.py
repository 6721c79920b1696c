"""Benchmark annotation extraction (port of haff_tpu/eval/annotations.py;
numpy and cv2, the same calls, so the masks are equal).

Capability parity with reference ActAffordance/notebooks/
extract_masks.ipynb (TORAS polygon annotations -> left/right masks via
shapely+cairo) and the coco_anns.json export — implemented as plain
library code (cv2 polygon fill; COCO polygon segmentation and
uncompressed RLE decoded natively, no pycocotools)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def polygons_to_mask(polygons: Sequence[Sequence[float]],
                     shape: Tuple[int, int]) -> np.ndarray:
    """COCO-style flat [x0, y0, x1, y1, ...] polygon lists -> binary
    mask."""
    import cv2

    mask = np.zeros(shape, np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def rle_to_mask(rle: Dict, shape: Optional[Tuple[int, int]] = None
                ) -> np.ndarray:
    """Uncompressed COCO RLE ({'counts': [...], 'size': [h, w]}; column-
    major runs starting with background) -> binary mask."""
    h, w = rle.get("size", shape)
    counts = rle["counts"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def coco_annotation_to_mask(ann: Dict,
                            shape: Tuple[int, int]) -> np.ndarray:
    seg = ann.get("segmentation")
    if isinstance(seg, dict):
        return rle_to_mask(seg, shape)
    return polygons_to_mask(seg, shape)


def extract_toras_masks(toras_json: str, out_dir: str,
                        default_shape: Tuple[int, int] = (855, 855)) -> int:
    """TORAS export -> per-frame aff_left.png/aff_right.png in the
    benchmark folder layout. Accepts entries shaped
    {image|frame, (vid), polygons: {left: [...], right: [...]}} or a list
    of {label: left|right, points: [[x, y], ...]} shapes."""
    import cv2

    with open(toras_json) as f:
        data = json.load(f)
    entries = data if isinstance(data, list) else data.get(
        "annotations", data.get("entries", []))
    n = 0
    for e in entries:
        name = str(e.get("image") or e.get("frame") or e.get("id"))
        vid = str(e.get("vid") or e.get("video") or "toras")
        h, w = e.get("size", default_shape)
        fdir = os.path.join(out_dir, vid, f"{int(name):07d}"
                            if name.isdigit() else name)
        os.makedirs(fdir, exist_ok=True)
        masks = {"left": np.zeros((h, w), np.uint8),
                 "right": np.zeros((h, w), np.uint8)}
        if "polygons" in e:
            for side in ("left", "right"):
                polys = e["polygons"].get(side, [])
                if polys:
                    masks[side] = polygons_to_mask(polys, (h, w))
        else:
            for shp in e.get("shapes", []):
                side = "left" if "left" in str(shp.get("label", "")).lower() \
                    else "right"
                pts = np.asarray(shp["points"], np.float64).reshape(-1)
                masks[side] |= polygons_to_mask([pts], (h, w))
        for side in ("left", "right"):
            if masks[side].any():
                cv2.imwrite(os.path.join(fdir, f"aff_{side}.png"),
                            masks[side] * 255)
        n += 1
    return n


def extract_coco_masks(coco_json: str, out_dir: str) -> int:
    """coco_anns.json -> benchmark mask folders (images + annotations
    keyed by image_id; category name containing left/right selects the
    hand)."""
    import cv2

    with open(coco_json) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco.get("images", [])}
    cats = {c["id"]: c.get("name", "") for c in coco.get("categories", [])}
    n = 0
    for ann in coco.get("annotations", []):
        im = images.get(ann["image_id"])
        if im is None:
            continue
        shape = (im["height"], im["width"])
        mask = coco_annotation_to_mask(ann, shape)
        name = os.path.splitext(os.path.basename(
            im.get("file_name", str(im["id"]))))[0]
        vid = im.get("video", "coco")
        side = "left" if "left" in cats.get(
            ann.get("category_id"), "").lower() else "right"
        fdir = os.path.join(out_dir, vid, name)
        os.makedirs(fdir, exist_ok=True)
        path = os.path.join(fdir, f"aff_{side}.png")
        if os.path.exists(path):
            old = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            mask = ((old > 127) | (mask > 0)).astype(np.uint8)
        cv2.imwrite(path, mask * 255)
        n += 1
    return n
