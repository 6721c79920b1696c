"""Automatic mask generation: point-grid proposals -> NMS -> RLE (port of
haff_tpu/infer/amg.py; numpy on the host).

A regular point grid prompts the decoder in batches (one decode for a
whole batch of points), predictions are filtered by IoU score and
stability, deduplicated with box NMS, and returned as uncompressed RLE +
bbox + area records (reference segment_anything
automatic_mask_generator.py + utils/amg.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) normalized [0,1] grid points (reference amg.py)."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(side, side)
    return np.stack([xs.ravel(), ys.ravel()], axis=-1)


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary mask -> uncompressed column-major COCO RLE (reference
    amg.py mask_to_rle_pytorch)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [h * w]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def mask_to_box(mask: np.ndarray) -> List[int]:
    """Inclusive XYXY [x0, y0, xmax, ymax] (reference
    amg.py batched_mask_to_box)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return [0, 0, 0, 0]
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def box_xyxy_to_xywh(box: List[int]) -> List[int]:
    """Reference amg.py box_xyxy_to_xywh: records carry XYWH."""
    x0, y0, x1, y1 = box
    return [x0, y0, x1 - x0, y1 - y0]


def box_iou(a, b) -> float:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix = max(0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    union = ((ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0)
             - inter)
    return inter / union if union else 0.0


def nms(records: List[Dict], iou_thresh: float) -> List[Dict]:
    """Greedy box NMS on the internal XYXY boxes; the public bbox field
    stays XYWH like the reference's output records."""
    records = sorted(records, key=lambda r: -r["predicted_iou"])
    kept: List[Dict] = []
    for r in records:
        if all(box_iou(r["_bbox_xyxy"], k["_bbox_xyxy"]) < iou_thresh
               for k in kept):
            kept.append(r)
    for r in kept:
        r.pop("_bbox_xyxy", None)
    return kept


def stability_score(logits: np.ndarray, offset: float = 1.0) -> float:
    """IoU between masks thresholded at 0 +- offset (reference
    amg.py calculate_stability_score)."""
    hi = (logits > offset).sum()
    lo = (logits > -offset).sum()
    return float(hi / lo) if lo else 0.0


class AutomaticMaskGenerator:
    """Drives a SamPredictor-style model over a point grid.

    decode_batch(points (N, 2) canvas px) -> mask logits (N, n_out, H, W)
    and iou scores (N, n_out) is supplied by the caller (see
    from_predictor), so the whole grid runs as a few batched decodes.
    """

    def __init__(self, decode_batch, points_per_side: int = 32,
                 pred_iou_thresh: float = 0.88,
                 stability_thresh: float = 0.95,
                 box_nms_thresh: float = 0.7, batch: int = 64):
        self.decode_batch = decode_batch
        self.grid = build_point_grid(points_per_side)
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_thresh = stability_thresh
        self.box_nms_thresh = box_nms_thresh
        self.batch = batch

    def generate(self, image_hw) -> List[Dict]:
        h, w = image_hw
        pts = self.grid * np.array([w, h])
        records: List[Dict] = []
        for s in range(0, len(pts), self.batch):
            chunk = pts[s:s + self.batch]
            pad = self.batch - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)])
            logits, ious = self.decode_batch(chunk)
            logits = np.asarray(logits)[:len(pts[s:s + self.batch])]
            ious = np.asarray(ious)[:len(logits)]
            for i in range(len(logits)):
                for j in range(logits.shape[1]):
                    iou = float(ious[i, j])
                    if iou < self.pred_iou_thresh:
                        continue
                    stab = stability_score(logits[i, j])
                    if stab < self.stability_thresh:
                        continue
                    mask = logits[i, j] > 0
                    if not mask.any():
                        continue
                    box = mask_to_box(mask)
                    records.append(dict(
                        segmentation=mask_to_rle(mask),
                        bbox=box_xyxy_to_xywh(box),
                        _bbox_xyxy=box,
                        area=int(mask.sum()),
                        predicted_iou=iou,
                        stability_score=stab,
                        point_coords=[pts[s + i].tolist()]))
        return nms(records, self.box_nms_thresh)


def from_predictor(predictor, hand: str = "left",
                   **kwargs) -> AutomaticMaskGenerator:
    """Build an AMG over infer/sam_predictor.SamPredictor (set_image
    first). All grid points share the cached image embedding, and each
    batch is one decode (SamPredictor.predict_batch, the reference's
    points_per_batch batching)."""

    def decode_batch(points):
        logits, ious, _ = predictor.predict_batch(
            np.asarray(points, np.float32)[:, None, :],
            multimask_output=True, return_logits=True, hand=hand)
        return np.asarray(logits, np.float32), np.asarray(ious)

    return AutomaticMaskGenerator(decode_batch, **kwargs)
