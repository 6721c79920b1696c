"""Benchmark metrics: IoU, IoCM (precision), Hausdorff, threshold mAP
(port of haff_tpu/eval/metrics.py: the same numpy, cv2 and scipy calls, so
the numbers are equal).

Capability parity with reference ActAffordance/scripts/evaluation/
calculate_iou.py:9-114 and 2Haff/train_ds.py:761-813. All metrics operate
on the left|right UNION of binary masks, like the reference evaluator.

Reference conventions mirrored exactly:
  * IoU with empty union is 0.0 (a failed prediction, calculate_iou.py:40)
    — NOT 1.0.
  * Hausdorff uses the FIRST external contour of each mask
    (RETR_EXTERNAL + CHAIN_APPROX_SIMPLE, contours[0] — calculate_iou.py:
    11-19); an empty PREDICTION is penalized with the image diagonal, an
    empty GT scores (0, 0) (calculate_iou.py:13-17).
  * The threshold-sweep summary is mean IoCM ("mean average precision")
    with the best threshold selected by IoCM (calculate_iou.py:312-334).

Batched variants (suffix `_batch`) are torch functions on tensors, on
whatever device the masks lie; the host versions mirror the reference's
numpy/cv2 semantics for the offline benchmark protocol.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary mask IoU; empty union scores 0.0 (reference
    calculate_iou.py:26-41, train_ds.py:796)."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    return float(inter / union) if union != 0 else 0.0


def iocm(pred: np.ndarray, gt: np.ndarray) -> float:
    """Intersection over Comparison (= predicted) Mask — the reference's
    'Precision' (calculate_iou.py:96-114)."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    inter = np.logical_and(pred, gt).sum()
    area = pred.sum()
    return float(inter / area) if area != 0 else 0.0


def _first_external_contour(mask: np.ndarray) -> Optional[np.ndarray]:
    """Reference calculate_iou.py:11-19: RETR_EXTERNAL +
    CHAIN_APPROX_SIMPLE, FIRST contour only."""
    import cv2

    contours, _ = cv2.findContours(mask.astype(np.uint8),
                                   cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    pts = np.vstack(contours[0]).squeeze()
    if pts.ndim == 1:
        pts = pts[None, :]
    return pts


def directed_hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    """max over points of a of distance to nearest point of b."""
    from scipy.spatial import cKDTree

    tree = cKDTree(b)
    d, _ = tree.query(a, k=1)
    return float(np.max(d))


def hausdorff(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(directed pred->gt, symmetric) contour Hausdorff (reference
    calculate_iou.py:9-24). Empty prediction -> diagonal penalty on both;
    empty GT -> (0, 0)."""
    pg = _first_external_contour(gt)
    pp = _first_external_contour(pred)
    if pp is None:
        diag = float(np.sqrt(pred.shape[0] ** 2 + pred.shape[1] ** 2))
        return diag, diag
    if pg is None:
        return 0.0, 0.0
    d_pg = directed_hausdorff(pp, pg)
    d_gp = directed_hausdorff(pg, pp)
    return d_pg, max(d_pg, d_gp)


def union_metrics(pred_left, pred_right, gt_left, gt_right):
    """Metrics on the left|right unions (reference
    calculate_iou.py:237-270)."""
    pred = np.logical_or(pred_left.astype(bool), pred_right.astype(bool))
    gt = np.logical_or(gt_left.astype(bool), gt_right.astype(bool))
    d, s = hausdorff(pred, gt)
    return dict(iou=iou(pred, gt), iocm=iocm(pred, gt), hausdorff=d,
                hausdorff_sym=s)


def threshold_sweep(pred_logits_left, pred_logits_right, gt_left, gt_right,
                    thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.5, 0.7)):
    """Per-threshold metrics over sigmoid probabilities + the reference's
    sweep summary (inference.py:197 sweep + calculate_iou.py:312-334:
    mAP = mean IoCM across thresholds, best threshold by IoCM)."""
    probs_l = 1.0 / (1.0 + np.exp(-pred_logits_left.astype(np.float64)))
    probs_r = 1.0 / (1.0 + np.exp(-pred_logits_right.astype(np.float64)))
    per = {}
    for th in thresholds:
        per[th] = union_metrics(probs_l > th, probs_r > th, gt_left,
                                gt_right)
    best_th = max(per, key=lambda t: per[t]["iocm"])
    return dict(per_threshold=per,
                map_precision=float(np.mean([m["iocm"]
                                             for m in per.values()])),
                best_threshold=best_th,
                best_iocm=per[best_th]["iocm"],
                best_iou=per[best_th]["iou"])


# ------------------------------ batched (torch) ------------------------------

def iou_batch(pred, gt):
    """pred/gt: (B, H, W) binary tensors. Returns (B,) float32 IoU; empty
    union scores 0.0 like the reference (train_ds.py:796)."""
    import torch

    p, g = pred.bool(), gt.bool()
    inter = (p & g).sum(dim=(1, 2)).float()
    union = (p | g).sum(dim=(1, 2)).float()
    return torch.where(union == 0, torch.zeros_like(union),
                       inter / union.clamp(min=1))


def iocm_batch(pred, gt):
    """pred/gt: (B, H, W) binary tensors. Returns (B,) float32 IoCM; an
    empty prediction scores 0.0."""
    import torch

    p, g = pred.bool(), gt.bool()
    inter = (p & g).sum(dim=(1, 2)).float()
    area = p.sum(dim=(1, 2)).float()
    return torch.where(area == 0, torch.zeros_like(area),
                       inter / area.clamp(min=1))
