"""ActAffordance benchmark evaluator (port of haff_tpu/eval/benchmark.py;
numpy, cv2 and scipy, the same calls, so the numbers are equal).

Capability parity with reference ActAffordance/scripts/evaluation/
calculate_iou.py: walks benchmark vs comparison folder trees
(<vid>/<frame>/aff_{left,right}.png), evaluates IoU / IoCM / Hausdorff on
the left|right unions, supports the --map threshold-folder sweep
(reporting mean-precision mAP + best-by-IoCM threshold), the
--intersection mode (AND predictions with GT object masks), --only
ego|epic filtering, and overlay visualization output.

Reference protocol details mirrored exactly (calculate_iou.py:117-334):
  * Masks binarize at > 0; predictions are resized to the evaluation
    shape from RAW grayscale with cv2's default bilinear interpolation
    BEFORE binarizing.
  * The evaluation shape is 855x855 unless --cropped, which uses each
    frame's inpainting.png dimensions (calculate_iou.py:138-139,181-184).
  * A frame with NO ground-truth masks or NO prediction masks is
    SKIPPED (excluded from the mean's denominator), not scored 0.
  * --intersection skips frames whose obj masks are missing or
    shape-mismatched (calculate_iou.py:212-234); the AND runs on raw
    grayscale before binarization.
  * --only epic keeps <vid> starting with 'P'; ego keeps the rest.
  * --map enumerates the per-threshold SUBFOLDERS of --comparison_dir
    (calculate_iou.py:128) and falls back to '<comparison_dir><th>'
    sibling dirs (the layout infer.cli writes); mAP = mean IoCM across
    thresholds, best threshold by IoCM (calculate_iou.py:312-334).

Usage: python -m haff_tpu_torch.eval.benchmark --benchmark_dir B --comparison_dir C
       [--map --thresholds 0.1 0.2 ...] [--intersection] [--only ego|epic]
       [--vis_dir V] [--cropped]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from .metrics import union_metrics


def _load_gray(path: str) -> Optional[np.ndarray]:
    import cv2

    if not os.path.exists(path):
        return None
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def _is_epic(vid: str) -> bool:
    # Reference calculate_iou.py:123-126: EPIC ids start with 'P'.
    return vid.startswith("P")


def iter_frames(benchmark_dir: str, only: Optional[str] = None):
    for vid in sorted(os.listdir(benchmark_dir)):
        vdir = os.path.join(benchmark_dir, vid)
        if not os.path.isdir(vdir):
            continue
        if only == "epic" and not _is_epic(vid):
            continue
        if only == "ego" and _is_epic(vid):
            continue
        for frame in sorted(os.listdir(vdir)):
            fdir = os.path.join(vdir, frame)
            if os.path.isdir(fdir):
                yield vid, frame, fdir


def _frame_masks(fdir: str, cdir: str, eval_shape, intersection: bool):
    """Load one frame's GT + prediction unions per the reference
    protocol. Returns (gt_l, gt_r, pr_l, pr_r) binary arrays or None if
    the frame must be skipped."""
    import cv2

    gt_l_raw = _load_gray(os.path.join(fdir, "aff_left.png"))
    gt_r_raw = _load_gray(os.path.join(fdir, "aff_right.png"))
    if gt_l_raw is None and gt_r_raw is None:
        return None            # no GT -> calculate_iou returns None
    pr_l_raw = _load_gray(os.path.join(cdir, "aff_left.png"))
    pr_r_raw = _load_gray(os.path.join(cdir, "aff_right.png"))
    if pr_l_raw is None and pr_r_raw is None:
        return None            # no prediction -> skipped, not zero

    size_wh = (eval_shape[1], eval_shape[0])

    def prep_pred(raw):
        if raw is None:
            return None
        raw = cv2.resize(raw, size_wh)      # raw grayscale, bilinear
        if intersection:
            return raw                       # AND happens pre-binarize
        return (raw > 0).astype(np.uint8)

    pr_l = prep_pred(pr_l_raw)
    pr_r = prep_pred(pr_r_raw)

    if intersection:
        # Reference calculate_iou.py:212-234: missing or mismatched obj
        # masks skip the WHOLE frame; bitwise_and on raw grayscale.
        for side, pr in (("left", pr_l), ("right", pr_r)):
            if pr is None:
                continue
            obj = _load_gray(os.path.join(fdir, f"obj_{side}.png"))
            if obj is None or obj.shape != pr.shape:
                return None
            if side == "left":
                pr_l = cv2.bitwise_and(pr, obj)
            else:
                pr_r = cv2.bitwise_and(pr, obj)
        pr_l = None if pr_l is None else (pr_l > 0).astype(np.uint8)
        pr_r = None if pr_r is None else (pr_r > 0).astype(np.uint8)

    gt_l = None if gt_l_raw is None else (gt_l_raw > 0).astype(np.uint8)
    gt_r = None if gt_r_raw is None else (gt_r_raw > 0).astype(np.uint8)
    gt_shape = (gt_l if gt_l is not None else gt_r).shape
    gt_l = gt_l if gt_l is not None else np.zeros(gt_shape, np.uint8)
    gt_r = gt_r if gt_r is not None else np.zeros(gt_shape, np.uint8)
    pr_shape = (pr_l if pr_l is not None else pr_r).shape
    pr_l = pr_l if pr_l is not None else np.zeros(pr_shape, np.uint8)
    pr_r = pr_r if pr_r is not None else np.zeros(pr_shape, np.uint8)
    if gt_shape != pr_shape:
        # The reference would raise on the union; treat as a skip with a
        # contract note (benchmark GT is prepared at the eval shape).
        return None
    return gt_l, gt_r, pr_l, pr_r


def evaluate_folder(benchmark_dir: str, comparison_dir: str,
                    only: Optional[str] = None, intersection: bool = False,
                    default_size=(855, 855), cropped: bool = False,
                    vis_dir: Optional[str] = None) -> Dict:
    """One comparison folder vs the benchmark; returns mean metrics."""
    import cv2

    per_frame: List[Dict] = []
    failed = 0
    for vid, frame, fdir in iter_frames(benchmark_dir, only):
        cdir = os.path.join(comparison_dir, vid, frame)
        if not os.path.isdir(cdir):
            continue
        eval_shape = tuple(default_size)
        if cropped:
            inp = _load_gray(os.path.join(fdir, "inpainting.png"))
            if inp is not None:
                eval_shape = inp.shape[:2]
        loaded = _frame_masks(fdir, cdir, eval_shape, intersection)
        if loaded is None:
            continue
        gt_l, gt_r, pr_l, pr_r = loaded

        m = union_metrics(pr_l, pr_r, gt_l, gt_r)
        if m["iou"] == 0 and m["iocm"] == 0:
            failed += 1        # reference zero_count
        m.update(vid=vid, frame=frame)
        per_frame.append(m)

        if vis_dir:
            os.makedirs(os.path.join(vis_dir, vid), exist_ok=True)
            overlay = np.zeros(gt_l.shape + (3,), np.uint8)
            overlay[..., 2] = gt_l * 120 + gt_r * 120   # GT red
            overlay[..., 1] = (pr_l | pr_r) * 160        # pred green
            cv2.imwrite(os.path.join(vis_dir, vid, f"{frame}.png"),
                        overlay)

    if not per_frame:
        return dict(iou=0.0, iocm=0.0, hausdorff=0.0, hausdorff_sym=0.0,
                    frames=0, failed=0)
    mean = lambda k: float(np.mean([f[k] for f in per_frame]))  # noqa: E731
    return dict(iou=mean("iou"), iocm=mean("iocm"),
                hausdorff=mean("hausdorff"),
                hausdorff_sym=mean("hausdorff_sym"),
                frames=len(per_frame), failed=failed,
                per_frame=per_frame)


def _threshold_dirs(comparison_base: str, thresholds) -> Dict[str, str]:
    """--map layouts: (a) per-threshold SUBFOLDERS of comparison_base
    (reference calculate_iou.py:128 listdir), else (b) sibling dirs
    '<base><th>' as written by infer.cli's threshold sweep."""
    out = {}
    if os.path.isdir(comparison_base):
        for name in sorted(os.listdir(comparison_base)):
            sub = os.path.join(comparison_base, name)
            if os.path.isdir(sub) and any(
                    os.path.isdir(os.path.join(sub, v))
                    for v in os.listdir(sub)):
                out[name] = sub
    if not out:
        for th in thresholds:
            cdir = f"{comparison_base}{th}"
            if os.path.isdir(cdir):
                out[str(th)] = cdir
    return out


def evaluate_map(benchmark_dir: str, comparison_base: str,
                 thresholds=(0.1, 0.2, 0.3, 0.5, 0.7), **kw) -> Dict:
    """--map mode (reference calculate_iou.py:127-130, 312-334): sweep
    the per-threshold folders; mAP = mean IoCM ('mean average
    precision'), best threshold selected by IoCM."""
    per_th = {}
    for label, cdir in _threshold_dirs(comparison_base, thresholds).items():
        r = evaluate_folder(benchmark_dir, cdir, **kw)
        r.pop("per_frame", None)
        if r["frames"]:
            per_th[label] = r
    if not per_th:
        return dict(per_threshold={}, map_precision=0.0, best=None)
    best_th = max(per_th, key=lambda t: per_th[t]["iocm"])
    return dict(per_threshold=per_th,
                map_precision=float(np.mean(
                    [r["iocm"] for r in per_th.values()])),
                best_threshold=best_th, best=per_th[best_th])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--benchmark_dir", required=True)
    p.add_argument("--comparison_dir", required=True)
    p.add_argument("--map", action="store_true", dest="map_mode")
    p.add_argument("--thresholds", type=float, nargs="+",
                   default=[0.1, 0.2, 0.3, 0.5, 0.7])
    p.add_argument("--intersection", action="store_true")
    p.add_argument("--only", choices=["ego", "epic"], default=None)
    p.add_argument("--cropped", action="store_true")
    p.add_argument("--vis_dir", default=None)
    args = p.parse_args(argv)

    if args.map_mode:
        out = evaluate_map(args.benchmark_dir, args.comparison_dir,
                           tuple(args.thresholds), only=args.only,
                           intersection=args.intersection,
                           cropped=args.cropped)
    else:
        out = evaluate_folder(args.benchmark_dir, args.comparison_dir,
                              only=args.only,
                              intersection=args.intersection,
                              cropped=args.cropped, vis_dir=args.vis_dir)
        out.pop("per_frame", None)
    print(json.dumps(out, indent=2, default=float))


if __name__ == "__main__":
    main()
