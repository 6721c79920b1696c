"""Benchmark-walker folder -> 2HANDS training shards (port of
haff_tpu/tools/bench_to_shards.py; host-side, the same code over the
port's AffDatasetVal and pipeline/orchestrate.py).

Reads an ActAffordance benchmark directory (the AffDatasetVal layout:
<vid>/<frame>/{inpainting.png, aff_left.png, aff_right.png,
annotation.json} — reference ActAffordance/data_zipped) and packs it
into the 2HANDS training shard layout consumed by AffDataset
(h5 data/{inpainted, narration, taxonomy, ...} + contour jsons —
reference 2HANDS create_dataset.py:116-238). The reference has no such
bridge because its train and val corpora are produced by separate
pipelines; here it lets the SAME real frames drive both the trainer and
the validator — the basis of the "training actually learns"
overfit demonstration (reference train_ds.py:451-486 saves on val-IoU
improvement, which presumes the stack can learn at all).

Frames in a benchmark folder are per-frame crops with DIFFERENT sizes;
h5 packing needs one uniform canvas. Every image/mask is padded
bottom/right to the max (H, W) over the set, which keeps pixel
coordinates (and therefore contours) unchanged.

Usage:
    python -m haff_tpu_torch.tools.bench_to_shards \
        --benchmark_dir B --out_dir shards [--shard_name P14_05]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np


def benchmark_to_shards(benchmark_dir: str, out_dir: str,
                        shard_name: str = "VAL",
                        shard_size: int = 64,
                        balance_taxonomy: bool = False) -> int:
    """Pack every mask-bearing frame under benchmark_dir into training
    shards at out_dir. Returns the number of frames packed."""
    import cv2

    from ..data.aff_dataset import AffDatasetVal
    from ..pipeline.orchestrate import FrameRecord, pack_shard

    # Frame discovery through the SAME walker the validator uses
    # (AffDatasetVal, require_masks=True) so the trainer-side bridge and
    # the validation walk can never accept different frame sets; only
    # the LOADING differs (raw-grayscale mask resize below vs the
    # walker's binarize-at-native).
    entries = [e["dir"] for e in
               AffDatasetVal(benchmark_dir, require_masks=True).entries]
    if not entries:
        return 0

    def load(fdir):
        img = cv2.cvtColor(cv2.imread(os.path.join(fdir, "inpainting.png")),
                           cv2.COLOR_BGR2RGB)
        with open(os.path.join(fdir, "annotation.json")) as f:
            ann = json.load(f)

        def mask(name) -> Optional[np.ndarray]:
            p = os.path.join(fdir, name)
            if not os.path.exists(p):
                return None
            m = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            if m.shape != img.shape[:2]:
                # Benchmark GT masks live on the square FRAME canvas
                # (855x855) while inpainting.png is that canvas resized
                # to the crop size; bring the RAW mask onto the image
                # grid before binarizing (the calculate_iou.py:212-234
                # resize-then-binarize convention, in reverse).
                m = cv2.resize(m, (img.shape[1], img.shape[0]))
            return (m > 0).astype(np.uint8)

        return img, ann, mask("aff_left.png"), mask("aff_right.png")

    loaded = [load(f) for f in entries]
    H = max(im.shape[0] for im, _, _, _ in loaded)
    W = max(im.shape[1] for im, _, _, _ in loaded)

    def pad(a: Optional[np.ndarray]) -> Optional[np.ndarray]:
        if a is None:
            return None
        spec = ((0, H - a.shape[0]), (0, W - a.shape[1])) + (
            ((0, 0),) * (a.ndim - 2))
        return np.pad(a, spec)

    records: List[FrameRecord] = []
    for img, ann, ml, mr in loaded:
        records.append(FrameRecord(
            inpainted=pad(img), narration=str(ann.get("narration", "")),
            # Missing-taxonomy default matches AffDatasetVal's ([0]*4)
            # so the trainer and validator never disagree about a
            # shared frame's label.
            taxonomy=[float(x) for x in ann.get("taxonomy",
                                                [0, 0, 0, 0])],
            aff_left=pad(ml), aff_right=pad(mr)))

    if balance_taxonomy and records:
        # Oversample minority taxonomy classes to near-uniform so the
        # (double-softmax, low-gradient) taxonomy head doesn't collapse
        # to the majority class under uniform random draws — observed
        # in overfit runs: 7 right / 2 left / 2 asym frames
        # trained to tax=argmax 1 everywhere, zeroing both left-hand
        # frames' masks at validation.
        by_class = {}
        for r in records:
            by_class.setdefault(tuple(r.taxonomy), []).append(r)
        target = max(len(v) for v in by_class.values())
        balanced = []
        for cls, rs in sorted(by_class.items()):
            reps = -(-target // len(rs))
            balanced.extend((rs * reps)[:target])
        records = balanced

    n = 0
    for start in range(0, len(records), shard_size):
        chunk = records[start:start + shard_size]
        pack_shard(chunk, out_dir, start_index=start,
                   shard_name=f"{shard_name}_{start}")
        n += len(chunk)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--benchmark_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--shard_name", default="VAL")
    p.add_argument("--shard_size", type=int, default=64)
    p.add_argument("--balance_taxonomy", action="store_true")
    args = p.parse_args(argv)
    n = benchmark_to_shards(args.benchmark_dir, args.out_dir,
                            args.shard_name, args.shard_size,
                            balance_taxonomy=args.balance_taxonomy)
    print(f"packed {n} frames into {args.out_dir}")


if __name__ == "__main__":
    main()
