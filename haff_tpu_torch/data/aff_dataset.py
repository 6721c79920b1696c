"""2HANDS benchmark folder reader (port of haff_tpu/data/aff_dataset.py:
`AffDatasetVal` and `rasterize_contours`; cv2 and numpy, the same calls
as the JAX package, so the arrays are equal).

`AffDatasetVal` walks <vid>/<frame>/{inpainting.png, aff_left.png,
aff_right.png, annotation.json}, the missing hand zero-filled. The
training reader `AffDataset` (h5 shards and the hub) is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from .collate import Sample


def rasterize_contours(contours, shape) -> np.ndarray:
    """OpenCV contour lists -> binary mask (reference
    aff_dataset.py:340-346)."""
    import cv2

    mask = np.zeros(tuple(shape), np.uint8)
    for contour in contours:
        cv2.drawContours(mask, [np.asarray(contour, np.int32)], -1, 1,
                         thickness=cv2.FILLED)
    return mask


class AffDatasetVal:
    """Benchmark folder walker (reference aff_dataset.py:350-544).

    require_masks=True mirrors the reference VALIDATION walker, which
    skips frames missing BOTH aff masks (aff_dataset.py:506); the
    inference CLI passes False (reference inference.py needs only
    inpainting + annotation — it writes predictions, not metrics).

    style="validate" builds the training-style prompt (random SHORT
    template, lowercased narration — aff_dataset.py:234-238);
    style="inference" uses the benchmark prompt with ORIGINAL casing
    (inference.py:221-226, no lowercase)."""

    def __init__(self, benchmark_dir: str, require_masks: bool = True,
                 style: str = "validate", seed: int = 0):
        assert style in ("validate", "inference")
        self.style = style
        self.rng = np.random.RandomState(seed)
        self.entries: List[Dict] = []
        for vid in sorted(os.listdir(benchmark_dir)):
            vdir = os.path.join(benchmark_dir, vid)
            if not os.path.isdir(vdir):
                continue
            for frame in sorted(os.listdir(vdir)):
                fdir = os.path.join(vdir, frame)
                img = os.path.join(fdir, "inpainting.png")
                ann = os.path.join(fdir, "annotation.json")
                if not (os.path.exists(img) and os.path.exists(ann)):
                    continue
                if require_masks and not (
                        os.path.exists(os.path.join(fdir, "aff_left.png"))
                        or os.path.exists(
                            os.path.join(fdir, "aff_right.png"))):
                    continue
                self.entries.append(dict(vid=vid, frame=frame, dir=fdir))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx) -> Tuple[Sample, Dict]:
        import cv2

        e = self.entries[idx]
        img = cv2.cvtColor(cv2.imread(os.path.join(e["dir"],
                                                   "inpainting.png")),
                           cv2.COLOR_BGR2RGB)
        with open(os.path.join(e["dir"], "annotation.json")) as f:
            ann = json.load(f)
        narration = ann.get("narration", "")

        def load_mask(name):
            p = os.path.join(e["dir"], name)
            if os.path.exists(p):
                m = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
                return (m > 0).astype(np.uint8)
            return np.zeros(img.shape[:2], np.uint8)  # missing hand -> 0

        from .prompts import INFERENCE_QUESTION, SHORT_QUESTION_LIST

        if self.style == "inference":
            # Reference inference.py keeps the narration's casing.
            q = INFERENCE_QUESTION.format(class_name=str(narration))
        else:
            q = str(self.rng.choice(SHORT_QUESTION_LIST)).format(
                class_name=str(narration).lower())
        sample = Sample(image=img, question=q, answer=None,
                        mask_left=load_mask("aff_left.png"),
                        mask_right=load_mask("aff_right.png"),
                        taxonomy=np.asarray(
                            ann.get("taxonomy", [0, 0, 0, 0]), np.float32))
        return sample, e
