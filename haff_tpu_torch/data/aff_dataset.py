"""2HANDS affordance dataset readers (port of haff_tpu/data/aff_dataset.py;
h5py, cv2 and numpy, the same calls and the same `np.random.RandomState`
draws as the JAX package, so samples are byte-equal for a seed).

* `AffDataset`: local `{h5/, jsons/}` shards: h5 keys
  data/{inpainted, narration, taxonomy}, shard filenames
  "start-end_name.h5" carrying index ranges, masks stored as OpenCV
  contour lists in the json shards and rasterized per sample at the
  shards' `original_size` (reference aff_dataset.py:48-346). A path that
  is no local directory and looks like a repo id is read from the hub
  (sjauhri/2HANDS), which needs the `datasets` package and the network.
  `__getitem__` ignores its index and draws one uniformly, as the
  reference's does (aff_dataset.py:198-200).
* `AffDatasetVal`: the benchmark folder walker,
  <vid>/<frame>/{inpainting.png, aff_left.png, aff_right.png,
  annotation.json}, the missing hand zero-filled.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from .collate import Sample
from .prompts import ANSWER_LIST, SHORT_QUESTION_LIST


def rasterize_contours(contours, shape) -> np.ndarray:
    """OpenCV contour lists -> binary mask (reference
    aff_dataset.py:340-346)."""
    import cv2

    mask = np.zeros(tuple(shape), np.uint8)
    for contour in contours:
        cv2.drawContours(mask, [np.asarray(contour, np.int32)], -1, 1,
                         thickness=cv2.FILLED)
    return mask


def _extract_leading_number(filename: str) -> int:
    m = re.search(r"(\d+)", filename)
    return int(m.group(1)) if m else 1 << 62


class AffDataset:
    """Training dataset over 2HANDS shards."""

    def __init__(self, base_dir: str, samples_per_epoch: int = 10000,
                 seed: int = 0, inference: bool = False):
        self.samples_per_epoch = samples_per_epoch
        self.inference = inference
        self.rng = np.random.RandomState(seed)
        self.use_hf = "/" in base_dir and not os.path.exists(base_dir)
        if self.use_hf:
            self._load_hf(base_dir)
        else:
            self._load_local(base_dir)

    # ----- loading -----

    def _load_local(self, base_dir: str):
        import h5py

        self.h5_dir = os.path.join(base_dir, "h5")
        json_dir = os.path.join(base_dir, "jsons")
        self.h5_names = sorted(
            [f for f in os.listdir(self.h5_dir) if f.endswith(".h5")],
            key=_extract_leading_number)
        json_names = sorted(
            [f for f in os.listdir(json_dir) if f.endswith(".json")],
            key=_extract_leading_number)

        # Shard index ranges from "start-end_*.h5" filenames.
        self.ranges: List[Tuple[int, int, str]] = []
        total = 0
        for f in self.h5_names:
            m = re.match(r"(\d+)-(\d+)_", f)
            if m:
                start, end = int(m.group(1)), int(m.group(2))
            else:
                with h5py.File(os.path.join(self.h5_dir, f), "r") as h:
                    n = h["data"]["inpainted"].shape[0]
                start, end = total, total + n - 1
            self.ranges.append((start, end, f))
            total = max(total, end + 1)

        self.original_size = None
        self.masks_left: List = []
        self.masks_right: List = []
        for fname in json_names:
            with open(os.path.join(json_dir, fname)) as f:
                data = json.load(f)
            if self.original_size is None and data:
                first = data[sorted(data, key=lambda k: int(k))[0]]
                self.original_size = first["original_size"]
            for key in sorted(data, key=lambda k: int(k)):
                entry = data[key]
                self.masks_left.append(entry.get("aff_left", []))
                self.masks_right.append(entry.get("aff_right", []))
        self.size = total
        self.hf_data = None

    def _load_hf(self, name: str):
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise ImportError(
                f"{name!r} is no local directory, so it is read as a hub "
                "dataset id, which needs the `datasets` package (and the "
                "network); pass a local 2HANDS shard folder (h5/ + jsons/) "
                "instead") from e

        ds = load_dataset(name, split="train")
        self.hf_data = list(ds)
        self.masks_left, self.masks_right = [], []
        self.original_size = None
        for item in self.hf_data:
            masks = item.get("masks", {})
            if self.original_size is None and "original_size" in masks:
                self.original_size = masks["original_size"]
            self.masks_left.append(masks.get("aff_left", []))
            self.masks_right.append(masks.get("aff_right", []))
        self.size = len(self.hf_data)

    # ----- access -----

    def _read_h5(self, index: int):
        import h5py

        for start, end, fname in self.ranges:
            if start <= index <= end:
                with h5py.File(os.path.join(self.h5_dir, fname), "r") as h:
                    data = h["data"]
                    adj = index - start
                    narration = data["narration"][adj]
                    image = data["inpainted"][adj]
                    taxonomy = data["taxonomy"][adj]
                return narration, image, taxonomy
        raise IndexError(index)

    def __len__(self):
        return self.samples_per_epoch

    def get(self, index: int) -> Sample:
        if self.hf_data is not None:
            # Schema fallbacks mirror the reference's
            # _extract_from_hf_dataset (aff_dataset.py:286-300):
            # narration|text, inpainted|image, taxonomy optional.
            item = self.hf_data[index]
            narration = item.get("narration", item.get("text", ""))
            img_src = item.get("inpainted", item.get("image"))
            if img_src is None:
                raise KeyError(
                    f"hub item {index} has neither 'inpainted' nor "
                    f"'image' (keys: {sorted(item)})")
            image = np.asarray(img_src)
            taxonomy = np.asarray(
                item.get("taxonomy", [0.0, 0.0, 1.0, 0.0]), np.float32)
        else:
            narration, image, taxonomy = self._read_h5(index)
            image = np.asarray(image)
            taxonomy = np.asarray(taxonomy, np.float32)
        if isinstance(narration, bytes):
            narration = narration.decode("utf-8")
        shape = self.original_size or image.shape[:2]
        mask_l = rasterize_contours(self.masks_left[index], shape)
        mask_r = rasterize_contours(self.masks_right[index], shape)

        q = self.rng.choice(SHORT_QUESTION_LIST).format(
            class_name=str(narration).lower())
        a = self.rng.choice(ANSWER_LIST)
        return Sample(image=image, question=q, answer=a, mask_left=mask_l,
                      mask_right=mask_r, taxonomy=taxonomy)

    def __getitem__(self, idx) -> Sample:
        # Uniform random draw, matching reference aff_dataset.py:198-200.
        return self.get(int(self.rng.randint(0, self.size)))


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
