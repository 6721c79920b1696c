"""Semantic- and referring-segmentation pretraining corpora (port of
haff_tpu/data/seg_datasets.py; numpy and cv2, the same draws from the
same seeded generators, so samples are byte-equal).

Capability parity with reference utils/sem_seg_dataset.py (ADE20K /
COCO-Stuff style: image + per-pixel class-id annotation, sample a
present class, ask to segment it) and utils/refer_seg_dataset.py +
refer.py/grefer.py (refclef/refcoco/+/g: COCO-format instances + refs
with natural-language sentences).

Like extra_datasets.py, both emit the unified Sample contract (single
mask on the LEFT decoder, taxonomy [1,0,0,0]) so the one static-shape
collate and model serve every corpus.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .collate import Sample
from .prompts import ANSWER_LIST

# Reference utils/utils.py:14-23 SHORT_QUESTION_LIST (all 4 templates).
SEG_QUESTION_LIST = [
    "<image>\nCan you segment the {class_name} in this image?",
    "<image>\nPlease segment the {class_name} in this image.",
    "<image>\nWhat is {class_name} in this image? Please respond with "
    "segmentation mask.",
    "<image>\nWhat is {class_name} in this image? Please output "
    "segmentation mask.",
]


class SemSegDataset:
    """Images + class-id annotation PNGs + class-name list (ADE20K-style
    layout: images/<name>.jpg, annotations/<name>.png)."""

    def __init__(self, base_dir: str, classes: Sequence[str],
                 image_subdir: str = "images",
                 ann_subdir: str = "annotations", seed: int = 0,
                 ignore_label: int = 255, label_transform=None,
                 image_paths: Optional[Sequence[str]] = None,
                 label_paths: Optional[Sequence[str]] = None):
        """`label_transform` applies per-dataset label quirks (ADE20K
        id shift, COCO-Stuff hyphen drop — see the init_* adapters).
        `image_paths`/`label_paths` override the layout walk for
        corpora whose labels live in a parallel tree (COCO-Stuff,
        Mapillary)."""
        self.classes = list(classes)
        self.ignore_label = ignore_label
        self.label_transform = label_transform
        if image_paths is not None:
            self.images = list(image_paths)
            self.labels = list(label_paths)
        else:
            self.images = sorted(
                glob.glob(os.path.join(base_dir, image_subdir, "*.jpg"))
                + glob.glob(os.path.join(base_dir, image_subdir, "*.png")))
            ann_dir = os.path.join(base_dir, ann_subdir)
            self.labels = [
                os.path.join(ann_dir, os.path.splitext(
                    os.path.basename(p))[0] + ".png")
                for p in self.images]
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.images)

    def get(self, idx: int, class_id: Optional[int] = None) -> Sample:
        import cv2

        img_path = self.images[idx]
        image = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        ann = cv2.imread(self.labels[idx], cv2.IMREAD_GRAYSCALE)
        if self.label_transform is not None:
            ann = self.label_transform(ann)
        present = [c for c in np.unique(ann)
                   if c != self.ignore_label and c < len(self.classes)]
        if class_id is None:
            class_id = int(self.rng.choice(present)) if present else 0
        mask = (ann == class_id).astype(np.uint8)
        name = self.classes[class_id]
        q = self.rng.choice(SEG_QUESTION_LIST).format(class_name=name)
        return Sample(image=image, question=q, answer=str(self.rng.choice(ANSWER_LIST)),
                      mask_left=mask, mask_right=None,
                      taxonomy=np.asarray([1, 0, 0, 0], np.float32))

    def __getitem__(self, idx) -> Sample:
        return self.get(int(self.rng.randint(0, len(self.images))))


class Refer:
    """Minimal REFER-style API over refs(<split>).json + instances.json
    (reference utils/refer.py surface: getRefIds/loadRefs/getMask).
    Also covers the gRefCOCO generalization (reference utils/grefer.py):
    `ann_id` may be a LIST (multi-target refs — masks are unioned) or
    empty/None/-1 (no-target refs — an all-zero mask)."""

    def __init__(self, refs_json: str, instances_json: str):
        with open(refs_json) as f:
            self.refs = json.load(f)
        with open(instances_json) as f:
            inst = json.load(f)
        self.anns = {a["id"]: a for a in inst["annotations"]}
        self.imgs = {im["id"]: im for im in inst["images"]}

    def get_ref_ids(self, split: Optional[str] = None) -> List[int]:
        return [r["ref_id"] for r in self.refs
                if split is None or r.get("split") == split]

    def load_ref(self, ref_id: int) -> Dict:
        return next(r for r in self.refs if r["ref_id"] == ref_id)

    def get_mask(self, ref: Dict) -> np.ndarray:
        from ..eval.annotations import coco_annotation_to_mask

        im = self.imgs[ref["image_id"]]
        shape = (im["height"], im["width"])
        ann_ids = ref.get("ann_id")
        if not isinstance(ann_ids, list):
            ann_ids = [ann_ids]
        mask = np.zeros(shape, np.uint8)
        for aid in ann_ids:
            if aid in (None, -1, "") or aid not in self.anns:
                continue  # no-target component (gRefCOCO)
            mask |= coco_annotation_to_mask(self.anns[aid], shape)
        return mask

    def image_file(self, ref: Dict) -> str:
        return self.imgs[ref["image_id"]]["file_name"]


class ReferSegDataset:
    """Referring segmentation over a REFER corpus (reference
    utils/refer_seg_dataset.py)."""

    def __init__(self, refs_json: str, instances_json: str,
                 image_dir: str, split: str = "train", seed: int = 0):
        self.refer = Refer(refs_json, instances_json)
        self.ref_ids = self.refer.get_ref_ids(split) or \
            self.refer.get_ref_ids(None)
        self.image_dir = image_dir
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.ref_ids)

    def get(self, idx: int) -> Sample:
        import cv2

        ref = self.refer.load_ref(self.ref_ids[idx])
        image = cv2.cvtColor(
            cv2.imread(os.path.join(self.image_dir,
                                    self.refer.image_file(ref))),
            cv2.COLOR_BGR2RGB)
        mask = self.refer.get_mask(ref)
        sent = self.rng.choice(
            [s["sent"] if isinstance(s, dict) else s
             for s in ref["sentences"]])
        q = self.rng.choice(SEG_QUESTION_LIST).format(class_name=sent)
        return Sample(image=image, question=q, answer=str(self.rng.choice(ANSWER_LIST)),
                      mask_left=mask.astype(np.uint8), mask_right=None,
                      taxonomy=np.asarray([1, 0, 0, 0], np.float32))

    def __getitem__(self, idx) -> Sample:
        return self.get(int(self.rng.randint(0, len(self.ref_ids))))


# ---------------------------------------------------------------------------
# Per-dataset adapters (reference utils/sem_seg_dataset.py init_* walkers +
# the per-dataset label quirks from its __getitem__).
# ---------------------------------------------------------------------------

def init_ade20k(base_image_dir: str, classes_json: Optional[str] = None):
    """ADE20K layout (reference init_ade20k, sem_seg_dataset.py:39-67):
    images under ade20k/images/training/*.jpg, labels .png under
    annotations. Returns (classes, image_paths, label_paths)."""
    root = os.path.join(base_image_dir, "ade20k")
    cj = classes_json or os.path.join(root, "ade20k_classes.json")
    with open(cj) as f:
        classes = json.load(f)
    img_dir = os.path.join(root, "images", "training")
    images = sorted(
        os.path.join(img_dir, x) for x in os.listdir(img_dir)
        if x.endswith(".jpg"))
    labels = [x.replace(".jpg", ".png").replace("images", "annotations")
              for x in images]
    return list(classes), images, labels


def ade20k_label_transform(label: np.ndarray) -> np.ndarray:
    """ADE20K stores class_id+1 with 0 = unlabeled (reference
    sem_seg_dataset.py:245-248): 0 -> ignore, shift ids by -1; original
    255 pixels (254 after the shift) are ignore too."""
    label = label.astype(np.int32).copy()
    label[label == 0] = 256
    label -= 1          # former 0 -> 255 (ignore); former 255 -> 254
    label[label == 254] = 255
    return label


def init_cocostuff(base_image_dir: str, classes_txt: Optional[str] = None):
    """COCO-Stuff layout (reference init_cocostuff): labels
    cocostuff/train2017/*.png; images in the parallel coco/ tree. The
    classes file is 'id: name' lines with a header row."""
    root = os.path.join(base_image_dir, "cocostuff")
    ct = classes_txt or os.path.join(root, "cocostuff_classes.txt")
    classes = []
    with open(ct) as f:
        for line in f.readlines()[1:]:
            classes.append(line.strip().split(": ")[-1])
    labels = sorted(glob.glob(os.path.join(root, "train2017", "*.png")))
    images = [x.replace(".png", ".jpg").replace("cocostuff", "coco")
              for x in labels]
    return classes, images, labels


def make_cocostuff_label_transform(classes: Sequence[str]):
    """Hyphenated COCO-Stuff classes ('wall-brick', 'food-other') are
    dropped to ignore (reference sem_seg_dataset.py:249-252)."""
    drop = [i for i, c in enumerate(classes) if "-" in c]

    def transform(label: np.ndarray) -> np.ndarray:
        label = label.astype(np.int32).copy()
        for i in drop:
            label[label == i] = 255
        return label

    return transform


def init_mapillary(base_image_dir: str):
    """Mapillary Vistas v2.0 layout (reference init_mapillary):
    config_v2.0.json 'labels'[*].readable lowercased; labels under
    training/v2.0/labels/*.png with the parallel images/ tree."""
    root = os.path.join(base_image_dir, "mapillary")
    with open(os.path.join(root, "config_v2.0.json")) as f:
        classes = [x["readable"].lower() for x in json.load(f)["labels"]]
    labels = sorted(glob.glob(
        os.path.join(root, "training", "v2.0", "labels", "*.png")))
    images = [x.replace(".png", ".jpg").replace("v2.0/labels", "images")
              for x in labels]
    return classes, images, labels


def part_name_phrases(raw_name: str) -> List[str]:
    """PACO-LVIS / Pascal-Part category names are 'obj:part' (with
    optional '_(...)' suffixes); the reference phrases them either
    'obj part' or 'the part of the obj' at random
    (sem_seg_dataset.py:226-236). Plain names pass through."""
    parts = raw_name.strip().split(":")
    if len(parts) == 1:
        return [parts[0].split("_(")[0]]
    obj, part = (p.split("_(")[0] for p in parts)
    return [f"{obj} {part}", f"the {part} of the {obj}"]


class PartSegDataset:
    """COCO-format part segmentation (PACO-LVIS / Pascal-Part; reference
    init_paco_lvis/init_pascal_part + the tuple-name branch). Needs only
    the annotation json — masks come from the in-repo polygon/RLE
    rasterizer, no pycocotools."""

    def __init__(self, annotations_json: str, image_dir: str,
                 seed: int = 0):
        with open(annotations_json) as f:
            coco = json.load(f)
        self.cat_names = {c["id"]: c["name"] for c in coco["categories"]}
        self.imgs = {im["id"]: im for im in coco["images"]}
        self.by_image: Dict[int, List[Dict]] = {}
        for a in coco["annotations"]:
            self.by_image.setdefault(a["image_id"], []).append(a)
        self.img_ids = [i for i in self.imgs if self.by_image.get(i)]
        self.image_dir = image_dir
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.img_ids)

    def get(self, idx: int) -> Sample:
        import cv2

        from ..eval.annotations import coco_annotation_to_mask

        img_id = self.img_ids[idx]
        im = self.imgs[img_id]
        image = cv2.cvtColor(
            cv2.imread(os.path.join(self.image_dir, im["file_name"])),
            cv2.COLOR_BGR2RGB)
        ann = self.by_image[img_id][
            int(self.rng.randint(0, len(self.by_image[img_id])))]
        mask = coco_annotation_to_mask(
            ann, (im["height"], im["width"]))
        phrases = part_name_phrases(self.cat_names[ann["category_id"]])
        name = phrases[int(self.rng.randint(0, len(phrases)))]
        q = self.rng.choice(SEG_QUESTION_LIST).format(
            class_name=name.lower())
        return Sample(image=image, question=q,
                      answer=str(self.rng.choice(ANSWER_LIST)),
                      mask_left=mask.astype(np.uint8), mask_right=None,
                      taxonomy=np.asarray([1, 0, 0, 0], np.float32))

    def __getitem__(self, idx) -> Sample:
        return self.get(int(self.rng.randint(0, len(self.img_ids))))
