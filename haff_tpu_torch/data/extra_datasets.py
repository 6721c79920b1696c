"""Optional pretraining corpora + dataset mixing (port of
haff_tpu/data/extra_datasets.py; numpy and cv2, the same draws from the
same seeded generators, so samples are byte-equal).

Capability parity with the reference's legacy LISA data layer
(reference: utils/dataset.py HybridDataset:172-316, vqa_dataset.py,
reason_seg_dataset.py, data_processing.py get_mask_from_json). The
reference ships these shape-incompatible with its bimanual collate
(SURVEY.md 2.4); here they produce the SAME Sample contract as the
affordance dataset, so the one static-shape collate serves all of them:

  * VQA samples carry no masks and no [SEG] in the answer — the model's
    seg_valid gate automatically zeroes their mask losses.
  * ReasonSeg samples carry a single referred mask, mapped to the LEFT
    decoder with taxonomy [1,0,0,0] (the bimanual model's closest
    equivalent of unimanual supervision).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Sequence, Tuple

import numpy as np

from .collate import Sample
from .prompts import ANSWER_LIST
from .seg_datasets import SEG_QUESTION_LIST

LONG_QUESTION_LIST = [
    "<image>\n{sent} Please respond with segmentation mask.",
    "<image>\n{sent} Please output segmentation mask.",
]

EXPLANATORY_QUESTION_LIST = [
    "Please output segmentation mask and explain why.",
    "Please output segmentation mask and explain the reason.",
    "Please output segmentation mask and give some explanation.",
]


def get_mask_from_json(json_path: str, img: np.ndarray
                       ) -> Tuple[np.ndarray, str, bool]:
    """ReasonSeg polygon annotation -> mask with ignore label 255
    (reference utils/data_processing.py:9-60: polygons drawn largest
    first so small targets override enclosing ignore regions)."""
    import cv2

    with open(json_path, "r", errors="replace") as r:
        anno = json.load(r)
    shapes = anno["shapes"]
    comments = anno.get("text", "")
    is_sentence = bool(anno.get("is_sentence", False))
    h, w = img.shape[:2]

    areas = []
    polys = []
    for shape in shapes:
        if shape.get("label", "").lower() == "flag":
            continue
        pts = np.asarray([shape["points"]], np.int32)
        tmp = np.zeros((h, w), np.uint8)
        cv2.fillPoly(tmp, pts, 1)
        areas.append(int(tmp.sum()))
        polys.append(shape)
    order = np.argsort(areas)[::-1]

    mask = np.zeros((h, w), np.uint8)
    for idx in order:
        shape = polys[int(idx)]
        value = 255 if "ignore" in shape.get("label", "").lower() else 1
        pts = np.asarray([shape["points"]], np.int32)
        cv2.polylines(mask, pts, True, value, 1)
        cv2.fillPoly(mask, pts, value)
    return mask, comments, is_sentence


class ReasonSegDataset:
    """ReasonSeg jsons: <name>.jpg + <name>.json with polygon shapes
    (reference reason_seg_dataset.py). `explanatory` enables the
    reference's explanation-augmented sampling (reason_seg_dataset.py:
    72-91, 139-170): for images listed in explanatory/train.json, with
    probability `explanatory` the answer is the vanilla text explanation
    (no [SEG], mask losses gate off); otherwise a coin picks plain [SEG]
    or [SEG]+explanation with an explanatory question suffix."""

    def __init__(self, base_dir: str, split: str = "train", seed: int = 0,
                 explanatory: float = -1.0):
        self.images = sorted(
            glob.glob(os.path.join(base_dir, split, "*.jpg")))
        self.rng = np.random.RandomState(seed)
        self.explanatory = explanatory
        self.img_to_explanation = {}
        if explanatory != -1:
            path = os.path.join(base_dir, "explanatory", "train.json")
            if os.path.exists(path):
                with open(path) as f:
                    for item in json.load(f):
                        self.img_to_explanation[item["image"]] = {
                            "query": item["query"],
                            "outputs": item["outputs"],
                        }

    def __len__(self):
        return len(self.images)

    def get(self, idx: int) -> Sample:
        import cv2

        img_path = self.images[idx]
        image = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        mask, text, is_sentence = get_mask_from_json(
            img_path.replace(".jpg", ".json"), image)
        if is_sentence:
            q = str(self.rng.choice(LONG_QUESTION_LIST)).format(sent=text)
        else:
            # reference reason_seg_dataset.py: random SHORT template,
            # lowercased class text
            q = str(self.rng.choice(SEG_QUESTION_LIST)).format(
                class_name=text.lower())
        answer = str(self.rng.choice(ANSWER_LIST))
        mask_left = (mask == 1).astype(np.uint8)
        taxonomy = np.asarray([1, 0, 0, 0], np.float32)

        img_name = os.path.basename(img_path)
        exp = self.img_to_explanation.get(img_name)
        if exp is not None:
            choice = 2 if self.rng.rand() < self.explanatory \
                else int(self.rng.randint(0, 2))
            if choice == 1:    # [SEG] + text answer
                answer = (str(self.rng.choice(ANSWER_LIST)) + " "
                          + exp["outputs"])
                q = ("<image>\n" + text + " "
                     + self.rng.choice(EXPLANATORY_QUESTION_LIST))
            elif choice == 2:  # vanilla text answer, no mask supervision
                q = "<image>\n" + text
                answer = exp["outputs"]
                mask_left = None
                taxonomy = None
        return Sample(image=image, question=q, answer=answer,
                      mask_left=mask_left, mask_right=None,
                      taxonomy=taxonomy)

    def __getitem__(self, idx) -> Sample:
        return self.get(int(self.rng.randint(0, len(self.images))))


class VqaDataset:
    """llava_instruct-style VQA (reference vqa_dataset.py): json list of
    {image, conversations: [{from: human/gpt, value}, ...]}; LM loss only."""

    def __init__(self, json_path: str, image_dir: str, seed: int = 0):
        with open(json_path) as f:
            self.items = json.load(f)
        self.image_dir = image_dir
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.items)

    def get(self, idx: int) -> Sample:
        import cv2

        item = self.items[idx]
        image = cv2.cvtColor(
            cv2.imread(os.path.join(self.image_dir, item["image"])),
            cv2.COLOR_BGR2RGB)
        conv = item["conversations"]
        # Reference preprocess_multimodal: strip any embedded <image>
        # and prepend '<image>\n' to the FIRST human turn; keep every
        # (human, gpt) round (vqa_dataset.py builds one multi-turn
        # conversation, all answers supervised).
        turns = []
        for i in range(0, len(conv) - 1, 2):
            q = conv[i]["value"]
            a = conv[i + 1]["value"]
            if i == 0:
                q = "<image>\n" + q.replace("<image>", "").strip()
            turns.append((q, a))
        if not turns:
            turns = [("<image>\n" + conv[0]["value"]
                      .replace("<image>", "").strip(), "")]
        return Sample(image=image, question=turns[0][0],
                      answer=turns[0][1], turns=turns)

    def __getitem__(self, idx) -> Sample:
        return self.get(int(self.rng.randint(0, len(self.items))))


class HybridDataset:
    """Sample-rate mixing over datasets (reference dataset.py
    HybridDataset:172-316: draw a dataset by normalized sample_rate per
    example, then a uniform random example from it)."""

    def __init__(self, datasets: Sequence, sample_rates: Sequence[float],
                 samples_per_epoch: int = 10000, seed: int = 0):
        assert len(datasets) == len(sample_rates) and datasets
        self.datasets = list(datasets)
        rates = np.asarray(sample_rates, np.float64)
        self.probs = rates / rates.sum()
        self.samples_per_epoch = samples_per_epoch
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.samples_per_epoch

    def __getitem__(self, idx) -> Sample:
        d = self.rng.choice(len(self.datasets), p=self.probs)
        return self.datasets[d][0]
