"""VISOR/EPIC annotation front-end for the 2HANDS pipeline (port of
haff_tpu/pipeline/annotations.py; host-side, the same code).

The very front of the data-generation pipeline: derive the 3-dim
bimanual taxonomy + per-hand contact objects from VISOR sparse
annotations, and join EPIC-100 CSV narrations onto frames by frame
range. Capability parity with reference
2HANDS/scripts/utils/extract_bimanual_information.py:34-90 (contact
relations -> [unimanual, bi-symmetric, bi-asymmetric]) and
2HANDS/scripts/utils/add_narrations.py:9-35 (video_id +
start_frame..stop_frame join). Output feeds
orchestrate.FrameRecord / run_pipeline, closing the raw-annotations ->
shards path.

Host-side metadata plumbing: there is no array compute here; the device
work starts at pipeline/ops.py.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from .orchestrate import FrameRecord, expand_taxonomy

# VISOR `in_contact_object` values that mean "no usable contact"
# (reference extract_bimanual_information.py:44-50).
NON_CONTACT = ("inconclusive", "hand-not-in-contact", "none-of-the-above")

TAXONOMY3_UNIMANUAL = [1.0, 0.0, 0.0]
TAXONOMY3_SYMMETRIC = [0.0, 1.0, 0.0]
TAXONOMY3_ASYMMETRIC = [0.0, 0.0, 1.0]


@dataclass
class FrameAnnotation:
    """Per-frame annotation record (the reference's per-frame json:
    extract_bimanual_information.py:79-88)."""

    taxonomy3: List[float]
    obj_left: Optional[str] = None   # contact object NAME, left hand
    obj_right: Optional[str] = None
    narration: Optional[str] = None
    noun: Optional[str] = None
    verb: Optional[str] = None
    vector: Optional[List] = None

    def to_json(self) -> Dict:
        return {
            "taxonomy": [int(x) if float(x).is_integer() else float(x)
                         for x in self.taxonomy3],
            "obj_left": self.obj_left,
            "obj_right": self.obj_right,
            "narration": self.narration,
            "noun": self.noun,
            "verb": self.verb,
            "vector": self.vector,
        }

    @classmethod
    def from_json(cls, data: Mapping) -> "FrameAnnotation":
        return cls(taxonomy3=[float(x) for x in data["taxonomy"]],
                   obj_left=data.get("obj_left"),
                   obj_right=data.get("obj_right"),
                   narration=data.get("narration"),
                   noun=data.get("noun"), verb=data.get("verb"),
                   vector=data.get("vector"))


def frame_id_from_name(image_name: str) -> str:
    """VISOR image name -> frame id: the '_'-separated part carrying the
    zero-padded frame number, with three '0' characters removed
    (reference rename_file, extract_bimanual_information.py:19-31 — the
    10-digit VISOR frame field becomes the 7-digit EPIC frame id the
    narration join keys on)."""
    stem = image_name.split(".")[0]
    for part in stem.split("_"):
        if part.count("0") >= 3:
            return part.replace("0", "", 3)
    raise ValueError(f"no frame-number part in image name {image_name!r}")


def extract_bimanual_info(entities: Sequence[Mapping]) -> Optional[
        FrameAnnotation]:
    """VISOR entity list for one frame -> taxonomy + per-hand contact
    object names; None when neither hand is in usable contact
    (reference extract_bimanual_information.py:34-90)."""
    contact_left = contact_right = None
    for entity in entities:
        if "in_contact_object" not in entity:
            continue
        obj = entity["in_contact_object"]
        if obj in NON_CONTACT:
            continue
        if entity.get("name") == "left hand":
            contact_left = obj
        elif entity.get("name") == "right hand":
            contact_right = obj
    if contact_left is None and contact_right is None:
        return None

    if contact_left is not None and contact_right is not None:
        tax = (TAXONOMY3_SYMMETRIC if contact_left == contact_right
               else TAXONOMY3_ASYMMETRIC)
    else:
        tax = TAXONOMY3_UNIMANUAL

    names = {e.get("id"): e.get("name") for e in entities}
    return FrameAnnotation(
        taxonomy3=list(tax),
        obj_left=names.get(contact_left),
        obj_right=names.get(contact_right))


def visor_to_annotations(visor: Mapping) -> Dict[str, Dict[
        str, FrameAnnotation]]:
    """One VISOR annotation export (the sparse-annotation json with
    'video_annotations') -> {video_dir: {frame_id: FrameAnnotation}}.
    Frames where no hand is in contact are dropped (reference
    json_to_annotation, extract_bimanual_information.py:98-115)."""
    out: Dict[str, Dict[str, FrameAnnotation]] = {}
    datapoints = sorted(visor["video_annotations"],
                        key=lambda k: k["image"]["image_path"])
    for dp in datapoints:
        ann = extract_bimanual_info(dp["annotations"])
        if ann is None:
            continue
        video = dp["image"]["image_path"].split("/")[0]
        fid = frame_id_from_name(dp["image"]["name"])
        out.setdefault(video, {})[fid] = ann
    return out


def add_narrations(annotations: Dict[str, Dict[str, FrameAnnotation]],
                   narration_rows: Iterable[Mapping]) -> None:
    """Join EPIC-100 narration rows onto annotations in place: a frame
    gets the row's narration/verb/noun when its video matches and its
    integer frame id falls in [start_frame, stop_frame] (reference
    add_narrations.py:9-35). Later rows overwrite earlier on overlap,
    matching the reference's sequential rewrite."""
    for row in narration_rows:
        frames = annotations.get(row["video_id"])
        if not frames:
            continue
        start = int(row["start_frame"])
        stop = int(row["stop_frame"])
        for fid, ann in frames.items():
            if start <= int(fid) <= stop:
                ann.narration = row["narration"]
                ann.verb = row["verb"]
                ann.noun = row["noun"]


def read_narration_csv(path: str) -> List[Dict[str, str]]:
    """EPIC-100 narration CSV (video_id, start_frame, stop_frame,
    narration, verb, noun columns) -> row dicts."""
    with open(path, newline="") as f:
        return [dict(row) for row in csv.DictReader(f)]


# ---------------------------------------------------------------------------
# File-layout parity (per-video dirs of per-frame jsons)
# ---------------------------------------------------------------------------

def write_annotation_jsons(annotations: Dict[str, Dict[
        str, FrameAnnotation]], out_dir: str) -> List[str]:
    """<out_dir>/<video>/<frame_id>.json, the exact on-disk layout the
    reference's narration join and setup_dataset consume."""
    paths = []
    for video, frames in annotations.items():
        vdir = os.path.join(out_dir, video)
        os.makedirs(vdir, exist_ok=True)
        for fid, ann in frames.items():
            path = os.path.join(vdir, f"{fid}.json")
            with open(path, "w") as f:
                json.dump(ann.to_json(), f)
            paths.append(path)
    return paths


def load_annotation_jsons(root: str) -> Dict[str, Dict[
        str, FrameAnnotation]]:
    out: Dict[str, Dict[str, FrameAnnotation]] = {}
    for path in sorted(glob.glob(os.path.join(root, "*", "*.json"))):
        video = os.path.basename(os.path.dirname(path))
        fid = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            out.setdefault(video, {})[fid] = FrameAnnotation.from_json(
                json.load(f))
    return out


# ---------------------------------------------------------------------------
# Bridge into the packing pipeline
# ---------------------------------------------------------------------------

def object_id_vocab(annotations: Dict[str, Dict[str, FrameAnnotation]]
                    ) -> Dict[str, int]:
    """Stable object-name -> int id mapping across a run (sorted unique
    names). The reference stores raw name strings in the h5
    (create_dataset.py:154-161); the training dataset wants fixed-width
    ints, so the vocab travels alongside the shards."""
    names = set()
    for frames in annotations.values():
        for ann in frames.values():
            for n in (ann.obj_left, ann.obj_right):
                if n:
                    names.add(n)
    return {n: i for i, n in enumerate(sorted(names))}


def records_from_annotations(
        frames: Mapping[str, np.ndarray],
        annotations: Mapping[str, FrameAnnotation],
        aff_left: Mapping[str, np.ndarray] = (),
        aff_right: Mapping[str, np.ndarray] = (),
        obj_left: Mapping[str, np.ndarray] = (),
        obj_right: Mapping[str, np.ndarray] = (),
        object_ids: Optional[Mapping[str, int]] = None,
) -> List[FrameRecord]:
    """Assemble FrameRecords for one video from per-frame-id maps of
    inpainted frames + affordance/object masks + annotations. Frames
    without an annotation or without narration are skipped (the
    reference filter drops them later anyway; skipping here keeps the
    packer's inputs dense). Taxonomy is expanded 3 -> 4 dim from which
    hand masks exist (update_taxonomy.py:24-39 semantics)."""
    object_ids = object_ids or {}
    aff_left, aff_right = dict(aff_left), dict(aff_right)
    obj_left, obj_right = dict(obj_left), dict(obj_right)
    records = []
    for fid in sorted(frames):
        ann = annotations.get(fid)
        if ann is None or not ann.narration:
            continue
        al, ar = aff_left.get(fid), aff_right.get(fid)
        has_l = al is not None and bool(np.asarray(al).any())
        has_r = ar is not None and bool(np.asarray(ar).any())
        if not has_l and not has_r:
            continue
        records.append(FrameRecord(
            inpainted=np.asarray(frames[fid]),
            narration=ann.narration,
            taxonomy=expand_taxonomy(ann.taxonomy3, has_l, has_r),
            aff_left=np.asarray(al) if has_l else None,
            aff_right=np.asarray(ar) if has_r else None,
            obj_left=(np.asarray(obj_left[fid])
                      if fid in obj_left else None),
            obj_right=(np.asarray(obj_right[fid])
                       if fid in obj_right else None),
            noun=ann.noun or "", verb=ann.verb or "",
            obj_id_left=object_ids.get(ann.obj_left, -1),
            obj_id_right=object_ids.get(ann.obj_right, -1)))
    return records
