"""2HANDS pipeline orchestration and dataset packing (port of
haff_tpu/pipeline/orchestrate.py).

Capability parity with reference 2HANDS/pipeline.bash + scripts/**: the
offline producer that turns egocentric video into the h5 + json training
shards AffDataset reads:

  stage 1  frame acquisition            (caller-provided frames)
  stage 2  hand/object mask propagation (pluggable; default
           pipeline/defaults.py, on the device)
  stage 3  dilate + recolor             (pipeline/ops.py, on the device)
  stage 4  hand inpainting              (pluggable; default on the device)
  stage 5  object mask completion       (pluggable: `sam_mask_completion`
           prompts a SAM with the partial mask's centroid)
  stage 6  affordance = hand AND completed object (ops.extract_affordance)
  stages 8-10  filter and taxonomy      (this module, on the host)
  stage 12 packing to h5 + json contour shards (this module; the layout
           of reference create_dataset.py:116-238 +
           compress_masks_to_json.py:60-92, byte for byte as JAX writes it)

The device stages run on `device`, the card unless the caller asks for
the CPU. `video_records` and `build_records` stop before packing;
`run_pipeline_from_video` and `run_pipeline` pack what they build.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..infer.predictor import _require_device
from . import ops


def mask_to_contours(mask: np.ndarray) -> List:
    """Binary mask -> flattened (N, 2) cv2 contour point lists (reference
    utils/compress_masks_to_json.py:60-92 json format)."""
    import cv2

    contours, _ = cv2.findContours(
        (np.asarray(mask) > 0).astype(np.uint8), cv2.RETR_EXTERNAL,
        cv2.CHAIN_APPROX_SIMPLE)
    return [c[:, 0, :].tolist() for c in contours]


def expand_taxonomy(tax3: Sequence[float], has_left: bool,
                    has_right: bool) -> List[float]:
    """3-dim [unimanual, bi-symmetric, bi-asymmetric] -> 4-dim [left,
    right, bi-sym, bi-asym]: the unimanual weight goes to the RIGHT hand
    unless the right-hand files are absent (reference
    data_setup/update_taxonomy.py:24-39)."""
    uni, sym, asym = [float(x) for x in tax3]
    left = uni if not has_right else 0.0
    right = uni if has_right else 0.0
    return [left, right, sym, asym]


@dataclass
class FrameRecord:
    """One packed frame (reference per-frame folder layout,
    data_setup/setup_dataset.py:5-64)."""

    inpainted: np.ndarray            # (H, W, 3) uint8
    narration: str
    taxonomy: Sequence[float]        # 4-dim
    aff_left: Optional[np.ndarray] = None    # (H, W) binary
    aff_right: Optional[np.ndarray] = None
    obj_left: Optional[np.ndarray] = None
    obj_right: Optional[np.ndarray] = None
    noun: str = ""
    verb: str = ""
    obj_id_left: int = -1
    obj_id_right: int = -1


def filter_record(rec: FrameRecord, min_area: int = 20,
                  max_area: int = 30000) -> bool:
    """Reference filter gates (filter_dataset.py:40-117 +
    create_dataset.py:28-114): narration/verb present and affordance-
    bearing, the taxonomy's hands' masks present with in-range area."""
    if not ops.narration_ok(rec.narration, rec.verb or None):
        return False

    def ok(m):
        return (m is not None and np.count_nonzero(m)
                and ops.mask_area_ok(m, min_area, max_area))

    tax = [float(x) for x in rec.taxonomy]
    if tax[2] + tax[3] > 0:
        return bool(ok(rec.aff_left) and ok(rec.aff_right))
    if tax[0] > 0:
        return bool(ok(rec.aff_left))
    if tax[1] > 0:
        return bool(ok(rec.aff_right))
    return False


def write_h5(records: Sequence[FrameRecord], h5_path: str) -> None:
    """The shard's h5: 'data/{inpainted, taxonomy, narration, noun, verb,
    obj_id_left, obj_id_right}' (reference create_dataset.py:116-238)."""
    import h5py

    with h5py.File(h5_path, "w") as f:
        g = f.create_group("data")
        g.create_dataset(
            "inpainted",
            data=np.stack([r.inpainted for r in records]).astype(np.uint8))
        g.create_dataset(
            "taxonomy",
            data=np.stack([np.asarray(r.taxonomy, np.float32)
                           for r in records]))
        str_dt = h5py.string_dtype()
        g.create_dataset("narration",
                         data=[r.narration for r in records], dtype=str_dt)
        g.create_dataset("noun", data=[r.noun for r in records],
                         dtype=str_dt)
        g.create_dataset("verb", data=[r.verb for r in records],
                         dtype=str_dt)
        g.create_dataset(
            "obj_id_left",
            data=np.asarray([r.obj_id_left for r in records], np.int32))
        g.create_dataset(
            "obj_id_right",
            data=np.asarray([r.obj_id_right for r in records], np.int32))


def write_contours_json(records: Sequence[FrameRecord], json_path: str,
                        start_index: int = 0) -> None:
    """The shard's json: '{idx: {original_size, aff_left, aff_right,
    obj_left, obj_right}}' with contour point lists."""
    def contours(m):
        return mask_to_contours(m) if m is not None else []

    entries = {}
    for i, r in enumerate(records):
        entries[str(start_index + i)] = {
            "original_size": list(r.inpainted.shape[:2]),
            "aff_left": contours(r.aff_left),
            "aff_right": contours(r.aff_right),
            "obj_left": contours(r.obj_left),
            "obj_right": contours(r.obj_right),
        }
    with open(json_path, "w") as f:
        json.dump(entries, f)


def pack_shard(records: Sequence[FrameRecord], out_dir: str,
               start_index: int = 0,
               shard_name: str = "P00") -> Tuple[str, str]:
    """Write one h5 + json shard pair, filenames 'start-end_<name>.{h5,json}'
    under out_dir/{h5,jsons} (reference create_dataset.py:116-238,
    rename_dataset.py:4-33)."""
    os.makedirs(os.path.join(out_dir, "h5"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "jsons"), exist_ok=True)
    end_index = start_index + len(records) - 1
    stem = f"{start_index}-{end_index}_{shard_name}"
    h5_path = os.path.join(out_dir, "h5", stem + ".h5")
    json_path = os.path.join(out_dir, "jsons", stem + ".json")
    write_h5(records, h5_path)
    write_contours_json(records, json_path, start_index)
    return h5_path, json_path


def pack_shards(records: Sequence[FrameRecord], out_dir: str,
                shard_name: str = "P00", shard_size: int = 512,
                start_index: int = 0) -> List[Tuple[str, str]]:
    """`pack_shard` over consecutive chunks of `shard_size` records."""
    return [pack_shard(records[s:s + shard_size], out_dir,
                       start_index=start_index + s, shard_name=shard_name)
            for s in range(0, len(records), shard_size)]


# ---------------------------------------------------------------------------
# Mask completion with a prompted SAM (replaces the sam2 submodule stage)
# ---------------------------------------------------------------------------

def sam_mask_completion(sam_apply: Callable, images: np.ndarray,
                        partial_masks: np.ndarray) -> np.ndarray:
    """Complete occluded object masks on inpainted frames by prompting
    SAM with each partial mask's centroid (x, y) in mask pixels (reference
    stage 5 uses the sam2 submodule).

    sam_apply(images, points (B, 1, 2), labels (B, 1)) -> mask logits
    (B, 1, H, W); returns (B, H, W) uint8 logits > 0."""
    b = partial_masks.shape[0]
    pts = np.zeros((b, 1, 2), np.float32)
    for i in range(b):
        ys, xs = np.nonzero(partial_masks[i])
        if len(xs):
            pts[i, 0] = (xs.mean(), ys.mean())
    labels = np.ones((b, 1), np.int32)
    logits = sam_apply(images, pts, labels)
    return (np.asarray(logits)[:, 0] > 0).astype(np.uint8)


@dataclass
class PipelineStages:
    """Pluggable external stages (reference submodules). Left None,
    run_pipeline_from_video takes the in-repo defaults
    (pipeline/defaults.py) on the device."""

    propagate_masks: Optional[Callable] = None   # XMem analog
    inpaint_hands: Optional[Callable] = None     # agent_inpainting analog
    complete_masks: Optional[Callable] = None    # sam2 analog


def video_records(frames: np.ndarray, seed_left: np.ndarray,
                  seed_right: np.ndarray, seed_obj: np.ndarray,
                  narration: str, taxonomy3: Sequence[float],
                  stages: PipelineStages = PipelineStages(),
                  dilate_factor: int = 10, device="cuda"
                  ) -> List[FrameRecord]:
    """Raw clip -> frame records with only frame-0 seed masks (the
    VISOR-seeded protocol of reference pipeline.bash stages 1-2):
    propagate the seeds through the clip (stage 2), inpaint the hands out
    (stage 4), then `build_records`. frames (N, H, W, 3) uint8; seed_*
    (H, W) binary masks on frame 0."""
    from .defaults import default_inpaint, default_propagate

    device = _require_device(device)
    n = frames.shape[0]
    if stages.propagate_masks is not None:
        left, right, obj = stages.propagate_masks(
            frames, seed_left, seed_right, seed_obj)
    else:
        left, right, obj = default_propagate(
            frames, seed_left, seed_right, seed_obj, device=device)

    hands = (np.asarray(left) != 0) | (np.asarray(right) != 0)
    if stages.inpaint_hands is not None:
        inpainted = np.asarray(stages.inpaint_hands(frames))
    else:
        inpainted = default_inpaint(frames, hands.astype(np.uint8),
                                    device=device)

    # Stage 4 already ran; build_records must not run it again.
    inner = PipelineStages(inpaint_hands=None,
                           complete_masks=stages.complete_masks)
    return build_records(
        inpainted, np.asarray(left), np.asarray(right), np.asarray(obj),
        [narration] * n, np.tile(np.asarray(taxonomy3, np.float32), (n, 1)),
        inner, dilate_factor, device)


def run_pipeline_from_video(frames: np.ndarray, seed_left: np.ndarray,
                            seed_right: np.ndarray, seed_obj: np.ndarray,
                            narration: str, taxonomy3: Sequence[float],
                            out_dir: str,
                            stages: PipelineStages = PipelineStages(),
                            dilate_factor: int = 10, device="cuda",
                            **kwargs) -> List[Tuple[str, str]]:
    """`video_records`, then `pack_shards` (kwargs: shard_name,
    shard_size, start_index). Returns the list of (h5, json) shard
    paths."""
    records = video_records(frames, seed_left, seed_right, seed_obj,
                            narration, taxonomy3, stages, dilate_factor,
                            device)
    return pack_shards(records, out_dir, **kwargs)


def build_records(frames: np.ndarray, hand_masks_left: np.ndarray,
                  hand_masks_right: np.ndarray, object_masks: np.ndarray,
                  narrations: Sequence[str], taxonomies3: np.ndarray,
                  stages: PipelineStages = PipelineStages(),
                  dilate_factor: int = 10, device="cuda"
                  ) -> List[FrameRecord]:
    """Stages 3-10 over in-memory frames: the frame records that pass the
    filter, in frame order. frames (N, H, W, 3) uint8; hand/object masks
    (N, H, W) binary; taxonomies3 (N, 3). Dilation, completion and
    affordance on `device`; filtering on the host."""
    device = _require_device(device)
    if stages.inpaint_hands is not None:
        frames = np.asarray(stages.inpaint_hands(frames))

    def dev(a):
        return torch.as_tensor(np.asarray(a).astype(np.float32), device=device)

    # Reference flow (pipeline.bash stages 3, 6): per-hand DILATED masks
    # AND the completed object, then the affordance is dilated AGAIN
    # (process_affordances) before packing.
    dil_left = ops.recolor_white(ops.dilate_masks(dev(hand_masks_left),
                                                  dilate_factor))
    dil_right = ops.recolor_white(ops.dilate_masks(dev(hand_masks_right),
                                                   dilate_factor))
    objs = np.asarray(object_masks).astype(np.float32)
    if stages.complete_masks is not None:
        objs = np.asarray(stages.complete_masks(frames, objs)).astype(
            np.float32)
    objs_d = dev(objs)

    def affordance(dil):
        return ops.recolor_white(ops.dilate_masks(
            ops.extract_affordance(dil, objs_d), dilate_factor)).cpu().numpy()

    aff_l, aff_r = affordance(dil_left), affordance(dil_right)
    records: List[FrameRecord] = []
    for i in range(frames.shape[0]):
        left = aff_l[i].astype(np.uint8)
        right = aff_r[i].astype(np.uint8)
        tax4 = expand_taxonomy(taxonomies3[i], has_left=bool(left.any()),
                               has_right=bool(right.any()))
        rec = FrameRecord(
            inpainted=frames[i], narration=str(narrations[i]),
            taxonomy=tax4,
            aff_left=left if left.any() else None,
            aff_right=right if right.any() else None,
            obj_left=objs[i].astype(np.uint8),
            obj_right=objs[i].astype(np.uint8))
        if filter_record(rec):
            records.append(rec)
    return records


def run_pipeline(frames: np.ndarray, hand_masks_left: np.ndarray,
                 hand_masks_right: np.ndarray, object_masks: np.ndarray,
                 narrations: Sequence[str], taxonomies3: np.ndarray,
                 out_dir: str, stages: PipelineStages = PipelineStages(),
                 dilate_factor: int = 10, shard_name: str = "P00",
                 shard_size: int = 512, start_index: int = 0,
                 device="cuda") -> List[Tuple[str, str]]:
    """End-to-end pipeline.bash analog over in-memory frame arrays:
    `build_records`, then `pack_shards`. Returns the list of (h5, json)
    shard paths."""
    records = build_records(frames, hand_masks_left, hand_masks_right,
                            object_masks, narrations, taxonomies3, stages,
                            dilate_factor, device)
    return pack_shards(records, out_dir, shard_name, shard_size,
                       start_index)
