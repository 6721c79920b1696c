"""2HANDS pipeline CLI, the pipeline.bash analog (port of
haff_tpu/pipeline/cli.py).

Walks a frame tree of <seq>/{frame.png, hand_left.png, hand_right.png,
object.png, annotation.json{narration, taxonomy3}} (the post-propagation
layout the reference's submodule stages emit), runs the deterministic
stages (dilate/recolor -> affordance extraction -> filtering -> taxonomy
expansion -> packing) and writes h5+json training shards.

Usage: python -m haff_tpu_torch.pipeline.cli --frames_dir F --out_dir O
       [--dilate 10] [--shard_size 512] [--flip_augment] [--device cuda]

Also --video CLIP --seeds_dir S (stage-1 decode, then seeded propagation
and inpainting) and --epic PARTICIPANT VIDEO (frame-tar acquisition). The
device stages run on --device, the card by default; without one the CLI
raises "no CUDA device" (ask for --device cpu).
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np


def load_sequences(frames_dir: str):
    import cv2

    frames, hl, hr, obj, narrs, tax3 = [], [], [], [], [], []
    for seq in sorted(os.listdir(frames_dir)):
        sdir = os.path.join(frames_dir, seq)
        if not os.path.isdir(sdir):
            continue
        fp = os.path.join(sdir, "frame.png")
        ann_p = os.path.join(sdir, "annotation.json")
        if not (os.path.exists(fp) and os.path.exists(ann_p)):
            continue
        frame = cv2.cvtColor(cv2.imread(fp), cv2.COLOR_BGR2RGB)
        with open(ann_p) as f:
            ann = json.load(f)

        def mask(name):
            p = os.path.join(sdir, name)
            m = cv2.imread(p, cv2.IMREAD_GRAYSCALE) if os.path.exists(p) \
                else None
            return ((m > 127).astype(np.uint8) if m is not None
                    else np.zeros(frame.shape[:2], np.uint8))

        frames.append(frame)
        hl.append(mask("hand_left.png"))
        hr.append(mask("hand_right.png"))
        obj.append(mask("object.png"))
        narrs.append(ann.get("narration", ""))
        tax3.append(ann.get("taxonomy3", [1, 0, 0]))
    if not frames:
        return None
    return (np.stack(frames), np.stack(hl), np.stack(hr), np.stack(obj),
            narrs, np.asarray(tax3, np.float32))


def acquire_video(video_path: str, stride: int = 1,
                  max_frames: int = 0) -> np.ndarray:
    """Stage 1 frame acquisition: raw clip -> (N, H, W, 3) uint8 RGB
    (the in-repo analog of the reference's EPIC download + frame
    extraction feeding pipeline.bash stage 1)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if max_frames and len(frames) >= max_frames:
                break
        idx += 1
    cap.release()
    if not frames:
        raise SystemExit(f"no frames decoded from {video_path}")
    return np.stack(frames)


def _run_seeded(args, frames):
    """Seeded propagation + packing on acquired frames (stages 2-12)."""
    import cv2

    from .orchestrate import run_pipeline_from_video

    if not args.seeds_dir:
        raise SystemExit("seeded mode requires --seeds_dir")

    def seed(name):
        m = cv2.imread(os.path.join(args.seeds_dir, name),
                       cv2.IMREAD_GRAYSCALE)
        return ((m > 127).astype(np.uint8) if m is not None
                else np.zeros(frames.shape[1:3], np.uint8))

    ann_p = os.path.join(args.seeds_dir, "annotation.json")
    ann = json.load(open(ann_p)) if os.path.exists(ann_p) else {}
    shards = run_pipeline_from_video(
        frames, seed("hand_left.png"), seed("hand_right.png"),
        seed("object.png"), ann.get("narration", ""),
        ann.get("taxonomy3", [1, 0, 0]), args.out_dir,
        dilate_factor=args.dilate, shard_name=args.shard_name,
        shard_size=args.shard_size, device=args.device)
    print(f"wrote {len(shards)} shard pair(s) to {args.out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--frames_dir")
    src.add_argument("--video", help="raw clip: stage-1 acquisition + "
                     "seeded propagation (needs --seeds_dir)")
    src.add_argument("--epic", nargs=2, metavar=("PARTICIPANT", "VIDEO"),
                     help="download+extract EPIC-KITCHENS rgb frames "
                     "(download_video.bash analog); with --seeds_dir "
                     "continues into the seeded pipeline")
    p.add_argument("--data_dir", default="EPIC_DATA",
                   help="EPIC data root for --epic")
    p.add_argument("--split", default="train",
                   help="EPIC-55 split path segment for --epic")
    p.add_argument("--epic100", action="store_true",
                   help="use the EPIC-100 extension dataset layout")
    p.add_argument("--epic_base_url",
                   help="mirror/base URL override (any urllib scheme)")
    p.add_argument("--seeds_dir", help="dir with hand_left.png/"
                   "hand_right.png/object.png frame-0 seeds + "
                   "annotation.json for --video mode")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--out_dir", help="shard output dir (required for "
                   "every mode except acquisition-only --epic)")
    p.add_argument("--dilate", type=int, default=10)
    p.add_argument("--shard_size", type=int, default=512)
    p.add_argument("--shard_name", default="P00")
    p.add_argument("--flip_augment", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device of the propagation, inpainting, dilation "
                        "and affordance stages (cuda or cpu)")
    args = p.parse_args(argv)
    if not args.out_dir and not (args.epic and not args.seeds_dir):
        p.error("--out_dir is required except for acquisition-only --epic")

    from .orchestrate import _require_device, run_pipeline

    if args.seeds_dir or not args.epic:
        _require_device(args.device)
    if args.epic:
        from .acquire import acquire_epic_video

        participant, video = args.epic
        frames_dir = acquire_epic_video(
            args.data_dir, participant, video, split=args.split,
            epic100=args.epic100, base_url=args.epic_base_url)
        names = sorted(f for f in os.listdir(frames_dir)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        print(f"acquired {len(names)} frames -> {frames_dir}")
        if not args.seeds_dir:
            return  # acquisition-only, like download_video.bash
        import cv2

        sel = names[::args.stride]
        if args.max_frames:
            sel = sel[:args.max_frames]
        frames = np.stack([
            cv2.cvtColor(cv2.imread(os.path.join(frames_dir, f)),
                         cv2.COLOR_BGR2RGB) for f in sel])
        _run_seeded(args, frames)
        return

    if args.video:
        if not args.seeds_dir:
            raise SystemExit("--video requires --seeds_dir")
        frames = acquire_video(args.video, args.stride, args.max_frames)
        _run_seeded(args, frames)
        return

    data = load_sequences(args.frames_dir)
    if data is None:
        print("no sequences found")
        return
    frames, hl, hr, obj, narrs, tax3 = data
    print(f"loaded {frames.shape[0]} frames")
    shards = run_pipeline(frames, hl, hr, obj, narrs, tax3, args.out_dir,
                          dilate_factor=args.dilate,
                          shard_name=args.shard_name,
                          shard_size=args.shard_size, device=args.device)

    def _packed_count(shard_paths):
        # ranges are inclusive 'start-end_*' (reference rename_dataset);
        # continue the flipped shards after the last used index
        end = -1
        for h5p, _ in shard_paths:
            m = re.match(r"(\d+)-(\d+)_", os.path.basename(h5p))
            if m:
                end = max(end, int(m.group(2)))
        return end + 1

    if args.flip_augment:
        # Mirror frames and SWAP hand masks (reference horizontal_flip.py).
        # The 3-dim taxonomy [unimanual, sym, asym] is flip-invariant: the
        # left/right split happens later from which masks exist.
        flipped = np.flip(frames, axis=2).copy()
        fl = np.flip(hr, axis=2).copy()
        fr = np.flip(hl, axis=2).copy()
        fo = np.flip(obj, axis=2).copy()
        shards += run_pipeline(
            flipped, fl, fr, fo, narrs, tax3, args.out_dir,
            dilate_factor=args.dilate,
            shard_name="flipped_" + args.shard_name,
            shard_size=args.shard_size,
            start_index=_packed_count(shards), device=args.device)
    print(f"wrote {len(shards)} shard pair(s) to {args.out_dir}")


if __name__ == "__main__":
    main()
