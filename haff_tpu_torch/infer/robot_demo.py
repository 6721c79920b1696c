"""File-polling robot loop (port of haff_tpu/infer/robot_demo.py, the
reference 2Haff/robot_demo.py analog).

Protocol (reference robot_demo.py:178-336, ZED2 producer):
  <root>/in/ receives {img.png, prompt.txt, margins.txt} (+ optional
  mask_left.png / mask_right.png full-frame object masks — at least one
  must exist). margins.txt is ONE comma-separated line
  'left,top,right,bottom'. The prompt is prefixed with the benchmark
  instruction ('Where would you interact with the object to perform
  action ') and tokenized BARE (no conversation template). Mask logits
  threshold at --th (default -5); per-hand min-max JET heatmaps
  (aff_{left,right}_heat.png) are written from the raw logits; the
  binary mask is re-padded to the pre-crop frame with the margins, ANDed
  with the provided object mask (falling back to the other hand's mask
  when one is missing), and written as aff_{left,right}.png — a side is
  written ONLY under --force_left/--force_right/--force_both, exactly
  like the reference (its taxonomy gate is commented out). The input
  img/prompt/margins are deleted after each frame; the object masks are
  kept (a producer may write them once per scene).

Usage: python -m haff_tpu_torch.infer.robot_demo --root robot_demo
       [--th -5] [--force_left|--force_right|--force_both]
       [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

INSTRUCTION_PREFIX = ("Where would you interact with the object to "
                      "perform action ")


def create_heatmap(logits: np.ndarray) -> np.ndarray:
    """Min-max normalized JET colormap (reference robot_demo.py:57-70)."""
    import cv2

    norm = cv2.normalize(np.asarray(logits, np.float32), None, 0, 255,
                         cv2.NORM_MINMAX)
    return cv2.applyColorMap(np.uint8(norm), cv2.COLORMAP_JET)


def restore_margins(mask: np.ndarray, margins) -> np.ndarray:
    """Re-pad a crop-space mask to the pre-crop frame: margins =
    (left, top, right, bottom) pixels added around the crop (reference
    robot_demo.py:283-291 PIL paste at (left, top))."""
    left, top, right, bottom = [int(v) for v in margins]
    h, w = mask.shape
    out = np.zeros((h + top + bottom, w + left + right), mask.dtype)
    out[top:top + h, left:left + w] = mask
    return out


def _finalize_side(logits, th, margins, own_mask, other_mask, out_dir,
                   side):
    """Threshold -> heatmap -> re-pad -> AND object mask -> save."""
    import cv2

    cv2.imwrite(os.path.join(out_dir, f"aff_{side}_heat.png"),
                create_heatmap(logits))
    binary = (logits > th).astype(np.uint8)
    binary = restore_margins(binary, margins)
    obj = own_mask if own_mask is not None else other_mask
    if obj is not None:
        if obj.shape != binary.shape:
            oh, ow = binary.shape
            obj = cv2.resize(obj, (ow, oh),
                             interpolation=cv2.INTER_NEAREST)
        binary = binary & (obj > 0).astype(np.uint8)
    cv2.imwrite(os.path.join(out_dir, f"aff_{side}.png"), binary * 255)


def process_once(predictor, root: str, th: float, force: str = "") -> bool:
    """One poll iteration; returns True when a frame was processed."""
    import cv2

    in_dir = os.path.join(root, "in")
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir, exist_ok=True)
    img_path = os.path.join(in_dir, "img.png")
    prompt_path = os.path.join(in_dir, "prompt.txt")
    margins_path = os.path.join(in_dir, "margins.txt")
    if not (os.path.exists(img_path) and os.path.exists(prompt_path)
            and os.path.exists(margins_path)):
        return False
    mask_left = mask_right = None
    p = os.path.join(in_dir, "mask_left.png")
    if os.path.exists(p):
        mask_left = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    p = os.path.join(in_dir, "mask_right.png")
    if os.path.exists(p):
        mask_right = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    if mask_left is None and mask_right is None:
        return False  # reference: "Masks not found" -> keep polling

    image = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
    with open(prompt_path) as f:
        prompt = f.readline().strip()
    with open(margins_path) as f:
        margins = [int(v) for v in f.readline().split(",")[:4]]

    text, ml, mr, tax = predictor(image, INSTRUCTION_PREFIX + prompt)
    if force in ("left", "both"):
        _finalize_side(ml, th, margins, mask_left, mask_right, out_dir,
                       "left")
    if force in ("right", "both"):
        _finalize_side(mr, th, margins, mask_right, mask_left, out_dir,
                       "right")
    cv2.imwrite(os.path.join(out_dir, "cropped_img.png"),
                cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
    with open(os.path.join(out_dir, "text.txt"), "w") as f:
        f.write(text)

    # reference removes only img/prompt/margins; object masks persist
    for name in ("img.png", "prompt.txt", "margins.txt"):
        os.remove(os.path.join(in_dir, name))
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="robot_demo")
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--decoder", default="llama", choices=["llama", "mpt"])
    p.add_argument("--checkpoint", default=None,
                   help="export_params .npz (seeded random init if absent)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--load_in_8bit", action="store_true")
    p.add_argument("--load_in_4bit", action="store_true")
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--no_mm_start_end", dest="use_mm_start_end",
                   action="store_false")
    p.add_argument("--kv_cache_8bit", action="store_true")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (not ported "
                        "yet: raises)")
    p.add_argument("--draft_len", type=int, default=8)
    p.add_argument("--th", type=float, default=-5.0)
    p.add_argument("--force_left", action="store_true")
    p.add_argument("--force_right", action="store_true")
    p.add_argument("--force_both", action="store_true")
    p.add_argument("--poll_interval", type=float, default=0.2)
    p.add_argument("--max_iters", type=int, default=0,
                   help="0 = run forever")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    from .predictor import Predictor

    force = ("both" if args.force_both else
             "left" if args.force_left else
             "right" if args.force_right else "")
    predictor = Predictor(model_preset=args.model_preset,
                          decoder=args.decoder,
                          checkpoint=args.checkpoint,
                          tokenizer=args.tokenizer,
                          load_in_8bit=args.load_in_8bit,
                          load_in_4bit=args.load_in_4bit,
                          kv_cache_8bit=args.kv_cache_8bit,
                          speculative=args.speculative,
                          draft_len=args.draft_len,
                          device=args.device,
                          use_mm_start_end=args.use_mm_start_end,
                          use_template=False)
    os.makedirs(os.path.join(args.root, "in"), exist_ok=True)
    print(f"polling {args.root}/in ...")
    i = 0
    while True:
        if process_once(predictor, args.root, args.th, force):
            print("processed frame", flush=True)
        else:
            time.sleep(args.poll_interval)
        i += 1
        if args.max_iters and i >= args.max_iters:
            break


if __name__ == "__main__":
    main()
