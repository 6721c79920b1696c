"""Batch benchmark inference CLI (port of haff_tpu/infer/cli.py).

Walks benchmark_dir/<vid>/<frame>/{inpainting.png, annotation.json},
prompts "Where would you interact with the object to perform action
{narration}", generates, decodes dual masks, sweeps sigmoid thresholds
{0.1,0.2,0.3,0.5,0.7}, and writes vis_save_path{th}/<vid>/<frame>/
aff_{left,right}.png gated by the taxonomy argmax (0 = left-only zeroes
the right mask, 1 = right-only zeroes the left, 2/3 keep both).

Frames go through the evaluate in fixed-size batches (one decode graph on
the card); host work is PNG IO and the final resize.

Usage: python -m haff_tpu_torch.infer.cli --benchmark_dir B
       [--vis_save_path V] [--model_preset tiny|small|1b|7b|13b]
       [--checkpoint PARAMS.npz|CKPT_DIR] [--tokenizer PATH] [--batch 8]
       [--max_new_tokens 32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np


def write_threshold_masks(vis_base: str, vid: str, frame: str,
                          logits_left: np.ndarray, logits_right: np.ndarray,
                          taxonomy: np.ndarray, thresholds) -> None:
    """Threshold sweep + taxonomy gating + PNG output (reference
    inference.py:276-334)."""
    import cv2

    probs_l = 1.0 / (1.0 + np.exp(-logits_left))
    probs_r = 1.0 / (1.0 + np.exp(-logits_right))
    tax = int(np.argmax(taxonomy))
    for th in thresholds:
        out_dir = os.path.join(f"{vis_base}{th}", vid, frame)
        os.makedirs(out_dir, exist_ok=True)
        # The gated-off side's file is NOT written (reference
        # inference.py:278/313: left only when argmax != 1, right only
        # when argmax != 0) — downstream consumers distinguish a missing
        # prediction from an empty mask.
        if tax != 1:
            ml = (probs_l > th).astype(np.uint8) * 255
            cv2.imwrite(os.path.join(out_dir, "aff_left.png"), ml)
        if tax != 0:
            mr = (probs_r > th).astype(np.uint8) * 255
            cv2.imwrite(os.path.join(out_dir, "aff_right.png"), mr)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--benchmark_dir", required=True)
    p.add_argument("--vis_save_path", default="./vis_output")
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--decoder", default="llama", choices=["llama", "mpt"])
    p.add_argument("--checkpoint", default=None,
                   help="export_params .npz or a ckpt_model directory of the "
                        "train CLI (seeded random init if absent)")
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer path (ByteTokenizer fallback)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--max_text_len", type=int, default=320)
    p.add_argument("--thresholds", type=float, nargs="+",
                   default=[0.1, 0.2, 0.3, 0.5, 0.7])
    p.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--conv_type", default="llava_v1",
                   choices=["llava_v1", "llava_llama_2"])
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--no_mm_start_end", dest="use_mm_start_end",
                   action="store_false")
    p.add_argument("--load_in_8bit", action="store_true",
                   help="int8 weights and activations (W8A8) for the SAM "
                        "encoder and LLM projections")
    p.add_argument("--load_in_4bit", action="store_true",
                   help="group-wise packed-int4 LLM projections (W4A16)")
    p.add_argument("--kv_cache_8bit", action="store_true",
                   help="store the decode KV cache as int8 with per "
                        "token-head scales")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (not ported "
                        "yet: raises)")
    p.add_argument("--draft_len", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    from ..core.config import ModelConfig
    from ..data.aff_dataset import AffDatasetVal
    from ..data.collate import collate_affordance
    from ..data.tokenizer import load_tokenizer, seg_token_idx
    from ..nn.sam import resize_to_original
    from .evaluate import make_jitted_evaluate
    from .predictor import _require_device, load_model

    if args.speculative:
        raise SystemExit("--speculative is not ported yet (ROADMAP Queue 1 "
                         "item 7)")
    device = _require_device(args.device)
    tok = load_tokenizer(args.tokenizer,
                         model_max_length=args.max_text_len)
    cfg = ModelConfig.preset(args.model_preset).replace(
        seg_token_idx=seg_token_idx(tok), decoder=args.decoder,
        dtype="bfloat16" if args.precision == "bf16" else "float32")

    ds = AffDatasetVal(args.benchmark_dir, require_masks=False,
                       style="inference")
    print(f"benchmark frames: {len(ds)}")
    if not len(ds):
        return

    model = load_model(cfg, args.precision, device, args.checkpoint,
                       args.load_in_8bit, args.load_in_4bit)
    ev = make_jitted_evaluate(model, max_new_tokens=args.max_new_tokens,
                              eos_id=tok.eos_token_id,
                              kv_cache_8bit=args.kv_cache_8bit)

    B = args.batch
    for start in range(0, len(ds), B):
        items = [ds[i] for i in range(start, min(start + B, len(ds)))]
        samples = [s for s, _ in items]
        entries = [e for _, e in items]
        pad = B - len(samples)
        batch = collate_affordance(
            samples + [samples[-1]] * pad, tok,
            sam_image_size=cfg.sam_encoder.image_size,
            clip_image_size=cfg.clip.image_size,
            max_text_len=args.max_text_len, conv_type=args.conv_type,
            use_mm_start_end=args.use_mm_start_end,
            use_template=False, for_training=False)
        res = ev(batch["images_sam"], batch["images_clip"],
                 batch["input_ids"], batch["attention_mask"])
        ml = res.pred_masks_left.float().cpu().numpy()
        mr = res.pred_masks_right.float().cpu().numpy()
        tax = res.taxonomies.float().cpu().numpy()
        for i, (sample, entry) in enumerate(zip(samples, entries)):
            orig = sample.image.shape[:2]
            rh, rw = batch["resizes"][i]
            left = resize_to_original(ml[i:i + 1], (rh, rw), orig)[0]
            right = resize_to_original(mr[i:i + 1], (rh, rw), orig)[0]
            write_threshold_masks(args.vis_save_path, entry["vid"],
                                  entry["frame"], left, right, tax[i],
                                  args.thresholds)
        print(f"[{min(start + B, len(ds))}/{len(ds)}] done", flush=True)


if __name__ == "__main__":
    main()
