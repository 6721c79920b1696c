"""Interactive chat REPL (port of haff_tpu/infer/chat.py, the reference
2Haff/chat.py analog).

Prompts for text + an image path, runs evaluate, saves taxonomy-gated
left/right masks (zeroing the excluded hand, reference chat.py:233-247)
and a red/blue overlay next to the input image.

Usage: python -m haff_tpu_torch.infer.chat [--model_preset 7b]
       [--checkpoint PARAMS.npz] [--tokenizer PATH]
       [--vis_save_path ./vis_output] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--decoder", default="llama", choices=["llama", "mpt"])
    p.add_argument("--checkpoint", default=None,
                   help="export_params .npz (seeded random init if absent)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--load_in_8bit", action="store_true")
    p.add_argument("--load_in_4bit", action="store_true")
    p.add_argument("--conv_type", default="llava_v1",
                   choices=["llava_v1", "llava_llama_2"])
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--no_mm_start_end", dest="use_mm_start_end",
                   action="store_false")
    p.add_argument("--kv_cache_8bit", action="store_true")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (ANSWER_LIST "
                        "template drafts; exact greedy output, fewer decode "
                        "forwards; llama decoder only)")
    p.add_argument("--draft_len", type=int, default=8,
                   help="tokens a speculative verify step (>= 2)")
    p.add_argument("--vis_save_path", default="./vis_output")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    import cv2

    from ..eval.tools import overlay_results
    from .predictor import Predictor

    predictor = Predictor(model_preset=args.model_preset,
                          decoder=args.decoder,
                          checkpoint=args.checkpoint,
                          tokenizer=args.tokenizer,
                          precision=args.precision,
                          load_in_8bit=args.load_in_8bit,
                          load_in_4bit=args.load_in_4bit,
                          kv_cache_8bit=args.kv_cache_8bit,
                          speculative=args.speculative,
                          draft_len=args.draft_len,
                          device=args.device,
                          conv_type=args.conv_type,
                          use_mm_start_end=args.use_mm_start_end)
    os.makedirs(args.vis_save_path, exist_ok=True)
    print("Ready. Empty prompt exits.")
    while True:
        try:
            prompt = input("Please input your prompt: ").strip()
        except EOFError:
            break
        if not prompt:
            break
        image_path = input("Please input the image path: ").strip()
        if not os.path.exists(image_path):
            print(f"File not found: {image_path}")
            continue
        image = cv2.cvtColor(cv2.imread(image_path), cv2.COLOR_BGR2RGB)
        text, ml, mr, tax = predictor(image, prompt)
        print(f"text output: {text}")
        probs_l = 1 / (1 + np.exp(-ml))
        probs_r = 1 / (1 + np.exp(-mr))
        bl = (probs_l > args.threshold).astype(np.uint8)
        br = (probs_r > args.threshold).astype(np.uint8)
        t = int(np.argmax(tax))
        if t == 0:
            br[:] = 0
        elif t == 1:
            bl[:] = 0
        stem = os.path.splitext(os.path.basename(image_path))[0]
        # reference chat.py:236-252: '{stem}_mask_left{i}.jpg' at
        # intensity 100 per [SEG]; this path emits one [SEG] -> index 0
        cv2.imwrite(os.path.join(args.vis_save_path,
                                 f"{stem}_mask_left0.jpg"), bl * 100)
        cv2.imwrite(os.path.join(args.vis_save_path,
                                 f"{stem}_mask_right0.jpg"), br * 100)
        overlay = overlay_results(image, bl, br)
        cv2.imwrite(os.path.join(args.vis_save_path,
                                 f"{stem}_masked_img.png"),
                    cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
        print(f"saved masks + overlay under {args.vis_save_path} "
              f"(taxonomy={tax.round(3).tolist()})")


if __name__ == "__main__":
    main()
