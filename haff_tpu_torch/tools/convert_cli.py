"""Weight conversion CLI: reference checkpoints -> the port's `.npz`
(port of haff_tpu/tools/convert_cli.py, which writes orbax params).

Usage:
  python -m haff_tpu_torch.tools.convert_cli --preset 7b --out haff7b.npz \\
      [--lisa /path/2haff_hf_dir_or_file] [--sam sam_vit_h_4b8939.pth] \\
      [--clip clip_vision_model.(bin|safetensors)] [--dtype bfloat16]

Starts from the preset's model with weights drawn from a generator seeded
`--seed`, overlays every provided checkpoint (merged 2HAff export, stock
SAM with left/right duplication, HF CLIP vision tower; the conversions of
tools/convert_weights.py) and writes the whole model as the flat export
`.npz` (tools/bridge.py `save_npz`) that `Predictor(checkpoint=...)`, the
train CLI's `--pretrained_params` and haff_tpu's `load_exported_params`
read. All loads are local files; a host tool: the model is built on the
CPU.
"""

from __future__ import annotations

import argparse
import glob
import os


def load_any(path: str):
    from .convert_weights import load_state_dict

    if os.path.isdir(path):
        sd = {}
        for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))
                        + glob.glob(os.path.join(path, "*.bin"))):
            sd.update(load_state_dict(f))
        return sd
    return load_state_dict(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="7b")
    p.add_argument("--out", required=True)
    p.add_argument("--lisa", default=None,
                   help="merged 2HAff HF checkpoint (dir or file)")
    p.add_argument("--sam", default=None, help="SAM .pth checkpoint")
    p.add_argument("--clip", default=None, help="HF CLIP vision weights")
    p.add_argument("--hf_sam_layout", action="store_true",
                   help="--sam uses HF SamModel key names")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32",
                   choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    import torch

    from ..core.config import ModelConfig
    from ..model.lisa import LisaModel
    from .bridge import save_npz, state_dict_to_flax
    from .convert_weights import (convert_2haff, convert_clip, convert_sam,
                                  hf_sam_to_original, merge_into_init)

    cfg = ModelConfig.preset(args.preset)
    model = LisaModel(cfg, torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(args.seed))
    if args.lisa:
        merge_into_init(model, convert_2haff(
            load_any(args.lisa), llama_layers=cfg.llama.num_layers,
            sam_depth=cfg.sam_encoder.depth))
        print("overlaid 2HAff checkpoint")
    if args.sam:
        sd = load_any(args.sam)
        if args.hf_sam_layout:
            sd = hf_sam_to_original(sd)
        merge_into_init(model, {"visual_model": convert_sam(
            sd, depth=cfg.sam_encoder.depth)})
        print("overlaid SAM checkpoint (decoders duplicated)")
    if args.clip:
        n_used = cfg.clip.num_layers + cfg.clip.select_layer + 1
        merge_into_init(model, {"vision_tower": convert_clip(
            load_any(args.clip), n_used)})
        print("overlaid CLIP vision tower")
    n = save_npz(state_dict_to_flax(model), args.out, args.dtype)
    print(f"saved converted params ({n} arrays) to {args.out}")


if __name__ == "__main__":
    main()
