"""Export a train checkpoint to standalone serving params (port of
haff_tpu/tools/export_params.py).

A checkpoint of the port's train CLI holds only the TRAINABLE tensors
(LoRA adapters, heads, mask decoders) beside a model.json that says how
the run built its model. This tool rebuilds that model on `--device` as
the Predictor does (train/checkpoints.py `load_trained_model`: the run's
seeded init drawn on the device type it trained on, then the trained
tensors), takes its parameters into the JAX scope layout
(tools/bridge.py `state_dict_to_flax`), folds LoRA into the base kernels
(tools/merge_lora.py) and saves one flat `.npz` (bfloat16 as "::bf16"
bit patterns): the layout haff_tpu's `load_exported_params` and the
port's `Predictor(checkpoint=...)` read.

Usage:
  python -m haff_tpu_torch.tools.export_params --ckpt_dir runs/x/ckpt_model \\
      --out artifacts/x_params.npz [--dtype bfloat16] [--no_merge_lora] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def export_params(ckpt_dir: str, out: str, model_preset: Optional[str] = None,
                  dtype: str = "bfloat16", merge_lora: bool = True,
                  device="cuda") -> str:
    """Write the served model of `ckpt_dir` to `out`; `model_preset`, when
    given, must be the run's. Returns `out`."""
    from ..core.config import ModelConfig
    from ..infer.predictor import _require_device
    from ..train import checkpoints as C
    from .bridge import save_npz, state_dict_to_flax
    from .merge_lora import merge_lora_params

    device = _require_device(device)
    d = C.step_dir(ckpt_dir) if os.path.isdir(ckpt_dir) else None
    meta = C.read_json(os.path.join(d, C.MODEL)) if d else None
    if meta is None:
        raise SystemExit(f"no checkpoint with {C.MODEL} under {ckpt_dir}")
    if model_preset and model_preset != meta["model_preset"]:
        raise SystemExit(f"--model_preset {model_preset}: the run trained "
                         f"{meta['model_preset']}")
    cfg = ModelConfig.preset(meta["model_preset"]).replace(
        decoder=meta.get("decoder", "llama"))
    model = C.load_trained_model(ckpt_dir, cfg, meta["precision"], device)
    tree = state_dict_to_flax(model)
    del model
    if merge_lora:
        tree = merge_lora_params(tree, alpha=float(meta["llama"]["lora_alpha"]))
    n = save_npz(tree, out, dtype)
    print(f"exported step {os.path.basename(d)}: {n} arrays -> {out} "
          f"({os.path.getsize(out) / 1e6:.1f} MB)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--model_preset", default=None,
                   help="checked against the run's (model.json)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no_merge_lora", dest="merge_lora", action="store_false",
                   help="keep the LoRA adapters beside the base kernels")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    export_params(args.ckpt_dir, args.out, args.model_preset, args.dtype,
                  args.merge_lora, args.device)


if __name__ == "__main__":
    main()
