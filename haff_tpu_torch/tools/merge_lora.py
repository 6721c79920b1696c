"""Merge LoRA adapters into base weights and export (port of
haff_tpu/tools/merge_lora.py).

Capability parity with reference merge_lora_weights_and_save_hf_model.py:
fold q/v LoRA deltas into the base kernels (W += (alpha / r) * A @ B),
drop the adapter parameters and the (frozen, separately loadable) vision
tower, and save a deployable checkpoint: here the flat export `.npz`
(tools/bridge.py `save_npz`, the layout haff_tpu's export_params writes),
which the port's Predictor and haff_tpu's `load_exported_params` read.

Trees are JAX-scope nested dicts of numpy arrays. A host tool: nothing
runs on a device.

Usage:
  python -m haff_tpu_torch.tools.merge_lora --checkpoint P.npz --out M.npz
  python -m haff_tpu_torch.tools.merge_lora --checkpoint runs/x/ckpt_model \\
      --base_params BASE.npz --out M.npz
      [--lora_alpha 16] [--keep_vision_tower] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np


def merge_lora_params(params: Dict, alpha: float = 16.0) -> Dict:
    """Fold every {q,v}_proj/{lora_a, lora_b} pair into its sibling
    base/kernel: kernel (in, out) += (alpha / r) * lora_a (in, r) @
    lora_b (r, out); returns a tree with no LoRA parameters left."""
    from .bridge import flatten_tree, unflatten_tree

    flat = flatten_tree(params)
    out = dict(flat)
    merged = 0
    for k in flat:
        if not k.endswith("/lora_a"):
            continue
        scope = k[: -len("lora_a")]
        a = np.asarray(flat[k])
        b = np.asarray(flat[scope + "lora_b"])
        base_key = scope + "base/kernel"
        rank = a.shape[1]
        out[base_key] = np.asarray(flat[base_key]) + (alpha / rank) * (a @ b)
        del out[scope + "lora_a"]
        del out[scope + "lora_b"]
        merged += 1
    print(f"merged {merged} LoRA adapter pairs")
    return unflatten_tree(out)


def strip_vision_tower(params: Dict) -> Dict:
    """Drop vision_tower.* like the reference export (the CLIP tower is
    re-loaded from its own pretrained checkpoint at serve time)."""
    return {k: v for k, v in params.items() if k != "vision_tower"}


def trainable_tree(ckpt: str) -> Dict:
    """The trainable tensors of a train-CLI checkpoint (its root or one
    step's directory) as a JAX-scope tree, named through the run's model
    built on the meta device (no weights drawn) from its model.json."""
    import dataclasses

    import torch

    from ..core.config import ModelConfig
    from ..model.lisa import LisaModel
    from ..train import checkpoints as C
    from .bridge import state_dict_to_flax

    d = C.step_dir(ckpt)
    if d is None:
        raise NotImplementedError(
            f"{ckpt}: no checkpoint of the port's train CLI (a step "
            f"directory with {C.STATE}); orbax checkpoints are not read")
    meta = C.read_json(os.path.join(d, C.MODEL))
    if meta is None:
        raise ValueError(f"{d}: no {C.MODEL}")
    cfg = ModelConfig.preset(meta["model_preset"])
    llama = dict(meta["llama"], lora_targets=tuple(meta["llama"]["lora_targets"]))
    cfg = cfg.replace(decoder=meta.get("decoder", "llama"),
                      llama=dataclasses.replace(cfg.llama, **llama))
    model = LisaModel(cfg, torch.float32, device="meta",
                      generator=torch.Generator())
    snap = torch.load(os.path.join(d, C.STATE), map_location="cpu",
                      weights_only=True)
    return state_dict_to_flax(model, snap["trainable"]), meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="a flat export .npz of the whole model, or a "
                        "ckpt_model directory of the port's train CLI "
                        "(its trainable tensors; needs --base_params)")
    p.add_argument("--base_params", default=None,
                   help="flat .npz of the full model the adapters trained "
                        "against (tools/convert_cli.py or export_params "
                        "output); the trainable tensors are overlaid on it")
    p.add_argument("--out", required=True)
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="default: the run's (model.json), else 16")
    p.add_argument("--keep_vision_tower", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    from .bridge import flatten_tree, load_npz, save_npz, unflatten_tree

    alpha = args.lora_alpha
    if os.path.isdir(args.checkpoint):
        if not args.base_params:
            raise SystemExit(
                "--checkpoint holds only the trainable tensors (adapters "
                "without base kernels); pass --base_params with the full "
                "model's .npz")
        trained, meta = trainable_tree(args.checkpoint)
        if alpha is None:
            alpha = float(meta["llama"]["lora_alpha"])
        flat = flatten_tree(load_npz(args.base_params))
        flat.update(flatten_tree(trained))
        params = unflatten_tree(flat)
    else:
        params = load_npz(args.checkpoint)
        flat = flatten_tree(params)
        if (any(k.endswith("/lora_a") for k in flat)
                and not any(k.endswith("/base/kernel") for k in flat)):
            raise SystemExit("--checkpoint holds adapters without base "
                             "kernels; pass the full model's .npz")
    params = merge_lora_params(params, alpha=16.0 if alpha is None else alpha)
    if not args.keep_vision_tower:
        params = strip_vision_tower(params)
    n = save_npz(params, args.out, args.dtype)
    print(f"saved merged params ({n} arrays) to {args.out}")


if __name__ == "__main__":
    main()
