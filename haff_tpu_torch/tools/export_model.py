"""Serialized model export (port of haff_tpu/tools/export_model.py), the
analog of the reference's ONNX export wrapper (reference
segment_anything/utils/onnx.py:17-157, SamOnnxModel).

A component is exported with `torch.export.export` and written with
`torch.export.save` as a `.pt2` (the graph and the weights), beside a JSON
manifest. The SAM attention kernels appear in the graph as the custom ops
`haff::sam_window_relpos_attn` and `haff::sam_global_relpos_attn`
(kernels/sam_attention.py), so a loaded program runs the same kernels in
the same order as the eager model. `load_exported` imports that op
registry, not the model code.

Components (JAX's signatures; float32 inputs, NHWC images):
  * decoder: (image_embeddings (B, g, g, C), text_embed (B, 1, E)) ->
    (masks_left, masks_right, iou_left, iou_right, taxonomy)
  * encoder: (preprocessed (B, S, S, 3) images) -> image embeddings
  * mask_path: (images, text_embed) -> canvas-resolution (B, 1, S, S) dual
    masks + taxonomy (encoder, decoder and upsampling in one program)

Usage:
  python -m haff_tpu_torch.tools.export_model --component mask_path \\
      --out mask_path.pt2 [--model_preset 7b] [--checkpoint P.npz|DIR] \\
      [--batch 1] [--precision bf16] [--device cuda]

`--checkpoint` takes the flat `.npz` of haff_tpu/tools/export_params.py or
tools/export_params.py (the SAM under `visual_model`, or a bare Sam
tree), or a `ckpt_model` directory of the port's train CLI; without one
the weights are drawn from a generator seeded 0. An orbax directory
raises. The export runs on `--device`, the card unless asked for the
CPU; the program is tied to that device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

COMPONENTS = ("encoder", "decoder", "mask_path")
FORMAT = "torch.export/pt2"


def build_sam(model_preset: str, checkpoint: Optional[str], precision: str,
              device="cuda"):
    """(cfg, Sam in eval mode on `device`) with the weights `checkpoint`
    names, or drawn from a generator seeded 0."""
    from ..core.config import ModelConfig
    from ..infer.predictor import _require_device
    from ..model.lisa import init_random_
    from ..nn.sam import Sam

    device = _require_device(device)
    cfg = ModelConfig.preset(model_preset)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    if checkpoint and os.path.isdir(checkpoint):
        from ..train.checkpoints import load_trained_model

        sam = load_trained_model(checkpoint, cfg, precision,
                                 device).visual_model
        return cfg, sam.eval()
    with torch.device("meta"):
        sam = Sam(cfg.sam_encoder, cfg.sam_decoder)
    sam = sam.to(dtype).to_empty(device=device)
    if checkpoint:
        if not checkpoint.endswith(".npz"):
            raise NotImplementedError(
                f"{checkpoint}: neither an export .npz nor a checkpoint "
                "directory of the port's train CLI")
        from .bridge import load_jax_params, load_npz

        tree = load_npz(checkpoint)
        load_jax_params(sam, tree, scope="visual_model"
                        if "visual_model" in tree else None)
    else:
        with torch.no_grad():
            init_random_(sam, torch.Generator(device).manual_seed(0))
    return cfg, sam.eval()


class _Component(torch.nn.Module):
    """One component of a Sam as a module with tensor inputs and outputs."""

    def __init__(self, sam, component: str, image_size: int):
        super().__init__()
        self.sam, self.component, self.image_size = sam, component, image_size

    def forward(self, *args):
        from ..nn.sam import postprocess_masks_padded

        if self.component == "encoder":
            return self.sam.encode_image(args[0])
        if self.component == "decoder":
            return self.sam.decode_masks(*args)
        images, text = args
        masks_l, masks_r, _, _, tax = self.sam.decode_masks(
            self.sam.encode_image(images), text)
        S = self.image_size
        return (postprocess_masks_padded(masks_l.float(), S),
                postprocess_masks_padded(masks_r.float(), S), tax)


def example_inputs(cfg, component: str, batch: int = 1, device="cuda",
                   generator: Optional[torch.Generator] = None):
    """Float32 inputs of `component` at the config's shapes: zeros, or
    standard normal draws from `generator`."""
    S = cfg.sam_encoder.image_size
    G = cfg.sam_encoder.grid_size
    C = cfg.sam_encoder.out_chans
    E = cfg.sam_decoder.prompt_embed_dim
    shapes = {"encoder": [(batch, S, S, 3)],
              "decoder": [(batch, G, G, C), (batch, 1, E)],
              "mask_path": [(batch, S, S, 3), (batch, 1, E)]}[component]
    if generator is None:
        return tuple(torch.zeros(s, device=device) for s in shapes)
    return tuple(torch.randn(s, generator=generator, device=device)
                 for s in shapes)


def export_sam_component(sam, cfg, component: str, batch: int = 1):
    """torch.export of one component of a built Sam, on its device."""
    if component not in COMPONENTS:
        raise ValueError(f"unknown component {component!r}")
    device = next(sam.parameters()).device
    module = _Component(sam, component, cfg.sam_encoder.image_size).eval()
    with torch.no_grad():
        return torch.export.export(
            module, example_inputs(cfg, component, batch, device))


def export_component(component: str, model_preset: str = "7b",
                     checkpoint: Optional[str] = None, batch: int = 1,
                     precision: str = "bf16", device="cuda"):
    """The ExportedProgram of `component` (JAX's `export_component`
    arguments; the program in place of its serialized bytes)."""
    cfg, sam = build_sam(model_preset, checkpoint, precision, device)
    return export_sam_component(sam, cfg, component, batch)


def save_exported(program, out: str, manifest: dict) -> int:
    """Write `program` to `out` (torch.export.save) and the manifest, with
    "bytes" and "format" added, to `out + ".json"`. Returns the bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(out)) or ".", exist_ok=True)
    torch.export.save(program, out)
    size = os.path.getsize(out)
    with open(out + ".json", "w") as f:
        json.dump(dict(manifest, bytes=size, format=FORMAT), f, indent=2)
    return size


def load_exported(path: str):
    """A saved component as a callable module. Imports the SAM kernels'
    op registry (kernels/sam_attention.py) and no model code, and sets
    the float32 precision the eager model runs at (no TF32 convolutions:
    core/dtypes.py), which a saved program does not carry."""
    from ..core.dtypes import set_reference_precision
    from ..kernels import sam_attention  # noqa: F401  (registers haff::*)

    set_reference_precision()
    return torch.export.load(path).module()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--component", default="decoder", choices=COMPONENTS)
    p.add_argument("--out", required=True)
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    program = export_component(args.component, args.model_preset,
                               args.checkpoint, args.batch, args.precision,
                               args.device)
    size = save_exported(program, args.out, {
        "component": args.component, "model_preset": args.model_preset,
        "batch": args.batch, "precision": args.precision,
        "device": str(torch.device(args.device))})
    print(f"wrote {args.out} ({size} bytes) + manifest")


if __name__ == "__main__":
    main()
