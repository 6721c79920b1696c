"""Side-by-side parity harness: the torch reference (HF `transformers`)
against the port on real checkpoints (port of
haff_tpu/tools/parity_check.py).

The tests prove every converted submodule on tiny random weights; this
harness runs the same comparisons on the released checkpoints once they
are present locally (nothing is downloaded: sjauhri/2HAff,
sam_vit_h_4b8939.pth and openai/clip-vit-large-patch14 come from a local
path). The port's modules run in float32 on `--device` (default cuda, the
card; `--device cpu` for the plain versions); the HF classes run on the
CPU. `--dry_run_7b` needs no checkpoint: it checks the key map at the
shipped 7B shapes.

Usage:
  python -m haff_tpu_torch.tools.parity_check --clip /path/clip_dir \\
      [--sam sam_vit_h_4b8939.pth] [--image some.jpg] [--device cpu]
  python -m haff_tpu_torch.tools.parity_check --dry_run_7b

Reports max-abs / relative deviation per stage (PASS/FAIL lines) and exits
nonzero above tolerance.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

TOL = 2e-3  # bf16-dominated stacks; fp32 stages are ~1e-4


def check(name: str, ours: np.ndarray, theirs: np.ndarray,
          tol: float = TOL) -> bool:
    d = np.abs(ours.astype(np.float64) - theirs.astype(np.float64))
    rel = d.max() / (np.abs(theirs).max() + 1e-9)
    ok = rel < tol
    print(f"{'PASS' if ok else 'FAIL'} {name}: max abs {d.max():.3e} "
          f"rel {rel:.3e}")
    return ok


def _clip_cfg_from_hf(hfc):
    """The port's ClipVisionConfig from the checkpoint's own HF config: any
    CLIP size (the real L/14 checkpoint or a tiny local one)."""
    from ..core.config import ClipVisionConfig

    return ClipVisionConfig(
        image_size=hfc.image_size, patch_size=hfc.patch_size,
        hidden_size=hfc.hidden_size,
        intermediate_size=hfc.intermediate_size,
        num_layers=hfc.num_hidden_layers,
        num_heads=hfc.num_attention_heads)


def _sam_cfg_from_sd(sd):
    """SamEncoderConfig from an original-layout SAM state dict: the
    released ViT-H/L/B checkpoints by embed_dim; other sizes by shape."""
    from ..core.config import SamEncoderConfig

    embed = sd["image_encoder.patch_embed.proj.weight"].shape[0]
    by_dim = {1280: "vit_h", 1024: "vit_l", 768: "vit_b"}
    if embed in by_dim:
        return SamEncoderConfig.preset(by_dim[embed])
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("image_encoder.blocks."))
    patch = sd["image_encoder.patch_embed.proj.weight"].shape[-1]
    pe = sd["image_encoder.pos_embed"]          # (1, g, g, embed)
    out_chans = sd["image_encoder.neck.0.weight"].shape[0]
    # Global blocks carry the larger (2 * grid - 1) rel tables; the window
    # size comes from the smallest table across blocks.
    grid = pe.shape[1]
    rels = [sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape[0]
            for i in range(depth)]
    window = (min(rels) + 1) // 2
    glob = tuple(i for i, r in enumerate(rels) if r == 2 * grid - 1)
    return SamEncoderConfig(
        image_size=grid * patch, patch_size=patch, embed_dim=embed,
        depth=depth, num_heads=max(1, embed // 64),
        out_chans=out_chans, window_size=window,
        global_attn_indexes=glob)


class _TrackingDict(dict):
    """A state dict that records key reads: checkpoint keys left unread
    after conversion are key-map drift."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if super().__contains__(k):
            self.read.add(k)
        return super().get(k, default)


def _shipped_7b_state_dict():
    """A shape-exact synthetic state dict in the shipped `sjauhri/2HAff`
    layout (merge_lora_weights_and_save_hf_model.py output): HF LLaMA-7B
    keys + mm_projector + text_hidden_fcs + original-layout SAM ViT-H under
    model.visual_model with the left/right decoders and the left decoder's
    taxonomy head; no vision_tower keys. Key names and shapes come from
    meta-device instances of the HF classes; values are lazily allocated
    float16 zeros (the dry run reads shapes only)."""
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM
    from transformers import SamConfig, SamModel
    from transformers.models.sam import (SamMaskDecoderConfig,
                                         SamPromptEncoderConfig,
                                         SamVisionConfig)

    from .convert_weights import hf_sam_to_original

    # LLaMA-7B with the reference's extended vocabulary: 32000 + [SEG] +
    # <im_start>/<im_end>/<im_patch> (train_ds.py:135-149).
    lcfg = LlamaConfig(vocab_size=32004, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=32,
                       num_attention_heads=32)
    with torch.device("meta"):
        llama = LlamaForCausalLM(lcfg)
    sd = {k: np.zeros(tuple(v.shape), np.float16)
          for k, v in llama.state_dict().items()}
    del llama

    # ViT-H SAM (sam_vit_h_4b8939.pth geometry) from HF SamModel, renamed
    # to the original layout of the shipped .pth.
    scfg = SamConfig(
        vision_config=SamVisionConfig(
            hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
            global_attn_indexes=[7, 15, 23, 31], mlp_dim=5120),
        prompt_encoder_config=SamPromptEncoderConfig(),
        mask_decoder_config=SamMaskDecoderConfig())
    with torch.device("meta"):
        sam = SamModel(scfg)
    hf_sam = {k: np.zeros(tuple(v.shape), np.float16)
              for k, v in sam.state_dict().items()}
    del sam
    orig = hf_sam_to_original(hf_sam)
    # the positional embedding is a persistent buffer of the .pth
    if "image_encoder.pos_embed" not in orig:
        orig["image_encoder.pos_embed"] = np.zeros((1, 64, 64, 1280),
                                                   np.float16)
    for k, v in orig.items():
        if k.startswith("mask_decoder."):
            sd[f"model.visual_model.mask_decoder_left.{k[13:]}"] = v
            sd[f"model.visual_model.mask_decoder_right.{k[13:]}"] = v
        else:
            sd[f"model.visual_model.{k}"] = v
    # taxonomy head: MLP 4*256 -> 4*256 -> 4 on the left decoder
    # (reference mask_decoder.py:75-77, build_sam.py:92-117)
    for j, (o, i) in enumerate(((1024, 1024), (1024, 1024), (4, 1024))):
        sd["model.visual_model.mask_decoder_left."
           f"taxonomy_embed.layers.{j}.weight"] = np.zeros((o, i),
                                                           np.float16)
        sd["model.visual_model.mask_decoder_left."
           f"taxonomy_embed.layers.{j}.bias"] = np.zeros((o,), np.float16)

    sd["model.mm_projector.weight"] = np.zeros((4096, 1024), np.float16)
    sd["model.mm_projector.bias"] = np.zeros((4096,), np.float16)
    # text_hidden_fcs: Linear(4096, 4096), ReLU, Linear(4096, 256), Dropout
    # (LISA.py:91-104)
    sd["model.text_hidden_fcs.0.0.weight"] = np.zeros((4096, 4096),
                                                      np.float16)
    sd["model.text_hidden_fcs.0.0.bias"] = np.zeros((4096,), np.float16)
    sd["model.text_hidden_fcs.0.2.weight"] = np.zeros((256, 4096),
                                                      np.float16)
    sd["model.text_hidden_fcs.0.2.bias"] = np.zeros((256,), np.float16)
    return _TrackingDict(sd)


def convert_tracked(sd: _TrackingDict, llama_layers: int, sam_depth: int):
    """convert_2haff over a tracked state dict; afterwards `sd.read` holds
    every key the conversion consumed (the SAM keys, which convert_2haff
    reads through a plain dict, recovered by converting a tracked view)."""
    from .convert_weights import convert_2haff, convert_sam

    conv = convert_2haff(sd, llama_layers=llama_layers, sam_depth=sam_depth)
    pfx = "model.visual_model."
    sam_view = _TrackingDict({k[len(pfx):]: v for k, v in dict.items(sd)
                              if k.startswith(pfx)})
    convert_sam(sam_view, depth=sam_depth)
    sd.read |= {pfx + k for k in sam_view.read}
    return conv


def write_tiny_checkpoints(out_dir: str, seed: int = 0):
    """A tiny HF CLIPVisionModel directory and a tiny original-layout SAM
    `.pth` (HF SamModel's keys renamed) with seeded weights, to run the
    harness on where no released checkpoint is present (the SAM weights
    are redrawn at normal(0, 0.1): HF's init leaves the tiny encoder's
    output near 0). Returns (clip_dir, sam_pth); run them with
    `--sam_heads 1`."""
    import os

    import torch
    from transformers import (CLIPVisionConfig, CLIPVisionModel, SamConfig,
                              SamModel)

    from .convert_weights import hf_sam_to_original

    torch.manual_seed(seed)
    clip_dir = os.path.join(out_dir, "clip")
    CLIPVisionModel(CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=2, image_size=64, patch_size=16,
        hidden_act="quick_gelu")).save_pretrained(clip_dir)
    scfg = SamConfig()
    v = scfg.vision_config
    v.hidden_size, v.num_hidden_layers, v.num_attention_heads = 64, 2, 1
    v.mlp_dim, v.image_size, v.patch_size, v.window_size = 256, 128, 16, 4
    v.global_attn_indexes, v.output_channels, v.num_pos_feats = [1], 64, 32
    pe, md = scfg.prompt_encoder_config, scfg.mask_decoder_config
    pe.hidden_size, pe.image_size, pe.patch_size = 64, 128, 16
    pe.image_embedding_size = 8
    md.hidden_size, md.mlp_dim, md.iou_head_hidden_dim = 64, 128, 64
    sam = SamModel(scfg)
    with torch.no_grad():
        for t in sam.parameters():
            t.normal_(0.0, 0.1)
    sam_pth = os.path.join(out_dir, "sam_tiny.pth")
    torch.save({k: torch.tensor(t) for k, t in hf_sam_to_original(
        {k: t.numpy() for k, t in sam.state_dict().items()}).items()},
        sam_pth)
    return clip_dir, sam_pth


def dry_run_7b() -> int:
    """Key-map and vocabulary-drift gate at the shipped 7B shapes: convert
    the synthetic 2HAff-layout state dict and require (a) every checkpoint
    key consumed, (b) every converted leaf a parameter of the port's 7b
    LisaModel (vocabulary 32004, built on the meta device) with its shape,
    (c) every parameter covered but the LoRA adapters and the CLIP tower.
    Nothing 7B-sized is materialized."""
    import torch

    from ..core.config import ModelConfig
    from ..model.lisa import LisaModel
    from .bridge import flax_to_state_shapes

    sd = _shipped_7b_state_dict()
    conv = convert_tracked(sd, llama_layers=32, sam_depth=32)
    unread = {k for k in sd if k not in sd.read}
    # rotary / cache buffers have no learned content; nothing else may stay
    unread = {k for k in unread if "rotary_emb" not in k
              and "inv_freq" not in k}
    if unread:
        print(f"FAIL dry_run_7b: {len(unread)} shipped keys never read "
              f"(first: {sorted(unread)[:5]})")
        return 1

    base = ModelConfig.preset("7b")
    cfg = base.replace(llama=dataclasses.replace(base.llama,
                                                 vocab_size=32004))
    model = LisaModel(cfg, torch.bfloat16, device="meta")
    init = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    converted = flax_to_state_shapes(conv)
    missing, mismatched = [], []
    for k, shape in converted.items():
        if k not in init:
            missing.append(k)
        elif init[k] != shape:
            mismatched.append((k, init[k], shape))
    # Parameters legitimately absent from the shipped checkpoint: the LoRA
    # adapters (merged out) and the CLIP tower (stripped, loaded apart).
    uncovered = [k for k in init if k not in converted
                 and "lora" not in k.lower()
                 and not k.startswith("vision_tower.")]
    ok = not missing and not mismatched and not uncovered
    print(f"{'PASS' if ok else 'FAIL'} dry_run_7b: "
          f"{len(converted)} converted leaves, "
          f"{len(missing)} homeless, {len(mismatched)} shape-mismatched, "
          f"{len(uncovered)} init params uncovered")
    for name, lst in (("homeless", missing), ("mismatched", mismatched),
                      ("uncovered", uncovered)):
        if lst:
            print(f"  first {name}: {lst[:6]}")
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clip", default=None,
                   help="local HF CLIPVisionModel dir")
    p.add_argument("--sam", default=None, help="SAM .pth checkpoint")
    p.add_argument("--sam_heads", type=int, default=None,
                   help="override inferred encoder head count "
                        "(non-released checkpoint sizes)")
    p.add_argument("--image", default=None)
    p.add_argument("--dry_run_7b", action="store_true",
                   help="key-map/vocab drift gate at shipped 7B shapes "
                        "(no checkpoints needed)")
    p.add_argument("--device", default="cuda",
                   help="where the port's modules run: cuda (the card, "
                        "default) or cpu")
    args = p.parse_args(argv)
    if args.dry_run_7b:
        sys.exit(dry_run_7b())

    import torch

    from ..infer.predictor import _require_device
    from .convert_weights import convert_clip, convert_sam, to_state_dict

    device = _require_device(args.device)
    ok = True
    if args.image:
        import cv2

        img = cv2.cvtColor(cv2.imread(args.image), cv2.COLOR_BGR2RGB)
    else:
        img = (np.random.RandomState(0).rand(480, 640, 3) * 255).astype(
            np.uint8)

    if args.clip:
        from transformers import CLIPVisionModel

        from ..data.transforms import clip_preprocess
        from ..nn.clip_vit import ClipVisionTower

        hf = CLIPVisionModel.from_pretrained(
            args.clip, local_files_only=True).eval()
        cfg = _clip_cfg_from_hf(hf.config)
        model = ClipVisionTower(cfg).float()
        sd = {k: v.numpy() for k, v in hf.state_dict().items()}
        model.load_state_dict(to_state_dict(convert_clip(
            sd, cfg.num_layers + cfg.select_layer + 1)), strict=False)
        model.to(device).eval()
        x = clip_preprocess(img, cfg.image_size)[None]
        with torch.no_grad():
            ours = model(torch.as_tensor(x, device=device)).cpu().numpy()
            out = hf(pixel_values=torch.tensor(x).permute(0, 3, 1, 2),
                     output_hidden_states=True)
        ok &= check("clip_tower(select=-2, patches)", ours,
                    out.hidden_states[-2][:, 1:].numpy())

    if args.sam:
        from ..core.config import SamDecoderConfig
        from ..data.transforms import sam_preprocess
        from ..nn.sam import Sam
        from .convert_weights import load_state_dict

        sd = load_state_dict(args.sam)
        enc_cfg = _sam_cfg_from_sd(sd)
        if args.sam_heads:
            enc_cfg = dataclasses.replace(enc_cfg, num_heads=args.sam_heads)
        dec_kw = {}
        if "mask_decoder.iou_token.weight" in sd:
            dec_kw["prompt_embed_dim"] = \
                sd["mask_decoder.iou_token.weight"].shape[-1]
        if "mask_decoder.iou_prediction_head.layers.0.weight" in sd:
            dec_kw["iou_head_hidden_dim"] = sd[
                "mask_decoder.iou_prediction_head.layers.0.weight"].shape[0]
        if "mask_decoder.transformer.layers.0.mlp.lin1.weight" in sd:
            dec_kw["transformer_mlp_dim"] = sd[
                "mask_decoder.transformer.layers.0.mlp.lin1.weight"].shape[0]
        if "prompt_encoder.mask_downscaling.0.weight" in sd:
            dec_kw["mask_in_chans"] = 4 * sd[
                "prompt_encoder.mask_downscaling.0.weight"].shape[0]
        dec_cfg = SamDecoderConfig(**dec_kw)
        model = Sam(enc_cfg, dec_cfg).float()
        model.load_state_dict(to_state_dict(convert_sam(sd, enc_cfg.depth)),
                              strict=False)
        model.to(device).eval()
        S = enc_cfg.image_size
        canvas, _ = sam_preprocess(img, S)
        with torch.no_grad():
            emb = model.encode_image(torch.as_tensor(
                canvas, device=device)[None]).cpu().numpy()
        print(f"SAM embedding stats: mean {emb.mean():.3e} "
              f"std {emb.std():.3e} (compare against the torch reference "
              f"run of the same checkpoint)")
        # The HF SamModel of the matching size encodes the same canvas
        # (checkpoints exported from HF SamModel; the original .pth of a
        # size HF cannot represent has no torch-side runner here).
        theirs = _torch_sam_encode(sd, enc_cfg, canvas)
        if theirs is not None:
            ok &= check("sam_image_encoder", np.transpose(emb, (0, 3, 1, 2)),
                        theirs)

    sys.exit(0 if ok else 1)


def _torch_sam_encode(sd, enc_cfg, canvas):
    """The HF side's encoder run: an HF SamModel of the matching size,
    rebuilt from the original-layout state dict (the inverse of
    hf_sam_to_original for the vision tower), on the same canvas. Returns
    None when the HF architecture cannot represent the config."""
    import torch
    from transformers import SamConfig, SamModel

    scfg = SamConfig()
    v = scfg.vision_config
    v.hidden_size = enc_cfg.embed_dim
    v.num_hidden_layers = enc_cfg.depth
    v.num_attention_heads = enc_cfg.num_heads
    v.mlp_dim = int(enc_cfg.embed_dim * enc_cfg.mlp_ratio)
    v.image_size = enc_cfg.image_size
    v.patch_size = enc_cfg.patch_size
    v.window_size = enc_cfg.window_size
    v.global_attn_indexes = list(enc_cfg.global_attn_indexes)
    v.output_channels = enc_cfg.out_chans
    m = SamModel(scfg).eval()
    # original layout -> HF vision_encoder keys
    ren = {}
    for k, val in sd.items():
        if not k.startswith("image_encoder."):
            continue
        hk = "vision_encoder." + k[len("image_encoder."):]
        hk = hk.replace("blocks.", "layers.")
        hk = hk.replace(".norm1.", ".layer_norm1.")
        hk = hk.replace(".norm2.", ".layer_norm2.")
        hk = hk.replace("neck.0.", "neck.conv1.")
        hk = hk.replace("neck.1.", "neck.layer_norm1.")
        hk = hk.replace("neck.2.", "neck.conv2.")
        hk = hk.replace("neck.3.", "neck.layer_norm2.")
        hk = hk.replace("patch_embed.proj.", "patch_embed.projection.")
        ren[hk] = torch.tensor(val)
    missing = [k for k in m.vision_encoder.state_dict()
               if "vision_encoder." + k not in ren]
    if missing:
        return None
    m.vision_encoder.load_state_dict(
        {k[len("vision_encoder."):]: v for k, v in ren.items()})
    with torch.no_grad():
        pix = torch.tensor(canvas)[None].permute(0, 3, 1, 2)
        return m.vision_encoder(pix).last_hidden_state.numpy()


if __name__ == "__main__":
    main()
