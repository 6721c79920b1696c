"""PyTorch state dicts -> the port's parameters (port of
haff_tpu/tools/convert_weights.py; numpy, the same conversions).

Loads, from local files only (torch CPU load / safetensors; nothing is
fetched):

  * the merged HF-format 2HAff checkpoint (sjauhri/2HAff layout:
    LlamaForCausalLM keys + model.mm_projector + model.text_hidden_fcs +
    model.visual_model.* — produced by
    merge_lora_weights_and_save_hf_model.py),
  * a raw SAM checkpoint (sam_vit_h_4b8939.pth layout), duplicating the
    single pretrained mask_decoder into mask_decoder_left/right exactly
    like reference build_sam.py:125-136,
  * an HF CLIPVisionModel state dict (openai/clip-vit-large-patch14).

Each `convert_*` returns the JAX package's parameter tree (nested dicts
of numpy arrays, flax scope names and layouts: Dense (in, out), NHWC
convolutions), equal to haff_tpu's conversion; `to_state_dict` carries
it through tools/bridge.py into the port's state_dict names and layouts,
and `merge_into_init` overlays it onto a built model. `convert_mpt` maps
a mosaicml/HF MPT state dict to nn/mpt.MptForCausalLM's tree.

Layout conversions: torch Linear (out,in) -> Dense kernel (in,out);
Conv2d (out,in,kh,kw) -> NHWC Conv kernel (kh,kw,in,out);
ConvTranspose2d (in,out,kh,kw) -> ConvTranspose kernel (kh,kw,in,out).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np


def t_linear(w):  # torch (out, in) -> (in, out)
    return np.asarray(w).T


def t_conv(w):  # torch (out, in, kh, kw) -> (kh, kw, in, out)
    return np.asarray(w).transpose(2, 3, 1, 0)


def t_convT(w):
    # torch ConvTranspose2d (in, out, kh, kw) -> flax ConvTranspose with
    # transpose_kernel=True expects (kh, kw, out, in); this combination is
    # numerically exact (see tests/test_convert_parity.py).
    return np.asarray(w).transpose(2, 3, 1, 0)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch .pth/.bin or .safetensors file to numpy."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# SAM (original checkpoint layout)
# ---------------------------------------------------------------------------

def convert_sam(sd: Dict[str, np.ndarray], depth: int,
                dup_decoders: bool = True) -> Dict:
    """Original SAM keys -> our Sam flax params. When the checkpoint has a
    single `mask_decoder.*` (stock SAM), its weights are duplicated into
    both left/right decoders (reference build_sam.py:125-136); taxonomy
    head params (absent in stock SAM) are left out for the caller to keep
    from init."""
    p: Dict = {}

    def put(path, val):
        d = p
        parts = path.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = np.asarray(val)

    enc = "image_encoder."
    put("image_encoder/patch_embed/kernel",
        t_conv(sd[enc + "patch_embed.proj.weight"]))
    put("image_encoder/patch_embed/bias", sd[enc + "patch_embed.proj.bias"])
    pos = sd[enc + "pos_embed"]  # torch (1, g, g, C) already channels-last
    put("image_encoder/pos_embed", pos)
    for i in range(depth):
        b = f"{enc}blocks.{i}."
        o = f"image_encoder/blocks_{i}"
        put(f"{o}/norm1/scale", sd[b + "norm1.weight"])
        put(f"{o}/norm1/bias", sd[b + "norm1.bias"])
        put(f"{o}/norm2/scale", sd[b + "norm2.weight"])
        put(f"{o}/norm2/bias", sd[b + "norm2.bias"])
        put(f"{o}/attn/qkv/kernel", t_linear(sd[b + "attn.qkv.weight"]))
        put(f"{o}/attn/qkv/bias", sd[b + "attn.qkv.bias"])
        put(f"{o}/attn/proj/kernel", t_linear(sd[b + "attn.proj.weight"]))
        put(f"{o}/attn/proj/bias", sd[b + "attn.proj.bias"])
        if b + "attn.rel_pos_h" in sd:
            put(f"{o}/attn/rel_pos_h", sd[b + "attn.rel_pos_h"])
            put(f"{o}/attn/rel_pos_w", sd[b + "attn.rel_pos_w"])
        put(f"{o}/mlp/lin1/kernel", t_linear(sd[b + "mlp.lin1.weight"]))
        put(f"{o}/mlp/lin1/bias", sd[b + "mlp.lin1.bias"])
        put(f"{o}/mlp/lin2/kernel", t_linear(sd[b + "mlp.lin2.weight"]))
        put(f"{o}/mlp/lin2/bias", sd[b + "mlp.lin2.bias"])
    put("image_encoder/neck_conv1/kernel", t_conv(sd[enc + "neck.0.weight"]))
    put("image_encoder/neck_ln1/weight", sd[enc + "neck.1.weight"])
    put("image_encoder/neck_ln1/bias", sd[enc + "neck.1.bias"])
    put("image_encoder/neck_conv2/kernel", t_conv(sd[enc + "neck.2.weight"]))
    put("image_encoder/neck_ln2/weight", sd[enc + "neck.3.weight"])
    put("image_encoder/neck_ln2/bias", sd[enc + "neck.3.bias"])

    pe = "prompt_encoder."
    put("prompt_encoder/pe_layer/positional_encoding_gaussian_matrix",
        sd[pe + "pe_layer.positional_encoding_gaussian_matrix"])
    pts = np.stack([sd[pe + f"point_embeddings.{i}.weight"][0]
                    for i in range(4)])
    put("prompt_encoder/point_embeddings", pts)
    put("prompt_encoder/not_a_point_embed",
        sd[pe + "not_a_point_embed.weight"])
    put("prompt_encoder/no_mask_embed", sd[pe + "no_mask_embed.weight"])
    put("prompt_encoder/mask_conv1/kernel",
        t_conv(sd[pe + "mask_downscaling.0.weight"]))
    put("prompt_encoder/mask_conv1/bias", sd[pe + "mask_downscaling.0.bias"])
    put("prompt_encoder/mask_ln1/weight", sd[pe + "mask_downscaling.1.weight"])
    put("prompt_encoder/mask_ln1/bias", sd[pe + "mask_downscaling.1.bias"])
    put("prompt_encoder/mask_conv2/kernel",
        t_conv(sd[pe + "mask_downscaling.3.weight"]))
    put("prompt_encoder/mask_conv2/bias", sd[pe + "mask_downscaling.3.bias"])
    put("prompt_encoder/mask_ln2/weight", sd[pe + "mask_downscaling.4.weight"])
    put("prompt_encoder/mask_ln2/bias", sd[pe + "mask_downscaling.4.bias"])
    put("prompt_encoder/mask_conv3/kernel",
        t_conv(sd[pe + "mask_downscaling.6.weight"]))
    put("prompt_encoder/mask_conv3/bias", sd[pe + "mask_downscaling.6.bias"])

    has_lr = any(k.startswith("mask_decoder_left.") for k in sd)
    sides = (("mask_decoder_left", "mask_decoder_left.")
             if has_lr else ("mask_decoder_left", "mask_decoder.")), \
            (("mask_decoder_right", "mask_decoder_right.")
             if has_lr else ("mask_decoder_right", "mask_decoder."))
    if not dup_decoders and not has_lr:
        sides = ((("mask_decoder_left", "mask_decoder.")),)
    for out_name, src in sides:
        _convert_mask_decoder(sd, src, p.setdefault(out_name, {}))
    return p


def _convert_mask_decoder(sd, src: str, out: Dict):
    def put(path, val):
        d = out
        parts = path.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = np.asarray(val)

    put("iou_token", sd[src + "iou_token.weight"])
    put("mask_tokens", sd[src + "mask_tokens.weight"])
    put("upscale_conv1/kernel",
        t_convT(sd[src + "output_upscaling.0.weight"]))
    put("upscale_conv1/bias", sd[src + "output_upscaling.0.bias"])
    put("upscale_ln/weight", sd[src + "output_upscaling.1.weight"])
    put("upscale_ln/bias", sd[src + "output_upscaling.1.bias"])
    put("upscale_conv2/kernel",
        t_convT(sd[src + "output_upscaling.3.weight"]))
    put("upscale_conv2/bias", sd[src + "output_upscaling.3.bias"])
    for i in range(4):
        for j in range(3):
            w = sd[src + f"output_hypernetworks_mlps.{i}.layers.{j}.weight"]
            b = sd[src + f"output_hypernetworks_mlps.{i}.layers.{j}.bias"]
            put(f"hyper_mlps_{i}/layers_{j}/kernel", t_linear(w))
            put(f"hyper_mlps_{i}/layers_{j}/bias", b)
    for j in range(3):
        w = sd.get(src + f"iou_prediction_head.layers.{j}.weight")
        if w is not None:
            put(f"iou_head/layers_{j}/kernel", t_linear(w))
            put(f"iou_head/layers_{j}/bias",
                sd[src + f"iou_prediction_head.layers.{j}.bias"])
    # taxonomy head (bimanual checkpoints only)
    for j in range(3):
        w = sd.get(src + f"taxonomy_embed.layers.{j}.weight")
        if w is not None:
            put(f"taxonomy_embed/layers_{j}/kernel", t_linear(w))
            put(f"taxonomy_embed/layers_{j}/bias",
                sd[src + f"taxonomy_embed.layers.{j}.bias"])
    # two-way transformer
    tr = src + "transformer."
    for i in range(2):
        lsrc = f"{tr}layers.{i}."
        lout = f"transformer/layers_{i}"
        for attn in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put(f"{lout}/{attn}/{proj}/kernel",
                    t_linear(sd[f"{lsrc}{attn}.{proj}.weight"]))
                put(f"{lout}/{attn}/{proj}/bias",
                    sd[f"{lsrc}{attn}.{proj}.bias"])
        for n in range(1, 5):
            put(f"{lout}/norm{n}/scale", sd[f"{lsrc}norm{n}.weight"])
            put(f"{lout}/norm{n}/bias", sd[f"{lsrc}norm{n}.bias"])
        put(f"{lout}/mlp/lin1/kernel", t_linear(sd[f"{lsrc}mlp.lin1.weight"]))
        put(f"{lout}/mlp/lin1/bias", sd[f"{lsrc}mlp.lin1.bias"])
        put(f"{lout}/mlp/lin2/kernel", t_linear(sd[f"{lsrc}mlp.lin2.weight"]))
        put(f"{lout}/mlp/lin2/bias", sd[f"{lsrc}mlp.lin2.bias"])
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        put(f"transformer/final_attn_token_to_image/{proj}/kernel",
            t_linear(sd[f"{tr}final_attn_token_to_image.{proj}.weight"]))
        put(f"transformer/final_attn_token_to_image/{proj}/bias",
            sd[f"{tr}final_attn_token_to_image.{proj}.bias"])
    put("transformer/norm_final_attn/scale",
        sd[tr + "norm_final_attn.weight"])
    put("transformer/norm_final_attn/bias", sd[tr + "norm_final_attn.bias"])


def hf_sam_to_original(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename HF SamModel keys to the original SAM checkpoint layout so
    convert_sam handles both (HF: vision_encoder.layers.N.layer_norm1,
    neck.conv1, mask_decoder.upscale_conv1, hypernet proj_in/layers/
    proj_out; original: image_encoder.blocks.N.norm1, neck.0, ...)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("shared_image_embedding."):
            continue  # duplicate of prompt_encoder.shared_embedding
        nk = k
        nk = nk.replace("vision_encoder.", "image_encoder.")
        nk = nk.replace("patch_embed.projection.", "patch_embed.proj.")
        if "image_encoder." in nk:
            nk = nk.replace(".layers.", ".blocks.")
            nk = nk.replace(".layer_norm1.", ".norm1.")
            nk = nk.replace(".layer_norm2.", ".norm2.")
            nk = nk.replace("neck.conv1.", "neck.0.")
            nk = nk.replace("neck.norm1.", "neck.1.")
            nk = nk.replace("neck.conv2.", "neck.2.")
            nk = nk.replace("neck.norm2.", "neck.3.")
            # after the generic norm rename above, neck layer norms became
            # neck.norm1/norm2 already handled; handle direct names too
            nk = nk.replace("neck.layer_norm1.", "neck.1.")
            nk = nk.replace("neck.layer_norm2.", "neck.3.")
        nk = nk.replace("prompt_encoder.shared_embedding."
                        "positional_embedding",
                        "prompt_encoder.pe_layer."
                        "positional_encoding_gaussian_matrix")
        nk = nk.replace("prompt_encoder.point_embed.",
                        "prompt_encoder.point_embeddings.")
        nk = nk.replace("prompt_encoder.mask_embed.conv1.",
                        "prompt_encoder.mask_downscaling.0.")
        nk = nk.replace("prompt_encoder.mask_embed.layer_norm1.",
                        "prompt_encoder.mask_downscaling.1.")
        nk = nk.replace("prompt_encoder.mask_embed.conv2.",
                        "prompt_encoder.mask_downscaling.3.")
        nk = nk.replace("prompt_encoder.mask_embed.layer_norm2.",
                        "prompt_encoder.mask_downscaling.4.")
        nk = nk.replace("prompt_encoder.mask_embed.conv3.",
                        "prompt_encoder.mask_downscaling.6.")
        if "mask_decoder" in nk and ".transformer." in nk:
            nk = nk.replace(".layer_norm_final_attn.", ".norm_final_attn.")
            for n in (1, 2, 3, 4):
                nk = nk.replace(f".layer_norm{n}.", f".norm{n}.")
        if ".upscale_conv1." in nk:
            nk = nk.replace(".upscale_conv1.", ".output_upscaling.0.")
        if ".upscale_layer_norm." in nk:
            nk = nk.replace(".upscale_layer_norm.", ".output_upscaling.1.")
        if ".upscale_conv2." in nk:
            nk = nk.replace(".upscale_conv2.", ".output_upscaling.3.")
        # hypernet/iou-head MLP naming: proj_in -> layers.0,
        # layers.i -> layers.(i+1), proj_out -> layers.<last>
        m = re.match(
            r"(.*)(output_hypernetworks_mlps\.\d+|iou_prediction_head)\."
            r"(proj_in|proj_out|layers\.(\d+))\.(weight|bias)$", nk)
        if m:
            base, head, part, lyr, wb = m.groups()
            if part == "proj_in":
                idx = 0
            elif part == "proj_out":
                idx = 2  # 3-layer MLPs throughout SAM
            else:
                idx = int(lyr) + 1
            nk = f"{base}{head}.layers.{idx}.{wb}"
        out[nk] = v
    return out


# ---------------------------------------------------------------------------
# CLIP vision tower (HF CLIPVisionModel layout)
# ---------------------------------------------------------------------------

def convert_clip(sd: Dict[str, np.ndarray], num_layers_used: int,
                 prefix: str = "vision_model.") -> Dict:
    p: Dict = {}

    def put(path, val):
        d = p
        parts = path.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = np.asarray(val)

    emb = prefix + "embeddings."
    put("class_embedding", sd[emb + "class_embedding"])
    put("patch_embedding/kernel",
        t_conv(sd[emb + "patch_embedding.weight"]))
    put("position_embedding", sd[emb + "position_embedding.weight"])
    put("pre_layrnorm/scale", sd[prefix + "pre_layrnorm.weight"])
    put("pre_layrnorm/bias", sd[prefix + "pre_layrnorm.bias"])
    for i in range(num_layers_used):
        b = f"{prefix}encoder.layers.{i}."
        o = f"layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{o}/self_attn/{proj}/kernel",
                t_linear(sd[f"{b}self_attn.{proj}.weight"]))
            put(f"{o}/self_attn/{proj}/bias",
                sd[f"{b}self_attn.{proj}.bias"])
        put(f"{o}/layer_norm1/scale", sd[b + "layer_norm1.weight"])
        put(f"{o}/layer_norm1/bias", sd[b + "layer_norm1.bias"])
        put(f"{o}/layer_norm2/scale", sd[b + "layer_norm2.weight"])
        put(f"{o}/layer_norm2/bias", sd[b + "layer_norm2.bias"])
        put(f"{o}/fc1/kernel", t_linear(sd[b + "mlp.fc1.weight"]))
        put(f"{o}/fc1/bias", sd[b + "mlp.fc1.bias"])
        put(f"{o}/fc2/kernel", t_linear(sd[b + "mlp.fc2.weight"]))
        put(f"{o}/fc2/bias", sd[b + "mlp.fc2.bias"])
    return p


# ---------------------------------------------------------------------------
# LLaMA (HF layout)
# ---------------------------------------------------------------------------

def convert_llama(sd: Dict[str, np.ndarray], num_layers: int,
                  prefix: str = "model.") -> Dict:
    """HF LlamaForCausalLM keys -> our LlamaForCausalLM params. q/v base
    kernels land under {q,v}_proj/base (LoRA layout)."""
    p: Dict = {}

    def put(path, val):
        d = p
        parts = path.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = np.asarray(val)

    put("embed_tokens/embedding", sd[prefix + "embed_tokens.weight"])
    put("lm_head/kernel", t_linear(sd["lm_head.weight"]))
    put("model/norm/weight", sd[prefix + "norm.weight"])
    for i in range(num_layers):
        b = f"{prefix}layers.{i}."
        o = f"model/layers_{i}"
        put(f"{o}/self_attn/q_proj/base/kernel",
            t_linear(sd[b + "self_attn.q_proj.weight"]))
        put(f"{o}/self_attn/k_proj/kernel",
            t_linear(sd[b + "self_attn.k_proj.weight"]))
        put(f"{o}/self_attn/v_proj/base/kernel",
            t_linear(sd[b + "self_attn.v_proj.weight"]))
        put(f"{o}/self_attn/o_proj/kernel",
            t_linear(sd[b + "self_attn.o_proj.weight"]))
        put(f"{o}/mlp/gate_proj/kernel",
            t_linear(sd[b + "mlp.gate_proj.weight"]))
        put(f"{o}/mlp/up_proj/kernel",
            t_linear(sd[b + "mlp.up_proj.weight"]))
        put(f"{o}/mlp/down_proj/kernel",
            t_linear(sd[b + "mlp.down_proj.weight"]))
        put(f"{o}/input_layernorm/weight",
            sd[b + "input_layernorm.weight"])
        put(f"{o}/post_attention_layernorm/weight",
            sd[b + "post_attention_layernorm.weight"])
    return p


# ---------------------------------------------------------------------------
# Full 2HAff merged checkpoint
# ---------------------------------------------------------------------------

def convert_mpt(sd: Dict[str, np.ndarray], n_layers: int,
                prefix: str = "transformer.") -> Dict:
    """HF/mosaicml MPTForCausalLM keys -> the MPT decoder's tree (the
    vendored reference mpt/modeling_mpt.py layout: wte, blocks.i
    {norm_1, attn.{Wqkv, out_proj}, norm_2, ffn.{up,down}_proj}, norm_f;
    no biases, the LM head tied to wte). Through `to_state_dict` it loads
    into nn/mpt.MptForCausalLM (the `llm` of an MPT LisaModel)."""
    p: Dict = {}

    def put(path, val):
        d = p
        parts = path.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = np.asarray(val)

    put("wte/embedding", sd[prefix + "wte.weight"])
    put("norm_f/scale", sd[prefix + "norm_f.weight"])
    for i in range(n_layers):
        b = f"{prefix}blocks.{i}."
        o = f"blocks_{i}"
        put(f"{o}/norm_1/scale", sd[b + "norm_1.weight"])
        put(f"{o}/attn/Wqkv/kernel", t_linear(sd[b + "attn.Wqkv.weight"]))
        put(f"{o}/attn/out_proj/kernel",
            t_linear(sd[b + "attn.out_proj.weight"]))
        if b + "attn.q_ln.weight" in sd:  # qk_ln variants
            put(f"{o}/attn/q_ln/scale", sd[b + "attn.q_ln.weight"])
            put(f"{o}/attn/k_ln/scale", sd[b + "attn.k_ln.weight"])
        put(f"{o}/norm_2/scale", sd[b + "norm_2.weight"])
        put(f"{o}/up_proj/kernel", t_linear(sd[b + "ffn.up_proj.weight"]))
        put(f"{o}/down_proj/kernel",
            t_linear(sd[b + "ffn.down_proj.weight"]))
    return p


def convert_2haff(sd: Dict[str, np.ndarray], llama_layers: int,
                  sam_depth: int) -> Dict:
    """Merged HF-format 2HAff state dict -> full LisaModel params."""
    out: Dict = {}
    out["llm"] = convert_llama(sd, llama_layers, prefix="model.")
    out["mm_projector"] = {
        "kernel": t_linear(sd["model.mm_projector.weight"]),
        "bias": np.asarray(sd["model.mm_projector.bias"]),
    }
    out["text_fc1"] = {
        "kernel": t_linear(sd["model.text_hidden_fcs.0.0.weight"]),
        "bias": np.asarray(sd["model.text_hidden_fcs.0.0.bias"]),
    }
    out["text_fc2"] = {
        "kernel": t_linear(sd["model.text_hidden_fcs.0.2.weight"]),
        "bias": np.asarray(sd["model.text_hidden_fcs.0.2.bias"]),
    }
    sam_sd = {k[len("model.visual_model."):]: v for k, v in sd.items()
              if k.startswith("model.visual_model.")}
    out["visual_model"] = convert_sam(sam_sd, depth=sam_depth)
    # vision tower keys are stripped from the merged checkpoint
    # (merge_lora_weights_and_save_hf_model.py:146-155); CLIP is loaded
    # separately via convert_clip.
    clip_sd = {k[len("model.vision_tower.vision_tower."):]: v
               for k, v in sd.items()
               if k.startswith("model.vision_tower.vision_tower.")}
    if clip_sd:
        n = max(int(re.search(r"layers\.(\d+)\.", k).group(1))
                for k in clip_sd if ".layers." in k) + 1
        out["vision_tower"] = convert_clip(clip_sd, n)
    return out


def to_state_dict(converted: Dict, scope: Optional[str] = None
                  ) -> Dict[str, "torch.Tensor"]:
    """A converted tree -> the port's state_dict entries (tools/bridge.py
    names and layouts), each name prefixed with `scope.` when given."""
    from .bridge import flax_to_state_dict

    sd = flax_to_state_dict(converted)
    if scope:
        sd = {f"{scope}.{k}": v for k, v in sd.items()}
    return sd


def merge_into_init(model, converted: Dict):
    """Overlay converted weights onto a built model in place (keeps
    parameters absent from the checkpoint: LoRA adapters, the taxonomy
    head on stock SAM). `converted` is a whole-model tree (top-level
    scopes such as "visual_model", "llm"). Each tensor is cast to its
    parameter's dtype and copied in; a shape mismatch raises, and keys
    without a parameter are reported."""
    import torch

    own = model.state_dict()
    missing, mismatched, hits = [], [], {}
    for k, v in to_state_dict(converted).items():
        if k not in own:
            missing.append(k)
        elif tuple(own[k].shape) != tuple(v.shape):
            mismatched.append((k, tuple(own[k].shape), tuple(v.shape)))
        else:
            hits[k] = v
    if mismatched:
        raise ValueError(f"shape mismatches: {mismatched[:5]}")
    if missing:
        print(f"convert: {len(missing)} checkpoint keys without a home "
              f"(first: {missing[:3]})")
    with torch.no_grad():
        for k, v in hits.items():
            own[k].copy_(v.to(own[k].dtype))
    return model
