"""CLIP ViT vision tower with LLaVA's feature selection, plain float32.

HF `CLIPVisionTransformer` (openai/clip-vit-large-patch14): patch
convolution without bias, class and position embeddings, pre-LayerNorm,
pre-norm layers with QuickGELU, LayerNorm eps 1e-5. LLaVA reads
hidden_states[select_layer] (-2: the output of the second last layer) and
drops the class token; the projector is one linear layer.

Preprocessing as HF CLIPImageProcessor: PIL bicubic resize of the short
side (the long side truncated), centre crop, 1/255, CLIP statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess(frame: np.ndarray, size: int = 224) -> torch.Tensor:
    """uint8 RGB (H, W, 3) -> (1, 3, size, size) float32."""
    from PIL import Image

    h, w = frame.shape[:2]
    if h <= w:
        nh, nw = size, int(size * w / h)
    else:
        nh, nw = int(size * h / w), size
    img = np.asarray(Image.fromarray(frame).resize((nw, nh), Image.BICUBIC))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = img[top:top + size, left:left + size].astype(np.float32) / 255.0
    x = (x - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD, np.float32)
    return torch.as_tensor(x).permute(2, 0, 1)[None]


def _lin(x, W, name):
    return F.linear(x, W[name + ".weight"], W.get(name + ".bias"))


def _ln(x, W, name, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"],
                        W[name + ".bias"], eps)


def vision_tower(pixels, W, clip, prefix="vision_tower."):
    """(B, 3, S, S) -> (B, patches, hidden): hidden_states[select_layer]
    without the class token."""
    p = prefix
    b = pixels.shape[0]
    x = F.conv2d(pixels, W[p + "patch_embedding.weight"],
                 stride=clip["patch_size"]).flatten(2).transpose(1, 2)
    cls = W[p + "class_embedding"].expand(b, 1, -1)
    x = torch.cat([cls, x], 1) + W[p + "position_embedding"]
    x = _ln(x, W, p + "pre_layrnorm")
    nh = clip["num_attention_heads"]
    run = clip["num_hidden_layers"] + clip["select_layer"] + 1
    for i in range(run):
        lp = f"{p}layers.{i}"
        y = _ln(x, W, lp + ".layer_norm1")
        bb, l, e = y.shape
        hd = e // nh
        heads = lambda t: t.view(bb, l, nh, hd).transpose(1, 2)  # noqa: E731
        q = heads(_lin(y, W, lp + ".self_attn.q_proj") * hd ** -0.5)
        k = heads(_lin(y, W, lp + ".self_attn.k_proj"))
        v = heads(_lin(y, W, lp + ".self_attn.v_proj"))
        o = torch.matmul(torch.matmul(q, k.transpose(-2, -1)).softmax(-1), v)
        x = x + _lin(o.transpose(1, 2).reshape(bb, l, e), W, lp + ".self_attn.out_proj")
        y = _lin(_ln(x, W, lp + ".layer_norm2"), W, lp + ".fc1")
        y = y * torch.sigmoid(1.702 * y)
        x = x + _lin(y, W, lp + ".fc2")
    return x[:, 1:]
