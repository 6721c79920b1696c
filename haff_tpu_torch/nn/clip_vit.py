"""CLIP ViT vision tower (port of haff_tpu/nn/clip_vit.py).

Returns the patch tokens of hidden_states[select_layer] (-2: the output
of layer N-1), so only N-1 layers exist and run, as in the JAX package.
QuickGELU, pre-LayerNorm, LayerNorm eps 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ClipVisionConfig
from .layers import LayerNorm, QDense, conv_nhwc


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = QDense(e, e)
        self.k_proj = QDense(e, e)
        self.v_proj = QDense(e, e)
        self.out_proj = QDense(e, e)

    def forward(self, x):  # (B, L, E)
        b, l, e = x.shape
        hd = e // self.num_heads
        q = self.q_proj(x).reshape(b, l, self.num_heads, hd)
        k = self.k_proj(x).reshape(b, l, self.num_heads, hd)
        v = self.v_proj(x).reshape(b, l, self.num_heads, hd)
        logits = torch.einsum("blnd,bmnd->bnlm", (q * hd ** -0.5).float(),
                              k.float())
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bnlm,bmnd->blnd", probs, v)
        return self.out_proj(out.reshape(b, l, e))


class ClipLayer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = ClipAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = QDense(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = QDense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        dt = x.dtype
        x = x + self.self_attn(self.layer_norm1(x).to(dt))
        h = self.fc2(quick_gelu(self.fc1(self.layer_norm2(x).to(dt))))
        return x + h


class ClipVisionTower(nn.Module):
    """(B, S, S, 3) normalized pixels -> (B, num_patches, hidden)."""

    compute_dtype = None  # see nn/layers.py: set when held in float32

    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        num_run = cfg.num_layers + cfg.select_layer + 1
        if not 0 < num_run <= cfg.num_layers:
            raise ValueError(f"select_layer {cfg.select_layer} out of range")
        e = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, e, cfg.patch_size, cfg.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(e))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.num_patches + 1, e))
        self.pre_layrnorm = LayerNorm(e, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(ClipLayer(cfg) for _ in range(num_run))

    def forward(self, pixels):
        dt = self.compute_dtype or self.class_embedding.dtype
        b = pixels.shape[0]
        patches = conv_nhwc(self.patch_embedding, pixels)
        patches = patches.reshape(b, -1, patches.shape[-1])
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding.to(dt)
        x = self.pre_layrnorm(x).to(dt)
        for layer in self.layers:
            x = layer(x)
        return x[:, 1:, :]
