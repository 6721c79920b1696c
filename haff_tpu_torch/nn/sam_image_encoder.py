"""SAM image encoder ViT (port of haff_tpu/nn/sam_image_encoder.py).

ViT-H: 32 blocks, embed 1280, 16 heads, 14 x 14 windows, global attention
at blocks 7/15/23/31, decomposed relative-position bias, fp32 conv neck to
256 channels; ViT-L, ViT-B and the small and tiny presets by config.
NHWC in and out. Windowed blocks run the column-split qkv projection into
the windowed rel-pos attention kernel; global blocks run the fused
projection into the global kernel, or, for grids under 1024 tokens, into
the window kernel's fused-operand entry, as the JAX encoder routes them
(kernels/sam_attention.py). `use_rel_pos=False` is plain softmax
attention with no kernel, as in JAX. `remat` recomputes each block in the
backward (torch.utils.checkpoint), for training the encoder.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import SamEncoderConfig
from ..kernels.flash_attention import mha_reference
from ..kernels.sam_attention import (head_view, sam_global_attention_qkv,
                                     sam_window_attention_qkv,
                                     sam_window_attention_qkv_split)
from .layers import ChannelLayerNorm, LayerNorm, MLPBlock, QDense, conv_nhwc


def window_partition(x, window: int):
    """(B, H, W, C) -> (B*nW, window, window, C), zero-padding bottom and
    right; returns the windows and the padded (hp, wp)."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(x, window: int, pad_hw, hw):
    """Inverse of window_partition, dropping the padding."""
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // window // window)
    x = x.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


class SamAttention(nn.Module):
    """Multi-head self-attention, with the decomposed rel-pos bias unless
    `use_rel_pos` is off, over a window (input (BW, window*window, C)) or
    the whole grid (input (B, H, W, C))."""

    def __init__(self, dim: int, num_heads: int, input_hw: Tuple[int, int],
                 use_rel_pos: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.input_hw = tuple(input_hw)
        self.use_rel_pos = use_rel_pos
        head_dim = dim // num_heads
        self.qkv = QDense(dim, 3 * dim)
        self.proj = QDense(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * input_hw[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * input_hw[1] - 1, head_dim))

    def forward(self, x, unpartition=None):
        nh, hw = self.num_heads, self.input_hw
        if x.ndim == 3:
            # Windowed: (BW, L, C) tokens of whole windows; the output is
            # unpartitioned (padding dropped) before the projection.
            bw, l, c = x.shape
            if not self.use_rel_pos:
                out = self._plain(x)
            else:
                q3, kv3 = self.qkv(x.reshape(bw * l, c), out_split=(c, 2 * c))
                out = sam_window_attention_qkv_split(
                    q3.reshape(bw, l, c), kv3.reshape(bw, l, 2 * c),
                    self.rel_pos_h, self.rel_pos_w, hw, nh)
            pad_hw, full_hw = unpartition
            out = window_unpartition(out.reshape(bw, hw[0], hw[1], c), hw[0],
                                     pad_hw, full_hw)
            return self.proj(out)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        if not self.use_rel_pos:
            out = self._plain(x)
        elif h % 8 == 0 and w % 8 == 0 and h * w >= 1024:
            out = sam_global_attention_qkv(self.qkv(x), self.rel_pos_h,
                                           self.rel_pos_w, (h, w), nh)
        else:  # a small grid is one window (the JAX encoder's routing)
            out = sam_window_attention_qkv(self.qkv(x), self.rel_pos_h,
                                           self.rel_pos_w, (h, w), nh)
        return self.proj(out.reshape(b, h, w, c))

    def _plain(self, x):
        """Softmax attention without a bias: (B, L, C) -> (B, L, C)."""
        qkv = self.qkv(x)
        q, k, v = (head_view(qkv, 3, i, self.num_heads) for i in range(3))
        return mha_reference(q, k, v).reshape(x.shape)


class SamBlock(nn.Module):
    def __init__(self, cfg: SamEncoderConfig, window_size: int):
        super().__init__()
        self.window_size = window_size
        dim = cfg.embed_dim
        attn_hw = ((window_size, window_size) if window_size > 0
                   else (cfg.grid_size, cfg.grid_size))
        self.norm1 = LayerNorm(dim, cfg.layer_norm_eps)
        self.attn = SamAttention(dim, cfg.num_heads, attn_hw, cfg.use_rel_pos)
        self.norm2 = LayerNorm(dim, cfg.layer_norm_eps)
        self.mlp = MLPBlock(dim, int(dim * cfg.mlp_ratio))

    def forward(self, x):  # (B, H, W, C)
        dt = x.dtype
        shortcut = x
        x = self.norm1(x).to(dt)
        if self.window_size > 0:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window_size)
            x = self.attn(x.reshape(x.shape[0], -1, x.shape[-1]),
                          unpartition=(pad_hw, hw))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x).to(dt))


class SamImageEncoder(nn.Module):
    """ViT backbone + neck: (B, S, S, 3) -> (B, g, g, out_chans) float32.
    With `remat` and grad mode on, each block is recomputed in the
    backward (the JAX module's `remat` flag, given at the call as the
    port's LLaMA takes it)."""

    compute_dtype = None  # see nn/layers.py: set when held in float32

    def __init__(self, cfg: SamEncoderConfig):
        super().__init__()
        self.cfg = cfg
        c, g = cfg.embed_dim, cfg.grid_size
        self.patch_embed = nn.Conv2d(3, c, cfg.patch_size, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, c))
        self.blocks = nn.ModuleList(
            SamBlock(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.depth))
        self.neck_conv1 = nn.Conv2d(c, cfg.out_chans, 1, bias=False)
        self.neck_ln1 = ChannelLayerNorm(cfg.out_chans)
        self.neck_conv2 = nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1,
                                    bias=False)
        self.neck_ln2 = ChannelLayerNorm(cfg.out_chans)

    def forward(self, x, remat: bool = False):
        dt = self.compute_dtype or self.pos_embed.dtype
        x = conv_nhwc(self.patch_embed, x, dt) + self.pos_embed.to(dt)
        for blk in self.blocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        # Neck in float32, as the reference guards fp16 overflow; the
        # convolutions must not run in TF32 (see core.dtypes).
        x = conv_nhwc(self.neck_conv1, x.float(), torch.float32)
        x = self.neck_ln1(x)
        x = conv_nhwc(self.neck_conv2, x, torch.float32)
        return self.neck_ln2(x)
