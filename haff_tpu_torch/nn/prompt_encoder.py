"""SAM prompt encoder, text-prompt path (port of
haff_tpu/nn/prompt_encoder.py).

evaluate() prompts the mask decoders with the projected [SEG] embedding
only: the sparse prompt is the text embedding and the dense prompt is the
no-mask embedding broadcast over the grid. The point, box and mask-prompt
parameters are held so a JAX checkpoint loads whole; their embedding
paths come with the point-prompt serving entry points.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..core.config import SamDecoderConfig
from .layers import ChannelLayerNorm


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier-feature positional encoding."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, num_pos_feats))

    def _encode(self, coords):  # coords in [0, 1], (..., 2)
        coords = 2.0 * coords.float() - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix.float()
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid(self, h: int, w: int):
        """Dense PE over an h x w grid -> (h, w, 2*num_pos_feats) float32."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        return self._encode(torch.stack([gx, gy], dim=-1))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamDecoderConfig,
                 image_embedding_size: Tuple[int, int] = (64, 64)):
        super().__init__()
        d, c = cfg.prompt_embed_dim, cfg.mask_in_chans
        self.embed_dim = d
        self.image_embedding_size = tuple(image_embedding_size)
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.Parameter(torch.zeros(4, d))
        self.not_a_point_embed = nn.Parameter(torch.zeros(1, d))
        self.no_mask_embed = nn.Parameter(torch.zeros(1, d))
        self.mask_conv1 = nn.Conv2d(1, c // 4, 2, 2)
        self.mask_ln1 = ChannelLayerNorm(c // 4)
        self.mask_conv2 = nn.Conv2d(c // 4, c, 2, 2)
        self.mask_ln2 = ChannelLayerNorm(c)
        self.mask_conv3 = nn.Conv2d(c, d, 1)

    def get_dense_pe(self):
        return self.pe_layer.grid(*self.image_embedding_size)  # (h, w, d)

    def forward(self, text_embeds):
        """text_embeds (B, T, d) -> (sparse (B, T, d), dense (B, h, w, d))."""
        dt = self.no_mask_embed.dtype
        b = text_embeds.shape[0]
        h, w = self.image_embedding_size
        dense = self.no_mask_embed[0].to(dt).expand(b, h, w, self.embed_dim)
        return text_embeds.to(dt), dense
