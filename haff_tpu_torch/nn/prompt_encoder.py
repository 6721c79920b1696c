"""SAM prompt encoder: point, box, mask and text prompts (port of
haff_tpu/nn/prompt_encoder.py).

evaluate() prompts the mask decoders with the projected [SEG] embedding
(the sparse prompt is the text embedding, the dense prompt the no-mask
embedding broadcast over the grid); SamPredictor prompts them with
points and boxes in canvas pixels, and optionally a low-res mask.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..core.config import SamDecoderConfig
from .layers import ChannelLayerNorm, conv_nhwc, gelu


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

    def with_coords(self, coords, image_size: Tuple[int, int]):
        """coords (..., 2) as (x, y) pixels -> PE (..., 2*num_pos_feats)."""
        scaled = torch.stack([coords[..., 0] / image_size[1],
                              coords[..., 1] / image_size[0]], dim=-1)
        return self._encode(scaled)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamDecoderConfig,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024)):
        super().__init__()
        d, c = cfg.prompt_embed_dim, cfg.mask_in_chans
        self.embed_dim = d
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
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

    def _embed_points(self, points, labels, pad: bool):
        """points (B, N, 2) canvas pixels, labels (B, N) in {-1, 0, 1}
        (not a point, background, foreground) -> (B, N [+ 1], d). `pad`
        appends the not-a-point entry the reference adds when no box is
        given."""
        points = points.float() + 0.5  # shift to the pixel centre
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :1])], 1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], 1)
        pe = self.pe_layer.with_coords(points, self.input_image_size)
        lab = labels[..., None]
        zero = torch.zeros((), dtype=pe.dtype, device=pe.device)
        pe = torch.where(lab == -1, zero, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed[0].float(), zero)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].float(), zero)
        pe = pe + torch.where(lab == 1, self.point_embeddings[1].float(), zero)
        return pe

    def _embed_boxes(self, boxes):
        """boxes (B, 4) canvas pixels x0 y0 x1 y1 -> (B, 2, d)."""
        corners = (boxes.float() + 0.5).reshape(-1, 2, 2)
        pe = self.pe_layer.with_coords(corners, self.input_image_size)
        return pe + self.point_embeddings[2:4].float()

    def _embed_masks(self, masks):
        """masks (B, 4h, 4w, 1) -> (B, h, w, d)."""
        x = gelu(self.mask_ln1(conv_nhwc(self.mask_conv1, masks)))
        x = gelu(self.mask_ln2(conv_nhwc(self.mask_conv2, x)))
        return conv_nhwc(self.mask_conv3, x)

    def forward(self, points=None, boxes=None, masks=None, text_embeds=None):
        """points = (coords (B, N, 2), labels (B, N)), boxes (B, 4), masks
        (B, 4h, 4w, 1), text_embeds (B, T, d), each optional -> (sparse
        (B, n, d), dense (B, h, w, d)) in the parameters' dtype."""
        dt = self.no_mask_embed.dtype
        d = self.embed_dim
        parts = []
        if points is not None:
            parts.append(self._embed_points(*points, pad=boxes is None))
        if boxes is not None:
            parts.append(self._embed_boxes(boxes).reshape(boxes.shape[0], -1, d))
        if text_embeds is not None:
            parts.append(text_embeds)
        if masks is not None:
            dense = self._embed_masks(masks).to(dt)
            bs = parts[0].shape[0] if parts else masks.shape[0]
        else:
            bs = parts[0].shape[0] if parts else 1
            h, w = self.image_embedding_size
            dense = self.no_mask_embed[0].expand(bs, h, w, d)
        if parts:
            sparse = torch.cat([p.to(dt) for p in parts], dim=1)
        else:
            sparse = torch.zeros((bs, 0, d), dtype=dt,
                                 device=self.no_mask_embed.device)
        return sparse, dense
