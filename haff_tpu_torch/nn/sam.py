"""Composite SAM with dual (left/right) mask decoders (port of
haff_tpu/nn/sam.py): image encoder, prompt encoder, `mask_decoder_left`
with the taxonomy head and `mask_decoder_right` without."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import SamDecoderConfig, SamEncoderConfig
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder
from .sam_image_encoder import SamImageEncoder


# Reference sam.py pixel statistics (ImageNet, 0-255 scale).
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)


def preprocess_image(x, image_size: int):
    """Normalize 0-255 RGB and zero-pad bottom and right to the square
    canvas (reference sam.py preprocess). x (..., h, w, 3) with
    h, w <= image_size -> float32 (..., image_size, image_size, 3)."""
    x = torch.as_tensor(x).float()
    mean, std = (torch.as_tensor(a, device=x.device)
                 for a in (PIXEL_MEAN, PIXEL_STD))
    x = (x - mean) / std
    h, w = x.shape[-3:-1]
    return F.pad(x, (0, 0, 0, image_size - w, 0, image_size - h))


class Sam(nn.Module):
    def __init__(self, encoder_cfg: SamEncoderConfig,
                 decoder_cfg: SamDecoderConfig):
        super().__init__()
        grid = encoder_cfg.grid_size
        self.image_encoder = SamImageEncoder(encoder_cfg)
        self.prompt_encoder = PromptEncoder(
            decoder_cfg, (grid, grid), (encoder_cfg.image_size,) * 2)
        self.mask_decoder_left = MaskDecoder(decoder_cfg, taxonomy_on=True)
        self.mask_decoder_right = MaskDecoder(decoder_cfg, taxonomy_on=False)

    def encode_image(self, images, remat: bool = False):
        """(B, S, S, 3) preprocessed pixels -> (B, g, g, 256) float32."""
        return self.image_encoder(images, remat)

    def decode_masks(self, image_embeddings, text_embeds):
        """Prompted dual decode: image_embeddings (B, g, g, 256),
        text_embeds (B, T, 256) -> (masks_left (B, 1, 4g, 4g),
        masks_right, iou_left (B, 1), iou_right, taxonomy (B, 4))."""
        sparse, dense = self.prompt_encoder(text_embeds=text_embeds)
        image_pe = self.prompt_encoder.get_dense_pe()[None]
        masks_l, iou_l, taxonomy = self.mask_decoder_left(
            image_embeddings, image_pe, sparse, dense)
        masks_r, iou_r = self.mask_decoder_right(
            image_embeddings, image_pe, sparse, dense)
        return masks_l, masks_r, iou_l, iou_r, taxonomy


def postprocess_masks_padded(low_res_masks, image_size: int):
    """Bilinearly upsample low-res logits (B, n, 4g, 4g) to the padded
    square canvas (B, n, S, S) (half-pixel centres, as jax.image.resize)."""
    return F.interpolate(low_res_masks, size=(image_size, image_size),
                         mode="bilinear", align_corners=False, antialias=False)


def resize_to_original(canvas_masks, input_size: Tuple[int, int],
                       original_size: Tuple[int, int]) -> np.ndarray:
    """Host-side second half of the reference postprocess: crop the
    unpadded region of (n, S, S) canvas logits, then bilinearly resize to
    the frame's original (H, W). Returns float32 numpy (n, H, W)."""
    ih, iw = input_size
    x = torch.as_tensor(np.asarray(canvas_masks, np.float32))[None, :, :ih, :iw]
    out = F.interpolate(x, size=tuple(original_size), mode="bilinear",
                        align_corners=False)
    return out[0].numpy()
