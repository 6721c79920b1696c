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


class Sam(nn.Module):
    def __init__(self, encoder_cfg: SamEncoderConfig,
                 decoder_cfg: SamDecoderConfig):
        super().__init__()
        grid = encoder_cfg.grid_size
        self.image_encoder = SamImageEncoder(encoder_cfg)
        self.prompt_encoder = PromptEncoder(decoder_cfg, (grid, grid))
        self.mask_decoder_left = MaskDecoder(decoder_cfg, taxonomy_on=True)
        self.mask_decoder_right = MaskDecoder(decoder_cfg, taxonomy_on=False)

    def encode_image(self, images):
        """(B, S, S, 3) preprocessed pixels -> (B, g, g, 256) float32."""
        return self.image_encoder(images)

    def decode_masks(self, image_embeddings, text_embeds):
        """Prompted dual decode: image_embeddings (B, g, g, 256),
        text_embeds (B, T, 256) -> (masks_left (B, 1, 4g, 4g),
        masks_right, iou_left (B, 1), iou_right, taxonomy (B, 4))."""
        sparse, dense = self.prompt_encoder(text_embeds)
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
