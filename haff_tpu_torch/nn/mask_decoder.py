"""SAM mask decoder with the bimanual taxonomy head (port of
haff_tpu/nn/mask_decoder.py).

IoU token + 4 mask tokens, TwoWayTransformer, 2x transposed-conv
upscaling, per-token hypernetwork MLPs, IoU head and, with
`taxonomy_on`, the 4-way taxonomy head over the flattened mask tokens.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import SamDecoderConfig
from .layers import ChannelLayerNorm, ReluMLP, conv_nhwc, gelu
from .two_way_transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    compute_dtype = None  # see nn/layers.py: set when held in float32

    def __init__(self, cfg: SamDecoderConfig, taxonomy_on: bool = False):
        super().__init__()
        d = cfg.prompt_embed_dim
        n = cfg.num_multimask_outputs + 1
        self.num_mask_tokens = n
        self.taxonomy_on = taxonomy_on
        self.iou_token = nn.Parameter(torch.zeros(1, d))
        self.mask_tokens = nn.Parameter(torch.zeros(n, d))
        self.transformer = TwoWayTransformer(cfg)
        self.upscale_conv1 = nn.ConvTranspose2d(d, d // 4, 2, 2)
        self.upscale_ln = ChannelLayerNorm(d // 4)
        self.upscale_conv2 = nn.ConvTranspose2d(d // 4, d // 8, 2, 2)
        self.hyper_mlps = nn.ModuleList(
            ReluMLP(d, d, d // 8, 3) for _ in range(n))
        self.iou_head = ReluMLP(d, cfg.iou_head_hidden_dim, n,
                                cfg.iou_head_depth)
        if taxonomy_on:
            self.taxonomy_embed = ReluMLP(d * n, d * n, cfg.taxonomy_classes, 3)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool = False):
        """image_embeddings (B, h, w, d) -> (masks (B, k, 4h, 4w) float32,
        iou (B, k)[, taxonomy (B, 4) float32 probabilities])."""
        dt = self.compute_dtype or self.iou_token.dtype
        b = sparse_prompt_embeddings.shape[0]
        d = self.iou_token.shape[1]
        output_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat(
            [output_tokens[None].expand(b, -1, -1).to(dt),
             sparse_prompt_embeddings.to(dt)], dim=1)
        src = image_embeddings.to(dt) + dense_prompt_embeddings.to(dt)
        hs, src_out = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        h, w = image_embeddings.shape[1:3]
        x = conv_nhwc(self.upscale_conv1, src_out.reshape(b, h, w, d))
        x = gelu(self.upscale_ln(x))
        upscaled = gelu(conv_nhwc(self.upscale_conv2, x))  # (B, 4h, 4w, d/8)

        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i, :])
             for i, mlp in enumerate(self.hyper_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(),
                             upscaled.float())
        iou_pred = self.iou_head(iou_token_out)

        sel = slice(1, None) if multimask_output else slice(0, 1)
        masks, iou_pred = masks[:, sel], iou_pred[:, sel]
        if self.taxonomy_on:
            tax_logits = self.taxonomy_embed(mask_tokens_out.reshape(b, -1))
            return masks, iou_pred, torch.softmax(tax_logits.float(), dim=-1)
        return masks, iou_pred
