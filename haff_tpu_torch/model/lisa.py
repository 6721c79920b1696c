"""The composite 2Haff model for inference (port of haff_tpu/model/lisa.py):
CLIP ViT tower + mm_projector, LLaMA decoder emitting [SEG], the [SEG]
projection MLP, and SAM with the dual mask decoders and the taxonomy head.

The model is built on the `meta` device, then materialised on `device`
(default "cuda": the card, unless the caller asks for the CPU) in
`dtype`, with weights drawn from a seeded `torch.Generator`. Real weights
come through tools/bridge.py. The submodule methods below are the ones
infer/evaluate.py calls; the training forward belongs to the training
slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig
from ..core.dtypes import resolve, set_reference_precision
from ..nn.clip_vit import ClipVisionTower
from ..nn.layers import LayerNorm, QDense
from ..nn.llama import LlamaForCausalLM, RMSNorm
from ..nn.sam import Sam

# Raw parameters drawn at unit scale (the JAX initializers' normal(1.0));
# every other raw parameter is drawn at 0.02.
_UNIT_SCALE = ("iou_token", "mask_tokens", "point_embeddings",
               "not_a_point_embed", "no_mask_embed",
               "positional_encoding_gaussian_matrix")


class LisaModel(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.decoder != "llama":
            raise NotImplementedError("the MPT decoder is not ported yet")
        self.cfg = cfg
        with torch.device("meta"):
            self.llm = LlamaForCausalLM(cfg.llama)
            self.vision_tower = ClipVisionTower(cfg.clip)
            self.mm_projector = QDense(cfg.clip.hidden_size,
                                       cfg.llama.hidden_size)
            self.visual_model = Sam(cfg.sam_encoder, cfg.sam_decoder)
            self.text_fc1 = QDense(cfg.llama.hidden_size, cfg.llama.hidden_size)
            self.text_fc2 = QDense(cfg.llama.hidden_size, cfg.out_dim)
        self.to(resolve(dtype))
        self.to_empty(device=torch.device(device))
        set_reference_precision()
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_random_(self, generator)

    @property
    def device(self):
        return self.text_fc1.weight.device

    # ----- submodule methods (as the JAX LisaModel's) -----

    def encode_clip(self, images_clip):
        return self.mm_projector(self.vision_tower(images_clip))

    def encode_sam(self, images_sam):
        return self.visual_model.encode_image(images_sam)

    def project_seg(self, hidden):
        return self.text_fc2(F.relu(self.text_fc1(hidden)))

    def decode_masks(self, sam_embeddings, seg_embeds):
        return self.visual_model.decode_masks(sam_embeddings, seg_embeds)

    def llm_forward(self, inputs_embeds, positions, segment_ids=None,
                    kv_caches=None, cache_index=None,
                    cache_kv_segment_ids=None):
        return self.llm(inputs_embeds, positions, segment_ids, kv_caches,
                        cache_index, cache_kv_segment_ids)

    def embed_tokens(self, input_ids):
        # IMAGE_TOKEN_INDEX (-200) reads row 0; the splice overwrites it.
        return self.llm.embed(input_ids.clamp(min=0))


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator`: normal(0, fan_in^-1/2) for
    dense and convolution weights, zero biases, unit norms, normal(0, 0.02)
    for embeddings and position tables, normal(0, 1) for the SAM decoder's
    tokens and prompt embeddings."""

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    for mod in model.modules():
        if isinstance(mod, (LayerNorm, RMSNorm)):
            mod.weight.fill_(1.0)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
        else:
            for name, p in mod.named_parameters(recurse=False):
                normal_(p, 1.0 if name in _UNIT_SCALE else 0.02)
