"""The evaluate() API: text + image -> (output tokens, left/right
affordance masks, taxonomy) (port of haff_tpu/infer/evaluate.py
`evaluate_fn`, greedy decode).

Generate with hidden-state capture, gather the first emitted [SEG]'s
hidden state, project it, prompt both SAM mask decoders with it, and
upsample the masks to the padded square canvas. Resizing to each frame's
original size is host-side (nn/sam.py resize_to_original).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..model.lisa import LisaModel
from ..model.multimodal import find_image_position, splice_image_embeddings
from ..nn.sam import postprocess_masks_padded
from .generate import greedy_generate


class EvaluateResult(NamedTuple):
    output_ids: torch.Tensor        # (B, T) generated tokens
    gen_lengths: torch.Tensor       # (B,)
    pred_masks_left: torch.Tensor   # (B, S, S) canvas logits, float32
    pred_masks_right: torch.Tensor  # (B, S, S)
    taxonomies: torch.Tensor        # (B, 4) softmax probabilities
    seg_found: torch.Tensor         # (B,) bool: a [SEG] was emitted


@torch.inference_mode()
def evaluate_fn(model: LisaModel, images_sam, images_clip, input_ids,
                attention_mask, max_new_tokens: int, eos_id: int,
                kv_cache_8bit: bool = False) -> EvaluateResult:
    """images_sam (B, S, S, 3) and images_clip (B, C, C, 3) preprocessed
    NHWC; input_ids (B, L) with IMAGE_TOKEN_INDEX; attention_mask (B, L),
    1 = real token (right padding). Inputs (tensors or numpy) are moved to
    the model's device; the result stays there. `kv_cache_8bit` decodes
    over an int8 KV cache."""
    cfg = model.cfg
    dev = model.device
    as_t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    images_sam, images_clip = as_t(images_sam), as_t(images_clip)
    input_ids, attention_mask = as_t(input_ids).long(), as_t(attention_mask)

    clip_emb = model.encode_clip(images_clip)
    tok = model.embed_tokens(input_ids)
    sp = splice_image_embeddings(
        tok, clip_emb, find_image_position(input_ids), input_ids, None,
        attention_mask, seg_token_idx=cfg.seg_token_idx)
    gen = greedy_generate(
        cfg.llama, model.embed_tokens, model.llm_forward, sp.embeds,
        sp.positions, sp.segment_ids, sp.segment_ids.sum(dim=1),
        max_new_tokens, eos_id, kv_cache_8bit=kv_cache_8bit)

    # [SEG] gather: the hidden state that emitted the first [SEG].
    steps = torch.arange(max_new_tokens, device=dev)[None, :]
    is_seg = (gen.tokens == cfg.seg_token_idx) & (steps < gen.lengths[:, None])
    seg_found = is_seg.any(dim=1)
    first = torch.argmax(is_seg.int(), dim=1)
    rows = torch.arange(gen.tokens.shape[0], device=dev)
    seg_hidden = gen.hiddens[rows, first][:, None]                # (B, 1, E)
    seg_emb = model.project_seg(seg_hidden)
    seg_emb = seg_emb * seg_found[:, None, None].to(seg_emb.dtype)

    sam_emb = model.encode_sam(images_sam)
    masks_l, masks_r, _, _, taxonomy = model.decode_masks(sam_emb, seg_emb)
    S = cfg.sam_encoder.image_size
    return EvaluateResult(
        output_ids=gen.tokens, gen_lengths=gen.lengths,
        pred_masks_left=postprocess_masks_padded(masks_l, S)[:, 0],
        pred_masks_right=postprocess_masks_padded(masks_r, S)[:, 0],
        taxonomies=taxonomy, seg_found=seg_found)
