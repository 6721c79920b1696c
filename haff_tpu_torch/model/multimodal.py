"""Static-shape multimodal token splicing (port of
haff_tpu/model/multimodal.py).

The P CLIP patch features replace the IMAGE_TOKEN_INDEX slot of each row:
the spliced length is always L + P - 1, the image position may differ per
row, and all rows are handled at once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX


class SplicedBatch(NamedTuple):
    embeds: torch.Tensor          # (B, L_out, E)
    labels: torch.Tensor          # (B, L_out) IGNORE over the image span
    segment_ids: torch.Tensor     # (B, L_out) int32, 0 = padding
    positions: torch.Tensor       # (B, L_out) RoPE positions
    seg_token_mask: torch.Tensor  # (B, L_out) bool: next token is [SEG]


def find_image_position(input_ids):
    """Index of the (single) IMAGE_TOKEN_INDEX per row; L for rows
    without one."""
    is_img = input_ids == IMAGE_TOKEN_INDEX
    l = input_ids.shape[1]
    first = torch.argmax(is_img.int(), dim=-1)
    return torch.where(is_img.any(-1), first, torch.full_like(first, l))


def splice_image_embeddings(token_embeds, image_features, image_pos,
                            input_ids, labels: Optional[torch.Tensor] = None,
                            attention_mask: Optional[torch.Tensor] = None,
                            seg_token_idx: Optional[int] = None) -> SplicedBatch:
    b, l, e = token_embeds.shape
    p = image_features.shape[1]
    l_out = l + p - 1
    dev = token_embeds.device
    pos = image_pos.long()[:, None]
    j = torch.arange(l_out, device=dev)[None, :]
    before = j < pos
    in_image = (j >= pos) & (j < pos + p)
    tok_idx = torch.where(before, j, j - (p - 1)).clamp(0, l - 1)
    img_idx = (j - pos).clamp(0, p - 1)

    gather = lambda x, idx: torch.gather(  # noqa: E731
        x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    embeds = torch.where(in_image[..., None],
                         gather(image_features.to(token_embeds.dtype), img_idx),
                         gather(token_embeds, tok_idx))
    gathered_ids = torch.gather(input_ids, 1, tok_idx)

    if labels is not None:
        out_labels = torch.where(in_image, IGNORE_INDEX,
                                 torch.gather(labels, 1, tok_idx))
    else:
        out_labels = torch.full((b, l_out), IGNORE_INDEX, dtype=torch.int32,
                                device=dev)
    if attention_mask is not None:
        seg = torch.where(in_image, 1, torch.gather(attention_mask, 1, tok_idx))
    else:
        seg = torch.ones((b, l_out), dtype=torch.int32, device=dev)
    seg = seg.to(torch.int32)
    positions = (torch.cumsum(seg, dim=1) - 1).clamp(min=0)

    if seg_token_idx is not None:
        # True at slot i when the token at slot i+1 is [SEG]: the hidden
        # state that emits [SEG].
        is_seg = (gathered_ids == seg_token_idx) & ~in_image & (seg != 0)
        seg_mask = torch.cat(
            [is_seg[:, 1:], torch.zeros((b, 1), dtype=torch.bool, device=dev)],
            dim=1)
    else:
        seg_mask = torch.zeros((b, l_out), dtype=torch.bool, device=dev)
    return SplicedBatch(embeds=embeds, labels=out_labels, segment_ids=seg,
                        positions=positions, seg_token_mask=seg_mask)


def gather_seg_embeddings(hidden, seg_token_mask, max_segs: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to max_segs [SEG]-emitting hidden states per row: hidden
    (B, L, D) -> (embeddings (B, max_segs, D), valid (B, max_segs) bool);
    rows with fewer are zero-filled, extras dropped."""
    rank = torch.cumsum(seg_token_mask.int(), dim=1) - 1
    embs, valid = [], []
    for s in range(max_segs):
        hit = seg_token_mask & (rank == s)
        idx = torch.argmax(hit.int(), dim=1)
        ok = hit.any(dim=1)
        row = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
        embs.append(row * ok[:, None].to(hidden.dtype))
        valid.append(ok)
    return torch.stack(embs, dim=1), torch.stack(valid, dim=1)
