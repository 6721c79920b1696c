"""Static-shape batch assembly (port of haff_tpu/data/collate.py; numpy,
with the port's host transforms, so the arrays are byte-equal to the JAX
package's).

Tokenize with the image sentinel, pad, mask the system + instruction
spans with IGNORE_INDEX, truncate to the text length. Every batch has the
same shapes (text padded to a fixed length, batch padded with zero-weight
rows), so one captured decode graph (infer/evaluate.py
make_jitted_evaluate) serves every batch of a bucket.

Label boundary: the span is the longest common token prefix of the full
conversation and the instruction prefix (see tokenize_conversation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.config import IGNORE_INDEX
from .prompts import build_conversation, wrap_image_tokens
from .tokenizer import tokenizer_image_token


@dataclass
class Sample:
    """One training example at original resolution (host-side)."""

    image: np.ndarray            # (H, W, 3) uint8 RGB
    question: str                # with <image> sentinel
    answer: Optional[str]        # None for inference prompts
    mask_left: Optional[np.ndarray] = None    # (H, W) binary
    mask_right: Optional[np.ndarray] = None
    taxonomy: Optional[np.ndarray] = None     # (4,)
    # Multi-turn conversations (VQA): list of (question, answer) rounds;
    # overrides question/answer when set. First question carries <image>.
    turns: Optional[List] = None


def tokenize_conversation(question: str, answer: Optional[str], tokenizer,
                          conv_type: str = "llava_v1",
                          use_mm_start_end: bool = True,
                          use_template: bool = True):
    """Returns (input_ids list, labels list). Labels IGNORE everything up
    to and including the assistant role marker; answer + EOS supervised.

    use_template=False tokenizes the bare question (the reference's
    benchmark-inference convention, inference.py:221-226 — no system
    prompt, no USER/ASSISTANT roles); only valid for answer=None.

    The instruction/answer boundary is the longest common prefix of the
    full and prefix-only tokenizations: SentencePiece emits a phantom
    trailing-'\\u2581' token when 'ASSISTANT: ' is tokenized standalone
    (it merges into the first answer token in the full string), so a raw
    len(prefix_ids) boundary would mask the first answer token — the
    reference compensates with a magic -2 (dataset.py:120); the common
    prefix is exact for any tokenizer."""
    if not use_template:
        assert answer is None, "bare prompts are inference-only"
        full = wrap_image_tokens(question, use_mm_start_end)
        ids = tokenizer_image_token(full, tokenizer)
        return ids, [IGNORE_INDEX] * len(ids)
    full = build_conversation(question, answer, conv_type)
    full = wrap_image_tokens(full, use_mm_start_end)
    ids = tokenizer_image_token(full, tokenizer)
    if answer is None:
        return ids, [IGNORE_INDEX] * len(ids)
    # prefix = everything before the answer text ("ASSISTANT: " for
    # llava_v1, "[/INST] " for llava_llama_2)
    from .prompts import CONV_TEMPLATES

    marker = CONV_TEMPLATES[conv_type].answer_marker
    prefix = full[: full.rindex(marker) + len(marker)]
    prefix_ids = tokenizer_image_token(prefix, tokenizer)
    boundary = 0
    for a, b in zip(ids, prefix_ids):
        if a != b:
            break
        boundary += 1
    labels = [IGNORE_INDEX] * boundary + list(ids[boundary:])
    return ids, labels


def _common_prefix_len(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def tokenize_multiturn(turns, tokenizer, conv_type: str = "llava_v1",
                       use_mm_start_end: bool = True):
    """Multi-turn conversation (reference vqa_dataset.py appends every
    (human, gpt) round into ONE conversation; collate supervises each
    answer span + its EOS separator). Returns (ids, labels)."""
    from .prompts import CONV_TEMPLATES

    conv = CONV_TEMPLATES[conv_type].copy()
    for q, a in turns:
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], a)
    full = wrap_image_tokens(conv.get_prompt(), use_mm_start_end)
    ids = tokenizer_image_token(full, tokenizer)
    labels = [IGNORE_INDEX] * len(ids)
    marker = conv.answer_marker
    pos = 0
    for q, a in turns:
        m = full.find(marker, pos)
        if m < 0 or not a:
            break
        start = full[: m + len(marker)]
        if conv.style == "llama_2":
            # rendered as '[/INST] {a} </s>'
            end = full[: m + len(marker) + len(a) + 1 + len(conv.sep2)]
        else:
            # rendered as 'ASSISTANT: {a}</s>'
            end = full[: m + len(marker) + len(a) + len(conv.sep2)]
        b0 = _common_prefix_len(ids, tokenizer_image_token(start,
                                                          tokenizer))
        b1 = _common_prefix_len(ids, tokenizer_image_token(end, tokenizer))
        # the end-prefix may re-merge at its boundary; never unsupervise
        # past the full length
        b1 = max(b1, b0)
        labels[b0:b1] = ids[b0:b1]
        pos = m + len(marker)
    return ids, labels


def collate_affordance(samples: Sequence[Sample], tokenizer, *,
                       sam_image_size: int = 1024, clip_image_size: int = 224,
                       max_text_len: int = 320, batch_size: int = None,
                       conv_type: str = "llava_v1",
                       use_mm_start_end: bool = True,
                       use_template: bool = True,
                       for_training: bool = True) -> Dict[str, np.ndarray]:
    """Samples -> dict of fixed-shape numpy arrays matching
    model/lisa.py TrainBatch fields."""
    from .transforms import (
        clip_preprocess,
        mask_to_canvas,
        sam_preprocess,
        valid_region,
    )

    n = len(samples)
    b = batch_size or n
    assert b >= n
    S, C = sam_image_size, clip_image_size

    images_sam = np.zeros((b, S, S, 3), np.float32)
    images_clip = np.zeros((b, C, C, 3), np.float32)
    input_ids = np.zeros((b, max_text_len), np.int32)
    labels = np.full((b, max_text_len), IGNORE_INDEX, np.int32)
    attention = np.zeros((b, max_text_len), np.int32)
    masks_l = np.zeros((b, S, S), np.float32)
    masks_r = np.zeros((b, S, S), np.float32)
    taxonomies = np.zeros((b, 4), np.float32)
    valid = np.zeros((b, S, S), np.float32)
    weight = np.zeros((b,), np.float32)
    resizes = np.zeros((b, 2), np.int32)

    for i, s in enumerate(samples):
        canvas, resize_hw = sam_preprocess(s.image, S)
        images_sam[i] = canvas
        images_clip[i] = clip_preprocess(s.image, C)
        resizes[i] = resize_hw
        if s.turns and for_training:
            ids, labs = tokenize_multiturn(s.turns, tokenizer, conv_type,
                                           use_mm_start_end)
        else:
            ids, labs = tokenize_conversation(
                s.question, s.answer if for_training else None, tokenizer,
                conv_type, use_mm_start_end, use_template=use_template)
        # Truncate like the reference (model_max_length cap pre-splice).
        ids = ids[:max_text_len]
        labs = labs[:max_text_len]
        input_ids[i, :len(ids)] = ids
        labels[i, :len(labs)] = labs
        attention[i, :len(ids)] = 1
        if s.mask_left is not None:
            masks_l[i] = mask_to_canvas(s.mask_left, resize_hw, S)
        if s.mask_right is not None:
            masks_r[i] = mask_to_canvas(s.mask_right, resize_hw, S)
        if s.taxonomy is not None:
            taxonomies[i] = s.taxonomy
        valid[i] = valid_region(resize_hw, S)
        weight[i] = 1.0

    return dict(
        images_sam=images_sam, images_clip=images_clip,
        image_index=np.arange(b, dtype=np.int32), input_ids=input_ids,
        labels=labels, attention_mask=attention, masks_left=masks_l,
        masks_right=masks_r, taxonomies=taxonomies, valid_region=valid,
        sample_weight=weight, resizes=resizes)
