"""Tokenization: the image-token splice and a hermetic fallback tokenizer
(port of haff_tpu/data/tokenizer.py; plain Python and numpy).

`tokenizer_image_token` has capability parity with reference
llava/mm_utils.py:19-44 (split on <image>, tokenize chunks, interleave
IMAGE_TOKEN_INDEX, keep a single BOS).

`ByteTokenizer` is a deterministic byte-level tokenizer with the LLaMA
special-token layout ([SEG] added as a regular token, pad == unk,
<im_start>/<im_end> specials — reference train_ds.py:135-149). It makes
the whole framework runnable with zero network access; production runs
load the real LLaMA tokenizer from a local path via `load_tokenizer`.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..core.config import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IMAGE_TOKEN_INDEX,
    SEG_TOKEN,
)


class _Encoding:
    def __init__(self, input_ids):
        self.input_ids = input_ids


class ByteTokenizer:
    """Byte-level tokenizer: id = 4 + byte. ids 0-3: unk, bos, eos, pad0.
    Added tokens (in order): [SEG], <im_start>, <im_end>."""

    def __init__(self, model_max_length: int = 896):
        self.model_max_length = model_max_length
        self.unk_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 0  # pad = unk (reference train_ds.py:148)
        self._base = 4 + 256
        self._added: List[str] = []
        self.add_tokens(SEG_TOKEN)
        self.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN])

    @property
    def vocab_size(self):
        return self._base + len(self._added)

    def __len__(self):
        return self.vocab_size

    def add_tokens(self, tokens, special_tokens: bool = False):
        if isinstance(tokens, str):
            tokens = [tokens]
        n = 0
        for t in tokens:
            if t not in self._added:
                self._added.append(t)
                n += 1
        return n

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._added:
            return self._base + self._added.index(token)
        raise KeyError(token)

    def _encode_text(self, text: str) -> List[int]:
        if not self._added:
            return [4 + b for b in text.encode("utf-8")]
        pattern = "(" + "|".join(re.escape(t) for t in self._added) + ")"
        ids: List[int] = []
        for part in re.split(pattern, text):
            if not part:
                continue
            if part in self._added:
                ids.append(self._base + self._added.index(part))
            else:
                ids.extend(4 + b for b in part.encode("utf-8"))
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = self._encode_text(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return _Encoding(ids)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        buf = bytearray()
        for i in np.asarray(ids).tolist():
            if 4 <= i < self._base:
                buf.append(i - 4)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if self._base <= i < self._base + len(self._added):
                    out.append(self._added[i - self._base])
                elif i >= self._base + len(self._added):
                    pass  # out-of-vocab id (e.g. untrained model output)
                elif not skip_special_tokens:
                    out.append({0: "<unk>", 1: "<s>", 2: "</s>"}.get(i, ""))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def load_tokenizer(path_or_name: Optional[str] = None,
                   model_max_length: int = 896):
    """Real HF tokenizer from a LOCAL path when available, ByteTokenizer
    otherwise (zero-egress environments). Adds [SEG] and the image
    specials exactly like reference train_ds.py:135-149."""
    if path_or_name:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(
                path_or_name, model_max_length=model_max_length,
                use_fast=False, local_files_only=True)
            tok.pad_token = tok.unk_token
            tok.add_tokens(SEG_TOKEN)
            tok.add_tokens(
                [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                special_tokens=True)
            return tok
        except Exception:
            pass
    return ByteTokenizer(model_max_length=model_max_length)


def seg_token_idx(tokenizer) -> int:
    return tokenizer.convert_tokens_to_ids(SEG_TOKEN)


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Split on <image>, tokenize chunks, interleave the image sentinel,
    keep one BOS (reference mm_utils.py:19-44)."""
    chunks = [tokenizer(c).input_ids
              for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    ids: List[int] = []
    offset = 0
    if chunks and len(chunks[0]) > 0 and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])
    return ids
