"""LISA / 2HandedAfforder evaluate with the MPT decoder, plain float32.

The prompt as LLaVA builds it (the llava_v1 conversation, the image
token wrapped in <im_start> / <im_end>, one BOS), tokenized by the byte
scheme of the configuration's tokenizer (`ByteTokenizer`: id = 4 + byte,
BOS 1, EOS 2, then the added tokens [SEG], <im_start>, <im_end>); CLIP
features replace the image token; MPT runs once over the prompt and the
served tokens (teacher forcing, no cache); the hidden state that emitted
the first served [SEG] goes through the projection MLP (zero when no
[SEG] was served: the program's static-shape convention) and prompts both
SAM mask decoders; the masks are resized to the frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import clip as ref_clip
from . import mpt as ref_mpt
from . import sam as ref_sam

IMAGE_TOKEN = -200
SYSTEM = ("A chat between a curious human and an artificial intelligence "
          "assistant. The assistant gives helpful, detailed, and polite "
          "answers to the human's questions.")
ADDED = ("[SEG]", "<im_start>", "<im_end>")


def _byte_ids(text: str):
    """Byte tokens with the added tokens matched whole."""
    ids, i = [], 0
    while i < len(text):
        for k, tok in enumerate(ADDED):
            if text.startswith(tok, i):
                ids.append(260 + k)
                i += len(tok)
                break
        else:
            j = i
            while j < len(text) and not any(text.startswith(t, j) for t in ADDED):
                j += 1
            ids.extend(4 + b for b in text[i:j].encode("utf-8"))
            i = j
    return ids


def prompt_ids(prompt: str, max_len: int):
    """The llava_v1 prompt of one question, with IMAGE_TOKEN in place of
    the image, truncated to `max_len` as the program's collate does."""
    question = prompt if "<image>" in prompt else "<image>\n" + prompt
    question = question.replace("<image>", "<im_start><image><im_end>")
    text = SYSTEM + " USER: " + question + " ASSISTANT:"
    before, after = text.split("<image>")
    ids = [1] + _byte_ids(before) + [IMAGE_TOKEN] + _byte_ids(after)
    return ids[:max_len]


def seg_token_id() -> int:
    return 260


@torch.no_grad()
def evaluate(frame: np.ndarray, prompt: str, served, W, cfg, device):
    """One request. `served`: the token ids the program served (up to and
    including EOS). Returns dict(logits (T, vocab) and hidden (T, d): the
    logits at each served position and the hidden state after the final
    norm that gave them, masks_left, masks_right (H, W) logits at the frame's size, taxonomy
    (4,))."""
    lisa, mpt = cfg["lisa"], cfg["mpt"]
    ids = prompt_ids(prompt, lisa["max_text_len"])
    pos = ids.index(IMAGE_TOKEN)
    pixels = ref_clip.preprocess(frame, cfg["clip"]["image_size"]).to(device)
    feats = ref_clip.vision_tower(pixels, W, cfg["clip"])
    feats = F.linear(feats, W["mm_projector.weight"], W["mm_projector.bias"])[0]
    served = [int(t) for t in served]
    wte = W["llm.wte.weight"]
    tok = lambda t: wte[torch.as_tensor(t, device=device, dtype=torch.long)]  # noqa: E731
    embeds = torch.cat([tok(ids[:pos]), feats, tok(ids[pos + 1:]),
                        tok(served[:-1]) if len(served) > 1
                        else wte[:0]], 0)[None]
    logits, hidden = ref_mpt.forward(embeds, W, mpt)
    n = len(ids) - 1 + feats.shape[0]  # the spliced prompt's length
    at = slice(n - 1, n - 1 + len(served))

    seg = seg_token_id()
    emb = torch.zeros((1, 1, lisa["out_dim"]), device=device)
    if seg in served:
        h = hidden[0, n - 1 + served.index(seg)]
        h = F.relu(F.linear(h, W["text_fc1.weight"], W["text_fc1.bias"]))
        emb = F.linear(h, W["text_fc2.weight"], W["text_fc2.bias"])[None, None]
    image = ref_sam.embed_image(frame, W, cfg["sam"], device, "visual_model.")
    ml, mr, tax = ref_sam.decode(image, emb, W, cfg["sam"], "visual_model.")
    return dict(logits=logits[0, at], hidden=hidden[0, at],
                masks_left=ml[0, 0],
                masks_right=mr[0, 0], taxonomy=tax[0])


def gaps(logits, tokens) -> np.ndarray:
    """How far each token's logit lies below the best, position by
    position: logits (T, vocab), tokens (T,)."""
    t = torch.as_tensor(np.asarray(tokens), device=logits.device).long()
    picked = logits[torch.arange(len(t), device=logits.device), t]
    return (logits.max(-1).values - picked).cpu().numpy()
