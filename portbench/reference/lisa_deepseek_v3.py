"""LISA / 2HandedAfforder evaluate with the DeepSeek-V3 decoder, plain
float32: reference/lisa.py's prompt, CLIP splice, [SEG] projection and
SAM decode around reference/deepseek_v3.py, run once over the prompt and
the served tokens (teacher forcing, no cache). With the program's
routing it also checks the experts the program chose (deepseek_v3.py's
module docstring) and continues with them."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import clip as ref_clip
from . import deepseek_v3 as ref_ds
from . import lisa as ref_lisa
from . import sam as ref_sam


@torch.no_grad()
def evaluate(frame: np.ndarray, prompt: str, served, W, cfg, device,
             prompt_experts=None, decode_experts=None):
    """One request (one row). `served`: the token ids the program served
    (up to and including EOS); `prompt_experts` (>= prompt length, MoE
    layers, k) and `decode_experts` (>= served - 1, MoE layers, k): the
    experts the program chose at the prompt's positions and at each fed
    token, or None for the reference's own routing. Returns
    reference/lisa.evaluate's dict with `latents` (layers, served, latent
    width): what each layer's latent cache holds from the last prompt
    position on (k_pe in the published layout), and with the routing its
    readings (tokens, mismatched, margin_max)."""
    lisa = cfg["lisa"]
    ids = ref_lisa.prompt_ids(prompt, lisa["max_text_len"])
    pos = ids.index(ref_lisa.IMAGE_TOKEN)
    pixels = ref_clip.preprocess(frame, cfg["clip"]["image_size"]).to(device)
    feats = ref_clip.vision_tower(pixels, W, cfg["clip"])
    feats = F.linear(feats, W["mm_projector.weight"], W["mm_projector.bias"])[0]
    served = [int(t) for t in served]
    emb = W["llm.embed_tokens.weight"]
    tok = lambda t: emb[torch.as_tensor(t, device=device,  # noqa: E731
                                        dtype=torch.long)].float()
    embeds = torch.cat([tok(ids[:pos]), feats, tok(ids[pos + 1:]),
                        tok(served[:-1]) if len(served) > 1
                        else feats[:0]], 0)
    n = len(ids) - 1 + feats.shape[0]  # the spliced prompt's length
    forced = None
    if prompt_experts is not None:
        forced = torch.cat([torch.as_tensor(prompt_experts[:n]),
                            torch.as_tensor(decode_experts[:len(served) - 1])],
                           0).to(device)
    out = ref_ds.forward(embeds, W, cfg, forced=forced)
    logits, hidden = out["logits"], out["hidden"]
    at = slice(n - 1, n - 1 + len(served))

    seg = ref_lisa.seg_token_id()
    proj = torch.zeros((1, 1, lisa["out_dim"]), device=device)
    if seg in served:
        h = hidden[n - 1 + served.index(seg)]
        h = F.relu(F.linear(h, W["text_fc1.weight"], W["text_fc1.bias"]))
        proj = F.linear(h, W["text_fc2.weight"], W["text_fc2.bias"])[None, None]
    image = ref_sam.embed_image(frame, W, cfg["sam"], device, "visual_model.")
    ml, mr, tax = ref_sam.decode(image, proj, W, cfg["sam"], "visual_model.")
    res = dict(logits=logits[at], hidden=hidden[at], masks_left=ml[0, 0],
               masks_right=mr[0, 0], taxonomy=tax[0],
               latents=out["latents"][:, at])
    for k in ("tokens", "mismatched", "margin_max"):
        if k in out:
            res[k] = out[k]
    return res
