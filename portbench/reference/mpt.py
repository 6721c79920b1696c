"""MPT decoder with ALiBi, plain float32 (MosaicML `modeling_mpt.py`,
mosaicml/mpt-7b, as LLaVA's `llava_mpt.py` uses it).

Pre-norm blocks, LayerNorms without bias (`no_bias`), fused `Wqkv`,
softmax scale 1/sqrt(head_dim), the ALiBi bias -slope_h * (i - j) under a
causal mask, an exact-GELU MLP of `expansion_ratio`, a final norm and the
LM head tied to `wte`. No positional embedding: with ALiBi the reference
code of that time builds none, whatever `learned_pos_emb` says.
One full forward over the whole sequence; no cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F



def alibi_slopes(n_heads: int, alibi_bias_max: int = 8, device=None):
    """gen_slopes: 1 / 2^m on the next power of two's ladder."""
    p2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, p2 + 1, dtype=torch.float32, device=device)
    slopes = 1.0 / torch.pow(2, m * (alibi_bias_max / p2))
    if p2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes


def _ln(x, W, name, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], None, eps)


def forward(embeds, W, mpt, prefix="llm."):
    """embeds (B, L, d) -> (logits (B, L, vocab), hidden after norm_f)."""
    p = prefix
    b, l, d = embeds.shape
    nh = mpt["n_heads"]
    hd = d // nh
    dev = embeds.device
    i = torch.arange(l, device=dev)
    dist = (i[:, None] - i[None, :]).float()
    slopes = alibi_slopes(nh, mpt["alibi_bias_max"], dev)
    bias = -slopes[:, None, None] * dist[None]
    bias = bias.masked_fill((dist < 0)[None], float("-inf"))[None]
    x = embeds
    for n in range(mpt["n_layers"]):
        bp = f"{p}blocks.{n}"
        y = _ln(x, W, bp + ".norm_1")
        qkv = F.linear(y, W[bp + ".attn.Wqkv.weight"])
        q, k, v = (t.view(b, l, nh, hd).transpose(1, 2) for t in qkv.split(d, -1))
        s = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd) + bias
        o = torch.matmul(s.softmax(-1), v).transpose(1, 2).reshape(b, l, d)
        x = x + F.linear(o, W[bp + ".attn.out_proj.weight"])
        y = F.gelu(F.linear(_ln(x, W, bp + ".norm_2"), W[bp + ".up_proj.weight"]))
        x = x + F.linear(y, W[bp + ".down_proj.weight"])
    h = _ln(x, W, p + "norm_f")
    return F.linear(h, W[p + "wte.weight"]), h
