"""DeepSeek-V3 decoder (Moonlight-16B-A3B), plain float32, after the
published `modeling_deepseek.py` (DeepseekV3ForCausalLM) with the
configuration's keys under their published names.

Pre-norm blocks of RMSNorm (float32), multi-head latent attention in
its plain form, no q-LoRA (`q_lora_rank` null): `q = W_q x` per head
split into q_nope and q_pe; `[c, k_pe] = W_kva x`; `c = RMSNorm(c)`;
`[k_nope, v] = W_kvb c` per head; RoPE (theta `rope_theta`, no scaling)
on q_pe and the one shared k_pe, the published file's view/transpose
before `rotate_half`: entry 2i goes to i and 2i + 1 to i + D/2, then
rotate-half; scores `q . k / sqrt(nope + rope)` under a causal mask;
`W_o` over the heads' `softmax . v`. The first `first_k_dense_replace`
layers are SwiGLU of `intermediate_size`; the others MoE: sigmoid scores
of `W_g x`, top-`num_experts_per_tok` of the scores plus the correction
bias (one group: `n_group` = `topk_group` = 1), weights the chosen
scores over their sum (+ 1e-20) times `routed_scaling_factor`, each
token through its experts' SwiGLU of `moe_intermediate_size` (each
expert over the tokens that chose it), plus the shared experts' SwiGLU
(`n_shared_experts` x the width).
Untied LM head after the final norm. One full forward over the whole
sequence; no cache, no batching.

Weights are a dict of tensors named as the program's parameters; bf16
ones are taken to float32 at use (the benchmark's weights are bf16
values, so nothing is rounded).

The routing check: with `forced` (L, MoE layers, k), the experts the
program chose at each position, the reference compares its own top-k
with them at every MoE layer and token. Where the sets differ, each
expert the program took that the reference did not must score (with
the bias, as the choice is made) within a margin of the reference's
k-th best; the largest such margin is returned. The reference then
continues with the program's set, weighed by its own scores, so one
legitimate near-tie does not compound.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _w(W, name):
    return W[name].float()


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, dim, theta):
    """x (..., L, dim) at positions (L,): the published layout change
    (pairs (2i, 2i+1) to (i, i + dim/2)), then rotate-half."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=x.device) / dim))
    ang = positions.float()[:, None] * inv[None]
    emb = torch.cat([ang, ang], -1)
    cos, sin = emb.cos(), emb.sin()
    x = x.unflatten(-1, (dim // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., dim // 2:], x[..., :dim // 2]], -1)
    return x * cos + rot * sin


def _swiglu(x, W, name):
    g = F.linear(x, _w(W, name + ".gate_proj.weight"))
    u = F.linear(x, _w(W, name + ".up_proj.weight"))
    return F.linear(F.silu(g) * u, _w(W, name + ".down_proj.weight"))


def attention(x, W, cfg, name, latents=None):
    """MLA over x (L, d), causal, the plain form. `latents`, a list,
    gains the layer's (L, kv_lora_rank + rope) normed c and roped k_pe
    (k_pe in the published layout)."""
    l = x.shape[0]
    nh = cfg["num_attention_heads"]
    nope, rp, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    pos = torch.arange(l, device=x.device)
    q = F.linear(x, _w(W, name + ".q_proj.weight")).view(l, nh, nope + rp)
    q_nope, q_pe = q.split([nope, rp], -1)
    c, k_pe = F.linear(x, _w(W, name + ".kv_a_proj_with_mqa.weight")).split(
        [rank, rp], -1)
    c = _rms(c, _w(W, name + ".kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    k_nope, v = F.linear(c, _w(W, name + ".kv_b_proj.weight")).view(
        l, nh, nope + vd).split([nope, vd], -1)
    q_pe = rope(q_pe.transpose(0, 1), pos, rp, cfg["rope_theta"])  # (nh, L, rp)
    k_pe = rope(k_pe[None], pos, rp, cfg["rope_theta"])             # (1, L, rp)
    if latents is not None:
        latents.append(torch.cat([c, k_pe[0]], -1))
    qf = torch.cat([q_nope.transpose(0, 1), q_pe], -1)
    kf = torch.cat([k_nope.transpose(0, 1), k_pe.expand(nh, -1, -1)], -1)
    s = qf @ kf.transpose(-1, -2) / (nope + rp) ** 0.5
    s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    o = (s.softmax(-1) @ v.transpose(0, 1)).transpose(0, 1).reshape(l, nh * vd)
    return F.linear(o, _w(W, name + ".o_proj.weight"))


def route(x, W, cfg, name):
    """(choice scores s + bias (L, E), sigmoid scores s (L, E))."""
    s = torch.sigmoid(F.linear(x, _w(W, name + ".gate.weight")))
    return s + _w(W, name + ".gate.e_score_correction_bias"), s


def moe(x, W, cfg, name, forced=None, stats=None):
    """The MoE FFN over x (L, d). `forced` (L, k): the program's experts,
    followed after the margin check (see the module docstring)."""
    k = cfg["num_experts_per_tok"]
    choice, s = route(x, W, cfg, name)
    top = torch.topk(choice, k, dim=-1)
    idx = top.indices
    if forced is not None:
        forced = forced.to(idx.device).long()
        mine = torch.zeros_like(choice, dtype=torch.bool).scatter_(1, idx, True)
        theirs = torch.zeros_like(mine).scatter_(1, forced, True)
        differ = (mine != theirs).any(-1)
        kth = top.values[:, -1:]
        margin = torch.where(theirs & ~mine, kth - choice,
                             torch.zeros_like(choice)).amax(-1)
        if stats is not None:
            stats["tokens"] += int(differ.numel())
            stats["mismatched"] += int(differ.sum())
            stats["margin_max"] = max(stats["margin_max"], float(margin.max()))
        idx = forced
    w = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    gate, up, down = (W[f"{name}.{p}"] for p in ("gate_proj", "up_proj",
                                                 "down_proj"))
    for e in range(gate.shape[0]):
        sel = idx == e
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(xe @ gate[e].float().T) * (xe @ up[e].float().T)
        y[rows] += (w * sel).sum(-1)[rows, None] * (h @ down[e].float().T)
    return y + _swiglu(x, W, name + ".shared_experts")


@torch.no_grad()
def forward(embeds, W, cfg, prefix="llm.", forced=None):
    """embeds (L, d) -> dict(logits (L, vocab), hidden after the final
    norm (L, d), latents (layers, L, kv_lora_rank + rope): what a latent
    cache holds, k_pe in the published layout; and with `forced` (L, MoE
    layers, k) the routing readings: tokens, mismatched, margin_max)."""
    stats = dict(tokens=0, mismatched=0, margin_max=0.0)
    latents = []
    eps = cfg["rms_norm_eps"]
    x = embeds.float()
    first = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        name = f"{prefix}layers.{i}"
        h = _rms(x, _w(W, name + ".input_layernorm.weight"), eps)
        x = x + attention(h, W, cfg, name + ".self_attn", latents)
        h = _rms(x, _w(W, name + ".post_attention_layernorm.weight"), eps)
        if i < first:
            x = x + _swiglu(h, W, name + ".mlp")
        else:
            f = None if forced is None else forced[:, i - first]
            x = x + moe(h, W, cfg, name + ".mlp", f, stats)
    hidden = _rms(x, _w(W, prefix + "norm.weight"), eps)
    out = dict(logits=F.linear(hidden, _w(W, prefix + "lm_head.weight")),
               hidden=hidden, latents=torch.stack(latents))
    if forced is not None:
        out.update(stats)
    return out
