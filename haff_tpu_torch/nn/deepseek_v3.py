"""DeepSeek-V3 decoder backend (Moonlight-16B-A3B): multi-head latent
attention (MLA) over a latent KV cache, and dropless sigmoid-routed
experts with shared experts, after the published `modeling_deepseek.py`.

Per layer `h = x + Attn(RMSNorm(x))`, `out = h + FFN(RMSNorm(h))`, the
norms in float32. The first `first_k_dense_replace` layers' FFN is a
SwiGLU of `intermediate_size`; the others are MoE layers.

MLA at positions p: `q = W_q x` is split per head into `q_nope` and
`q_pe`; `[c, k_pe] = W_kva x`, `c = RMSNorm(c)`, `[k_nope, v] = W_kvb c`
per head. RoPE rotates the pairs (2i, 2i+1) of `q_pe` and of the one
shared `k_pe` at frequency i (what the published file's view/transpose
before `rotate_half` amounts to, up to a permutation both sides share).
The scores are `[q_nope, q_pe] . [k_nope, k_pe] / sqrt(nope + rope)`.
The prefill runs that form (torch's `scaled_dot_product_attention` over
the decompressed heads) and writes `[c, RoPE(k_pe)]`, `kv_lora_rank +
qk_rope_head_dim` values a token, into the layer's latent cache. A
decode step runs the absorbed form over that cache: per head,
`q_lat = W_UK^T q_nope`, scores `(q_lat . c_j + q_pe . k_pe_j) * scale`,
`o_lat = sum_j softmax_j c_j`, and the head's output `W_UV o_lat`, where
W_UK and W_UV are the k_nope and v rows of W_kvb
(kernels/mla_decode_attention.py: the new slot written and attended in
one launch).

Routing: `s = sigmoid(W_g x)` in float32, `idx = top-k(s + bias)` (the
correction bias chooses, it never weighs), `w = s[idx] / (sum s[idx] +
1e-20) * routed_scaling_factor`, `y = sum_k w_k SwiGLU_{idx_k}(x) +
SwiGLU_shared(x)`. Dropless at every length: no capacity, no token
passes on the residual. A prefill sorts its (token, expert) pairs by
expert on the device and runs the experts' products as grouped matrix
products over the offsets of a device cumsum (`torch._grouped_mm` on the
card, a loop over experts on the CPU); a decode step's routed experts
are one launch of kernels/moe_decode.py, which reads only the chosen
experts' weights, and the shared experts' (as n_shared_experts more
experts of the routed width, weight 1) in the same launch. A forward
asked `with_aux` returns the experts its MoE layers chose as a fourth
item, (B, L, MoE layers, top-k) int16 (infer/generate.py records them).

The same (logits, hidden, caches) interface as nn/llama.py. Serving
only: no LoRA, no int8 cache, no speculative verify chunk, no mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.mla_decode_attention import mla_decode_write_attention
from ..kernels.moe_decode import moe_decode
from ..utils.profiling import span
from .layers import QDense
from .llama import Embed
from .llama import RMSNorm as _RMSNorm


class _Float32Params:
    """A module whose parameters stay float32 through `.to(dtype)` (the
    norms' and the router's, which compute in float32 anyway): no cast a
    call. Loading bf16 values into them is exact."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for p in self._parameters.values():
            if p is not None and p.is_floating_point() and p.dtype != torch.float32:
                p.data = p.data.float()
        return self


class RMSNorm(_Float32Params, _RMSNorm):
    """nn/llama.py's RMSNorm (float32, cast back), through torch's fused
    rms_norm, with a float32 weight: fewer launches a decode step, the
    same function."""

    def forward(self, x):
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight.float(),
                          self.eps).to(x.dtype)


@dataclass(frozen=True)
class DeepseekV3Config:
    """Moonlight-16B-A3B's published config.json by default."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264       # the dense first layer's SwiGLU
    moe_intermediate_size: int = 1408    # one routed expert's
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192

    @staticmethod
    def preset(name: str) -> "DeepseekV3Config":
        if name == "moonlight":
            return DeepseekV3Config()
        if name == "tiny":  # test-size: 3 layers, the first dense
            return DeepseekV3Config(
                vocab_size=512, hidden_size=64, intermediate_size=128,
                moe_intermediate_size=32, num_layers=3, num_heads=4,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
                n_shared_experts=1, routed_scaling_factor=2.446,
                max_seq_len=1024)
        raise ValueError(f"unknown deepseek_v3 preset {name!r}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token a layer in the latent cache: [c, k_pe]."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace


def rope_pairs(x, cis):
    """x (B, L, H, D); cis (B, L, D/2) complex64, exp(i positions *
    inv_freq): the pairs (2i, 2i+1) rotated by angle i as complex
    products in float32, cast back to x's dtype."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)).contiguous())
    return torch.view_as_real(xc * cis[:, :, None]).flatten(-2).to(x.dtype)


class MlaAttention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        d, nh = cfg.hidden_size, cfg.num_heads
        self.q_proj = QDense(d, nh * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = QDense(d, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = QDense(cfg.kv_lora_rank,
                                nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                bias=False)
        self.o_proj = QDense(nh * cfg.v_head_dim, d, bias=False)

    def _project(self, x, cis):
        """(q_nope (B, L, nh, nope), q_pe roped, latent (B, L, rank + rope):
        the normed c and the roped k_pe, as the cache holds them)."""
        cfg = self.cfg
        b, l, _ = x.shape
        q = self.q_proj(x).view(b, l, cfg.num_heads, cfg.qk_head_dim)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split(
            [cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
        k_pe = rope_pairs(k_pe[:, :, None], cis)[:, :, 0]
        latent = torch.cat([self.kv_a_layernorm(c), k_pe], dim=-1)
        return q_nope, rope_pairs(q_pe, cis), latent

    def _kv_b(self):
        """W_kvb as (nh, nope + v, rank), for the absorbed form."""
        cfg = self.cfg
        if self.kv_b_proj.quantized:
            raise ValueError("MLA's absorbed decode takes a float kv_b_proj")
        return self.kv_b_proj.weight.view(
            cfg.num_heads, cfg.qk_nope_head_dim + cfg.v_head_dim,
            cfg.kv_lora_rank)

    def forward(self, x, cis, segment_ids=None, cache=None,
                cache_index=None, cache_kv_segment_ids=None):
        """x (B, L, d) at the RoPE angles `cis` (B, L, rope / 2) of its
        positions. Prefill (no cache_kv_segment_ids): causal attention
        over the L inputs within their segments, and, given a cache (B, Lmax,
        latent), their latent rows written at per-row offsets
        `cache_index`. Decode (L == 1, cache and the live-slot mask
        given, the new slot included): the absorbed form over the
        cache, the new latent row written at `cache_index`."""
        cfg = self.cfg
        b, l, _ = x.shape
        nh, nope, vd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        scale = cfg.qk_head_dim ** -0.5
        q_nope, q_pe, latent = self._project(x, cis)
        if cache is not None and cache_kv_segment_ids is not None:
            if l != 1:
                raise ValueError("MLA decodes one token a step (no "
                                 "speculative verify chunk)")
            w = self._kv_b()
            q_lat = torch.einsum("bhn,hnr->bhr", q_nope[:, 0], w[:, :nope])
            q = torch.cat([q_lat, q_pe[:, 0]], dim=-1).contiguous()
            o_lat = mla_decode_write_attention(
                q, latent[:, 0].contiguous().to(cache.dtype), cache,
                cache_kv_segment_ids, cache_index, cfg.kv_lora_rank, scale)
            o = torch.einsum("bhr,hvr->bhv", o_lat.to(w.dtype), w[:, nope:])
            return self.o_proj(o.reshape(b, 1, nh * vd))
        if cache is not None:
            start = (torch.zeros((b,), dtype=torch.long, device=x.device)
                     if cache_index is None else cache_index.long())
            rows = torch.arange(b, device=x.device)[:, None]
            cols = start[:, None] + torch.arange(l, device=x.device)[None, :]
            cache[rows, cols] = latent.to(cache.dtype)
        c = latent[..., :cfg.kv_lora_rank]
        k_nope, v = self.kv_b_proj(c).view(b, l, nh, nope + vd).split(
            [nope, vd], -1)
        k_pe = latent[..., None, cfg.kv_lora_rank:].expand(b, l, nh, -1)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe], -1).transpose(1, 2)
        i = torch.arange(l, device=x.device)
        mask = (i[None, :] <= i[:, None])[None]
        if segment_ids is not None:
            seg = segment_ids
            mask = mask & (seg[:, :, None] == seg[:, None, :])
        out = F.scaled_dot_product_attention(q, k, v.transpose(1, 2),
                                             attn_mask=mask[:, None],
                                             scale=scale)
        return self.o_proj(out.transpose(1, 2).reshape(b, l, nh * vd))


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate_proj = QDense(d, f, bias=False)
        self.up_proj = QDense(d, f, bias=False)
        self.down_proj = QDense(f, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(_Float32Params, nn.Module):
    """The sigmoid router with its correction bias (noaux_tc, one group),
    float32 parameters."""

    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(
            torch.empty(cfg.n_routed_experts))

    def forward(self, x):
        """x (N, d) -> (idx (N, k) int64, weights (N, k) float32)."""
        cfg = self.cfg
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        choice = s + self.e_score_correction_bias.float()
        idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1).indices
        w = s.gather(1, idx)
        if cfg.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * cfg.routed_scaling_factor


def grouped_experts(x, idx, w, gate, up, down):
    """The routed experts of a prefill, dropless: x (N, d), idx / w
    (N, k), stacked weights gate / up (E, F, d) and down (E, d, F).
    Sorted by expert on the device, offsets from a device cumsum; the
    products grouped (`torch._grouped_mm` on the card, a loop over
    experts elsewhere). The k outputs of a token are summed in float32
    in a fixed order. Returns (N, d) in x's dtype."""
    n, k = idx.shape
    e_count = gate.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = x[order // k]
    # Tokens an expert by a scatter-add (torch.bincount would wait for
    # the card to size its output).
    counts = torch.zeros(e_count, dtype=torch.long, device=x.device)
    ends = torch.cumsum(counts.scatter_add_(0, flat, torch.ones_like(flat)), 0)
    if x.is_cuda:
        offs = ends.to(torch.int32)
        h = (F.silu(torch._grouped_mm(xs, gate.transpose(1, 2), offs=offs))
             * torch._grouped_mm(xs, up.transpose(1, 2), offs=offs))
        ys = torch._grouped_mm(h, down.transpose(1, 2), offs=offs)
    else:
        ys = torch.empty_like(xs)
        start = 0
        for e, end in enumerate(ends.tolist()):
            if end > start:
                part = xs[start:end]
                h = F.silu(F.linear(part, gate[e])) * F.linear(part, up[e])
                ys[start:end] = F.linear(h, down[e])
            start = end
    y = torch.empty_like(ys)
    y[order] = ys
    y = (y.view(n, k, -1).float() * w[..., None]).sum(1)
    return y.to(x.dtype)


class DeepseekMoE(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        e, f, d = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_size
        self.gate = Router(cfg)
        self.gate_proj = nn.Parameter(torch.empty(e, f, d))
        self.up_proj = nn.Parameter(torch.empty(e, f, d))
        self.down_proj = nn.Parameter(torch.empty(e, d, f))
        self.shared_experts = SwiGLU(d, f * cfg.n_shared_experts)

    def forward(self, x, decode: bool):
        """x (B, L, d). `decode`: a decode step's tokens (one a row),
        through the routed-expert decode kernel; else the grouped
        prefill path. Returns (y, idx (B, L, k))."""
        b, l, d = x.shape
        flat = x.reshape(b * l, d)
        with span("moe.route"):
            idx, w = self.gate(flat)
        shared = self.shared_experts
        with span("moe.experts"):
            if decode:  # the shared experts in the same launch
                y = moe_decode(flat, idx, w, self.gate_proj, self.up_proj,
                               self.down_proj, (shared.gate_proj.weight,
                                                shared.up_proj.weight,
                                                shared.down_proj.weight))
            else:
                y = grouped_experts(flat, idx, w, self.gate_proj,
                                    self.up_proj, self.down_proj)
        if not decode:
            y = y + shared(flat)
        return y.view(b, l, d), idx.view(b, l, -1)


class DeepseekV3Block(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, is_moe: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MlaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.is_moe = is_moe
        self.mlp = (DeepseekMoE(cfg) if is_moe else
                    SwiGLU(cfg.hidden_size, cfg.intermediate_size))

    def forward(self, x, cis, segment_ids=None, cache=None,
                cache_index=None, cache_kv_segment_ids=None):
        """Returns (x, the experts chosen (B, L, k) or None)."""
        x = x + self.self_attn(self.input_layernorm(x), cis, segment_ids,
                               cache, cache_index, cache_kv_segment_ids)
        h = self.post_attention_layernorm(x)
        if not self.is_moe:
            return x + self.mlp(h), None
        decode = cache is not None and cache_kv_segment_ids is not None
        y, idx = self.mlp(h, decode)
        return x + y, idx


class DeepseekV3ForCausalLM(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            DeepseekV3Block(cfg, i >= cfg.first_k_dense_replace)
            for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size, bias=False)
        self._inv_freq = {}  # device -> (rope / 2,) float32

    def inv_freq(self, device) -> torch.Tensor:
        """RoPE's frequencies on `device`, made once a device (outside any
        CUDA-graph capture: the first prefill makes them)."""
        device = torch.device(device)
        if device not in self._inv_freq:
            dim = self.cfg.qk_rope_head_dim
            self._inv_freq[device] = 1.0 / (self.cfg.rope_theta ** (
                torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                / dim))
        return self._inv_freq[device]

    def rope_cis(self, positions) -> torch.Tensor:
        """exp(i positions * inv_freq), (B, L, rope / 2) complex64: the
        RoPE angles of a forward, made once for all its layers."""
        ang = positions.float()[..., None] * self.inv_freq(positions.device)
        return torch.polar(torch.ones_like(ang), ang)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids.long())

    def forward(self, inputs_embeds, positions, segment_ids=None,
                kv_caches=None, cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, remat=False, with_aux=False):
        """Returns (logits, hidden post final norm, caches or None), and
        with `with_aux` a fourth item: the experts the MoE layers chose,
        (B, L, MoE layers, k) int16 (the decoder has no auxiliary loss).
        The caches: one (B, Lmax, latent) tensor a layer, written in
        place."""
        if dropout_seed is not None or (remat and torch.is_grad_enabled()):
            raise ValueError("the deepseek_v3 decoder serves only")
        x = inputs_embeds.to(self.embed_tokens.weight.dtype)
        cis = self.rope_cis(positions)
        chosen = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            x, idx = layer(x, cis, segment_ids, cache, cache_index,
                           cache_kv_segment_ids)
            if idx is not None:
                chosen.append(idx)
        hidden = self.norm(x)
        out = (self.lm_head(hidden), hidden, kv_caches)
        if not with_aux:
            return out
        return out + (torch.stack(chosen, 2).to(torch.int16),)


def model_config(preset: str, **kw):
    """LISA with this decoder (model/lisa.py reads `cfg.llama` as the
    decoder's config): `moonlight` is Moonlight-16B-A3B with the 7b
    preset's CLIP ViT-L/14 and SAM ViT-H; `tiny` the tiny decoder with
    the tiny preset's encoders. `kw` replaces ModelConfig fields."""
    from ..core.config import ModelConfig

    base = ModelConfig.preset("7b" if preset == "moonlight" else preset)
    return base.replace(llama=DeepseekV3Config.preset(preset),
                        decoder="deepseek_v3", **kw)


def init_random_(mod: nn.Module, normal_) -> bool:
    """model/lisa.init_random_'s draw for this decoder's own parameter
    modules (the router: normal(0, d^-1/2) weights, a zero bias; the
    stacked experts: normal(0, fan_in^-1/2)). False for other modules."""
    if isinstance(mod, Router):
        normal_(mod.weight, 1.0 / math.sqrt(mod.weight.shape[1]))
        mod.e_score_correction_bias.zero_()
        return True
    if isinstance(mod, DeepseekMoE):
        for p in (mod.gate_proj, mod.up_proj, mod.down_proj):
            normal_(p, 1.0 / math.sqrt(p.shape[2]))
        return True
    return False
