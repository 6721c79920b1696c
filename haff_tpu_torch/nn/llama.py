"""LLaMA decoder (port of haff_tpu/nn/llama.py).

RMSNorm and rotate-half RoPE in float32, causal prefill through the
flash-prefill kernel (kernels/flash_attention.py), single-token decode
over a ragged per-row KV cache, bfloat16 or int8 with per token-head
scales, through the decode-attention kernel
(kernels/decode_attention.py). The post-final-norm hidden states are
returned beside the logits: the [SEG] gather needs them.

Training mode: a `dropout_seed` turns LoRA input dropout on (each
projection's mask is seeded from it, the layer index and the projection,
so a recomputed block redraws the same masks), and `remat` recomputes
each decoder block in the backward (torch.utils.checkpoint, the
counterpart of `nn.remat(..., nothing_saveable)`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import LlamaConfig
from ..kernels.decode_attention import flash_decode_attention
from ..kernels.flash_attention import flash_attention
from .layers import QDense
from .lora import LoraDense, fold_in
from .quant import QuantArray, quantize_activation

_PROJ_IDS = {"q_proj": 0, "k_proj": 1, "v_proj": 2, "o_proj": 3}


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def rope_table(head_dim: int, max_len: int, theta: float, device=None):
    """(2, max_len, head_dim/2) float32 cos/sin table."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=0)


def apply_rope(x, positions, table):
    """x (B, L, H, D), positions (B, L) -> rotate-half RoPE in float32,
    cast back to x's dtype."""
    cos = table[0][positions][:, :, None, :]
    sin = table[1][positions][:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        e, nh, nkv, hd = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        def proj(name, n_in, n_out):
            # q/v keep the base/kernel layout even untargeted (JAX
            # LlamaAttention.proj); k/o only when targeted.
            targeted = name in cfg.lora_targets
            if targeted or name in ("q_proj", "v_proj"):
                return LoraDense(n_in, n_out, cfg.lora_rank if targeted else 0,
                                 cfg.lora_alpha, cfg.lora_dropout)
            return QDense(n_in, n_out, bias=False)

        self.q_proj = proj("q_proj", e, nh * hd)
        self.k_proj = proj("k_proj", e, nkv * hd)
        self.v_proj = proj("v_proj", e, nkv * hd)
        self.o_proj = proj("o_proj", nh * hd, e)

    def _proj(self, name, x, dropout_seed):
        layer = getattr(self, name)
        if not isinstance(layer, LoraDense):
            return layer(x)
        seed = (None if dropout_seed is None
                else fold_in(dropout_seed, _PROJ_IDS[name]))
        return layer(x, seed)

    def forward(self, x, positions, table, segment_ids=None, kv_cache=None,
                cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None):
        """Prefill (no cache_kv_segment_ids): causal flash attention over
        the L inputs, and, given a cache, their k/v written in place at
        per-row offsets `cache_index` (B,). Decode (L == 1, cache and
        cache_kv_segment_ids given; the mask includes the slot just
        written): attention over the live cache slots. A cache is a pair
        of tensors, or of QuantArrays (int8). `dropout_seed`
        (training) turns LoRA dropout on. Returns (out, kv_cache)."""
        cfg = self.cfg
        b, l, _ = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        proj = lambda name, t: self._proj(name, t, dropout_seed)  # noqa: E731
        q = apply_rope(proj("q_proj", x).reshape(b, l, nh, hd), positions,
                       table)
        k = apply_rope(proj("k_proj", x).reshape(b, l, nkv, hd), positions,
                       table)
        v = proj("v_proj", x).reshape(b, l, nkv, hd)

        if kv_cache is not None:
            ck, cv = kv_cache
            if cache_index is None:
                cache_index = torch.zeros((b,), dtype=torch.long,
                                          device=x.device)
            rows = torch.arange(b, device=x.device)[:, None]
            cols = cache_index.long()[:, None] + torch.arange(
                l, device=x.device)[None, :]
            if isinstance(ck, QuantArray):
                # int8 cache: each fresh token-head quantized over head_dim,
                # values and scales written at the same slots.
                for cache, fresh in ((ck, k), (cv, v)):
                    qa = quantize_activation(fresh)
                    cache.values[rows, cols] = qa.values
                    cache.scales[rows, cols] = qa.scales
            else:
                ck[rows, cols] = k.to(ck.dtype)
                cv[rows, cols] = v.to(cv.dtype)

        if kv_cache is not None and cache_kv_segment_ids is not None:
            if l != 1:
                raise NotImplementedError(
                    "multi-token cache attention (speculative verify) is "
                    "not ported yet")
            out = flash_decode_attention(q[:, 0].contiguous(), ck, cv,
                                         cache_kv_segment_ids)[:, None]
        else:
            if nkv != nh:
                k = k.repeat_interleave(nh // nkv, dim=2)
                v = v.repeat_interleave(nh // nkv, dim=2)
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), q_segment_ids=segment_ids,
                                  kv_segment_ids=segment_ids, causal=True)
        out = proj("o_proj", out.reshape(b, l, nh * hd))
        return out, kv_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = QDense(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = QDense(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = QDense(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, table, segment_ids=None, kv_cache=None,
                cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None):
        attn, kv_cache = self.self_attn(
            self.input_layernorm(x), positions, table, segment_ids, kv_cache,
            cache_index, cache_kv_segment_ids, dropout_seed)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), kv_cache


class LlamaModel(nn.Module):
    """Decoder stack on input embeddings (the multimodal splice happens
    upstream)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        if cfg.moe_num_experts or cfg.sequence_parallel:
            raise NotImplementedError(
                "MoE and sequence-parallel LLaMA are not ported yet")
        self.cfg = cfg
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, positions, segment_ids=None,
                kv_caches=None, cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, remat=False):
        """Returns (hidden states post final norm, kv caches or None).
        `dropout_seed`: LoRA dropout on, layer i seeded fold_in(seed, i).
        `remat` (with grad mode on): each block's activations are
        recomputed in the backward instead of stored."""
        cfg = self.cfg
        x = inputs_embeds.to(self.norm.weight.dtype)
        table = rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                           device=x.device)
        # A position past the table reads its last row, as JAX's clamped
        # gather does (a long prompt at the tiny preset's 128 positions).
        positions = positions.long().clamp(max=cfg.max_seq_len - 1)
        remat = remat and torch.is_grad_enabled()
        new_caches = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            seed = None if dropout_seed is None else fold_in(dropout_seed, i)
            args = (x, positions, table, segment_ids, cache, cache_index,
                    cache_kv_segment_ids, seed)
            if remat:
                # The dropout masks come from explicit seeds, so the global
                # RNG state need not be saved for the recompute.
                x, cache = checkpoint(layer, *args, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, cache = layer(*args)
            new_caches.append(cache)
        return self.norm(x), (new_caches if kv_caches is not None else None)


class Embed(nn.Embedding):
    """Token embedding: a row gather whose table gradient is a scatter-add
    in the table's dtype (float32 when trained, which equals the JAX
    one-hot/HIGHEST backward); the rows are cast to `compute_dtype` when it
    is set (see nn/layers.py)."""

    compute_dtype = None

    def forward(self, ids):
        out = super().forward(ids)
        return out if self.compute_dtype is None else out.to(self.compute_dtype)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size)
        self.model = LlamaModel(cfg)
        self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size, bias=False)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids.long())

    def forward(self, inputs_embeds, positions, segment_ids=None,
                kv_caches=None, cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, remat=False):
        """Returns (logits, hidden post-norm, kv caches)."""
        hidden, caches = self.model(inputs_embeds, positions, segment_ids,
                                    kv_caches, cache_index,
                                    cache_kv_segment_ids, dropout_seed, remat)
        return self.lm_head(hidden), hidden, caches
