"""MPT decoder backend (port of haff_tpu/nn/mpt.py): the reference's
llava_mpt.py language model, MPT-7B's architecture.

No positional embedding (ALiBi), a fused `Wqkv` projection, optional
multi-query attention, bias-free float32 LayerNorms, an exact-erf GELU
MLP with expansion 4, and the LM head tied to `wte`. Same
(logits, hidden, caches) interface as nn/llama.py, so infer/generate.py
drives either backend; the positions are accepted and ignored.

ALiBi: bias[h, i, j] = -slope_h * (i - j) is slope_h * j plus a per-row
constant that softmax cancels, so the (1, nh, 1, Lk) column bias is
exact. The prefill hands it to the flash-prefill kernel
(kernels/flash_attention.py) as its bias operand, read through strides;
a one-token decode step gives the decode kernel the per-head slopes
(kernels/decode_attention.py), which adds slope_h * j to slot j's score.
`attn_impl="torch"` and prefix-LM (a full (B, nh, L, L) bias) take the
plain `mha_reference`, as in the JAX package.

The fused decode step (`fused_decode_step`: CUDA tensors, one token, a
float32 or bf16 tensor cache, no qk_ln or clip_qkv): each residual add
and the LayerNorm after it are one kernel (kernels/add_layer_norm.py;
MptForCausalLM carries each sub-block's output to the next norm, so a
step has 2 a block and the final norm), and the attention writes the new
k/v, attends and merges in one launch from the Wqkv output
(kernels/decode_attention.decode_write_attention). The same functions
as the unfused path, chosen from the inputs alone; the CPU, the prefill,
training and an int8 cache keep the unfused path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.add_layer_norm import add_layer_norm
from ..kernels.decode_attention import (alibi_columns, decode_write_attention,
                                        flash_decode_attention)
from ..kernels.flash_attention import flash_attention, mha_reference
from .layers import LayerNorm, QDense
from .llama import Embed, write_kv_cache
from .quant import QuantArray


@dataclass(frozen=True)
class MptConfig:
    vocab_size: int = 50432
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    multiquery: bool = False
    alibi_bias_max: int = 8
    layer_norm_eps: float = 1e-5
    # Reference mpt/attention.py attn_config knobs:
    clip_qkv: Optional[float] = None   # clamp the fused qkv to [-c, c]
    qk_ln: bool = False                # LayerNorm on q and k after the split
    # Prefix-LM (reference modeling_mpt.py): queries attend causally plus
    # bidirectionally into the prefix region.
    prefix_lm: bool = False
    # "torch" forces the plain attention (the reference's
    # scaled_multihead_dot_product_attention); "flash" the kernel. Same
    # math: a parity and debugging knob.
    attn_impl: str = "flash"

    @staticmethod
    def preset(name: str) -> "MptConfig":
        if name == "7b":
            return MptConfig()
        if name == "tiny":
            return MptConfig(vocab_size=512, d_model=64, n_heads=4,
                             n_layers=2, max_seq_len=128)
        raise ValueError(name)

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def alibi_slopes(n_heads: int, alibi_bias_max: int = 8,
                 device=None) -> torch.Tensor:
    """MPT's slope schedule (reference mpt/attention.py gen_slopes), (nh,)
    float32: 1 / 2^m over a geometric ladder of the next power of two's
    length, interleaved (odd entries, then even) and truncated when
    n_heads is not a power of two."""
    ceil_p2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, ceil_p2 + 1, dtype=torch.float32, device=device)
    m = m * (alibi_bias_max / ceil_p2)
    slopes = 1.0 / torch.pow(2.0, m)
    if ceil_p2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes


def alibi_column_bias(n_heads: int, k_len: int, alibi_bias_max: int = 8,
                      device=None, slopes=None) -> torch.Tensor:
    """(1, nh, 1, k_len) float32 ALiBi bias, exact under softmax: slope_h
    times the key's index. `slopes` skips recomputing the schedule."""
    if slopes is None:
        slopes = alibi_slopes(n_heads, alibi_bias_max, device)
    return alibi_columns(slopes, k_len, slopes.device)[None, :, None, :]


def fused_decode_step(cfg: MptConfig, x, kv_cache, cache_index,
                      cache_kv_segment_ids) -> bool:
    """Whether a call takes the fused decode step: x (B, L, d) on CUDA
    with L == 1, a cache pair of float32 or bf16 tensors, the cache index
    and live-slot mask given, and neither qk_ln nor clip_qkv (both act
    between the projection and the attention)."""
    return (x.is_cuda and x.shape[1] == 1 and kv_cache is not None
            and cache_index is not None and cache_kv_segment_ids is not None
            and not isinstance(kv_cache[0], QuantArray)
            and not cfg.qk_ln and not cfg.clip_qkv)


class MptAttention(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        self.cfg = cfg
        nkv = 1 if cfg.multiquery else cfg.n_heads
        self.Wqkv = QDense(cfg.d_model, cfg.d_model + 2 * nkv * cfg.head_dim,
                           bias=False)
        if cfg.qk_ln:
            # Over the full projected widths before the head split, in
            # float32 like the block norms (flax defaults: with a bias).
            self.q_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps)
            self.k_ln = LayerNorm(nkv * cfg.head_dim, cfg.layer_norm_eps)
        self.out_proj = QDense(cfg.d_model, cfg.d_model, bias=False)

    def forward(self, x, slopes, segment_ids=None, kv_cache=None,
                cache_index=None, cache_kv_segment_ids=None,
                prefix_mask=None):
        """x (B, L, d_model); `slopes` (nh,) float32 on x's device.
        Prefill (no cache_kv_segment_ids): causal attention over the L
        inputs with the column bias, and, given a cache, their k/v written
        in place at per-row offsets `cache_index`. One-token decode (L ==
        1, cache and cache_kv_segment_ids given, the mask including the
        slot just written): the decode kernel with the slopes over the
        live slots; with `fused_decode_step`, one launch writes the cache
        and attends. Returns (out, kv_cache)."""
        cfg = self.cfg
        b, l, _ = x.shape
        nh, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
        nkv = 1 if cfg.multiquery else nh
        fused = self.Wqkv(x)
        if fused_decode_step(cfg, x, kv_cache, cache_index,
                             cache_kv_segment_ids):
            out = decode_write_attention(fused.reshape(b, -1), *kv_cache,
                                         cache_kv_segment_ids, cache_index, nh,
                                         slopes=slopes)
            return self.out_proj(out.reshape(b, l, d)), kv_cache
        if cfg.clip_qkv:
            fused = fused.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q = fused[..., :d]
        k = fused[..., d:d + nkv * hd]
        v = fused[..., d + nkv * hd:]
        if cfg.qk_ln:
            q = self.q_ln(q).to(fused.dtype)
            k = self.k_ln(k).to(fused.dtype)
        q = q.reshape(b, l, nh, hd)
        k = k.reshape(b, l, nkv, hd)
        v = v.reshape(b, l, nkv, hd)

        if kv_cache is not None:  # the LLaMA backend's cache, int8 or not
            ck, cv = write_kv_cache(kv_cache, k, v, cache_index)

        if kv_cache is not None and cache_kv_segment_ids is not None and l == 1:
            out = flash_decode_attention(q[:, 0].contiguous(), ck, cv,
                                         cache_kv_segment_ids,
                                         slopes=slopes)[:, None]
        else:
            if nkv != nh:
                k = k.repeat_interleave(nh // nkv, dim=2)
                v = v.repeat_interleave(nh // nkv, dim=2)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            bias = alibi_column_bias(nh, l, slopes=slopes)
            if cfg.prefix_lm and prefix_mask is not None:
                # Query i sees key j when j <= i or j lies in the prefix
                # (reference modeling_mpt.py _apply_prefix_mask).
                ii = torch.arange(l, device=x.device)[:, None]
                jj = torch.arange(l, device=x.device)[None, :]
                allowed = (jj <= ii)[None] | prefix_mask.bool()[:, None, :]
                full = bias + torch.where(allowed[:, None], 0.0, -1e9)
                out = mha_reference(q, k, v, bias=full,
                                    q_segment_ids=segment_ids,
                                    kv_segment_ids=segment_ids, causal=False)
            elif cfg.attn_impl == "torch":
                out = mha_reference(q, k, v, bias=bias,
                                    q_segment_ids=segment_ids,
                                    kv_segment_ids=segment_ids, causal=True)
            else:
                out = flash_attention(q, k, v, bias=bias,
                                      q_segment_ids=segment_ids,
                                      kv_segment_ids=segment_ids, causal=True)
        return self.out_proj(out.reshape(b, l, d)), kv_cache


class MptBlock(nn.Module):
    def __init__(self, cfg: MptConfig):
        super().__init__()
        d = cfg.d_model
        self.norm_1 = LayerNorm(d, cfg.layer_norm_eps, bias=False)
        self.attn = MptAttention(cfg)
        self.norm_2 = LayerNorm(d, cfg.layer_norm_eps, bias=False)
        self.up_proj = QDense(d, cfg.expansion_ratio * d, bias=False)
        self.down_proj = QDense(cfg.expansion_ratio * d, d, bias=False)

    def forward(self, x, slopes, segment_ids=None, kv_cache=None,
                cache_index=None, cache_kv_segment_ids=None,
                prefix_mask=None):
        attn, kv_cache = self.attn(
            self.norm_1(x).to(x.dtype), slopes, segment_ids, kv_cache,
            cache_index, cache_kv_segment_ids, prefix_mask)
        x = x + attn
        # Exact (erf) GELU: the reference MPT MLP's nn.GELU(approximate=
        # "none"), not the tanh form.
        h = F.gelu(self.up_proj(self.norm_2(x).to(x.dtype)))
        return x + self.down_proj(h), kv_cache

    def decode_step(self, x, delta, slopes, kv_cache, cache_index,
                    cache_kv_segment_ids):
        """forward's fused decode step with the residual add deferred:
        takes the previous block's MLP output `delta` (None for the first
        block) and returns (x, this block's MLP output), so that each add
        runs in the kernel of the norm after it."""
        x, h = add_layer_norm(x, delta, self.norm_1.weight, self.norm_1.eps)
        attn, _ = self.attn(h, slopes, None, kv_cache, cache_index,
                            cache_kv_segment_ids)
        x, h = add_layer_norm(x, attn, self.norm_2.weight, self.norm_2.eps)
        return x, self.down_proj(F.gelu(self.up_proj(h)))


class MptForCausalLM(nn.Module):
    """MPT with the word embedding tied as the LM head (reference
    mpt/modeling_mpt.py MPTForCausalLM)."""

    def __init__(self, cfg: MptConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(MptBlock(cfg) for _ in range(cfg.n_layers))
        self.norm_f = LayerNorm(cfg.d_model, cfg.layer_norm_eps, bias=False)
        self._slopes = {}  # device -> (nh,) float32 slopes

    def slopes(self, device) -> torch.Tensor:
        """The ALiBi slopes on `device`, computed once a device (outside
        any CUDA-graph capture: the first prefill makes them)."""
        device = torch.device(device)
        if device not in self._slopes:
            self._slopes[device] = alibi_slopes(
                self.cfg.n_heads, self.cfg.alibi_bias_max, device)
        return self._slopes[device]

    def embed(self, input_ids):
        return self.wte(input_ids.long())

    def forward(self, inputs_embeds, positions=None, segment_ids=None,
                kv_caches=None, cache_index=None, cache_kv_segment_ids=None,
                prefix_mask=None, dropout_seed=None, remat=False,
                with_aux=False):
        """Returns (logits, hidden post final norm, kv caches or None),
        and with `with_aux` a fourth item, None (MPT has no MoE layers).
        `positions` are accepted and ignored (ALiBi), as is
        `dropout_seed` (MPT has no dropout): the LLaMA interface, so
        generate.py and model/lisa.py call either backend.
        `prefix_mask` (B, L) marks bidirectional prefix positions under
        cfg.prefix_lm; `remat` (with grad mode on) recomputes each block
        in the backward, where one is taken: with no trainable parameter
        in the decoder and no gradient into its input (the JAX trainable
        set: MPT has no LoRA, a tied `wte`, no `lm_head`), autograd
        records nothing here and nothing is recomputed."""
        dtype = self.norm_f.weight.dtype
        x = inputs_embeds.to(dtype)
        slopes = self.slopes(x.device)
        if kv_caches is not None and fused_decode_step(
                self.cfg, x, kv_caches[0], cache_index, cache_kv_segment_ids):
            delta = None
            for block, cache in zip(self.blocks, kv_caches):
                x, delta = block.decode_step(x, delta, slopes, cache,
                                             cache_index, cache_kv_segment_ids)
            _, x = add_layer_norm(x, delta, self.norm_f.weight,
                                  self.norm_f.eps)
            new_caches = list(kv_caches)
        else:
            x, new_caches = self._blocks(x, slopes, segment_ids, kv_caches,
                                         cache_index, cache_kv_segment_ids,
                                         prefix_mask, remat)
            x = self.norm_f(x).to(dtype)
        logits = F.linear(x, self.wte.weight.to(dtype))  # the tied head
        out = (logits, x, (new_caches if kv_caches is not None else None))
        return out + (None,) if with_aux else out

    def _blocks(self, x, slopes, segment_ids, kv_caches, cache_index,
                cache_kv_segment_ids, prefix_mask, remat):
        """The unfused blocks: (x before the final norm, the caches)."""
        remat = remat and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        new_caches = []
        for i, block in enumerate(self.blocks):
            cache = kv_caches[i] if kv_caches is not None else None
            args = (x, slopes, segment_ids, cache, cache_index,
                    cache_kv_segment_ids, prefix_mask)
            if remat:
                x, cache = checkpoint(block, *args, use_reentrant=False)
            else:
                x, cache = block(*args)
            new_caches.append(cache)
        return x, new_caches

    def init_kv_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                       device=None):
        """Zeroed (B, max_len, nkv, hd) k/v caches, one pair a block."""
        nkv = 1 if self.cfg.multiquery else self.cfg.n_heads
        shape = (batch, max_len, nkv, self.cfg.head_dim)
        device = self.norm_f.weight.device if device is None else device
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(self.cfg.n_layers)]
