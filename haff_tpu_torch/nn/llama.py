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

Meshes (parallel/sharding.py `param_shardings`): under a `tensor` axis
the q/k/v and gate/up projections are column-parallel, o/down
row-parallel and the embedding and lm_head vocab-parallel, entered and
left through parallel/collectives.py's `copy_to_tp` / `reduce_from_tp`;
with `cfg.sequence_parallel` the attention runs as ring attention over the
ambient mesh's `sp` axis (parallel/ring_attention.py), the rest of the
block on the whole sequence.

MoE: with `moe_num_experts` > 0, every `moe_every`-th block holds an MoE
MLP (nn/moe.py) named `moe` in place of `mlp`, so a dense checkpoint
never half-loads into an MoE model. It routes per row (`no_drop`) exactly
when a KV cache is passed, and masks padding (segment id 0) out of the
routing. The blocks' Switch load-balance terms are summed and returned
when the caller asks for them (`with_aux`); the flax `moe_aux`
collection's counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import LlamaConfig
from ..core.mesh import SP_AXIS, ambient_mesh
from ..kernels.decode_attention import (chunk_decode_attention,
                                        flash_decode_attention)
from ..kernels.flash_attention import flash_attention
from .layers import QDense
from .lora import LoraDense, fold_in
from .moe import MoEMLP, moe_layers
from .quant import QuantArray, quantize_activation
from ..parallel.collectives import (copy_to_tp, gather_from_shard,
                                    reduce_from_tp)

# Logical axis names of the LLaMA parameters (JAX nn/llama.py); mapped to
# mesh axes by parallel/sharding.py.
EMBED = "embed"
MLP = "mlp"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
VOCAB = "vocab"

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


def write_kv_cache(kv_cache, k, v, cache_index=None):
    """Write fresh k/v (B, L, nkv, hd) into a (k, v) cache pair in place at
    per-row offsets `cache_index` (B,) (default 0): tensors take them in
    their dtype; an int8 cache (QuantArrays) quantizes each token-head
    over head_dim and writes values and scales at the same slots. Returns
    the pair."""
    ck, cv = kv_cache
    b, l = k.shape[:2]
    if cache_index is None:
        cache_index = torch.zeros((b,), dtype=torch.long, device=k.device)
    rows = torch.arange(b, device=k.device)[:, None]
    cols = cache_index.long()[:, None] + torch.arange(
        l, device=k.device)[None, :]
    if isinstance(ck, QuantArray):
        for cache, fresh in ((ck, k), (cv, v)):
            qa = quantize_activation(fresh)
            cache.values[rows, cols] = qa.values
            cache.scales[rows, cols] = qa.scales
    else:
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
    return ck, cv


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
        # This rank's heads (all of them unless a `tensor` axis shards them)
        # and the tensor group (parallel/sharding.py sets both).
        self.num_heads, self.num_kv_heads = nh, nkv
        self.tp_group = None

    def _proj(self, name, x, dropout_seed, base_input=None):
        """Projection `name` of x. Under tensor parallelism q/k/v take
        `base_input` (x entered into the tensor-parallel region) for their
        base product and x for their LoRA A, and o_proj sums its partial
        products over the tensor group."""
        layer = getattr(self, name)
        if not isinstance(layer, LoraDense):
            y = layer(x if base_input is None else base_input)
            return reduce_from_tp(y, self.tp_group) if name == "o_proj" else y
        seed = (None if dropout_seed is None
                else fold_in(dropout_seed, _PROJ_IDS[name]))
        return layer(x, seed, base_input)

    def forward(self, x, positions, table, segment_ids=None, kv_cache=None,
                cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, q_positions=None):
        """Prefill (no cache_kv_segment_ids): causal flash attention over
        the L inputs, and, given a cache, their k/v written in place at
        per-row offsets `cache_index` (B,). Decode (cache and
        cache_kv_segment_ids given; the mask includes the slots just
        written): L == 1 attends over the live cache slots through the
        decode kernel; L > 1 is a speculative verify chunk, each token
        over the live slots up to its own position (`q_positions`: the
        positions before RoPE's table clamp; default `positions`). A cache is a pair
        of tensors, or of QuantArrays (int8). `dropout_seed`
        (training) turns LoRA dropout on. Returns (out, kv_cache)."""
        cfg = self.cfg
        b, l, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, cfg.head_dim
        xt = copy_to_tp(x, self.tp_group)
        proj = lambda name, t: self._proj(name, t, dropout_seed, xt)  # noqa: E731
        q = apply_rope(proj("q_proj", x).reshape(b, l, nh, hd), positions,
                       table)
        k = apply_rope(proj("k_proj", x).reshape(b, l, nkv, hd), positions,
                       table)
        v = proj("v_proj", x).reshape(b, l, nkv, hd)

        if kv_cache is not None:
            ck, cv = write_kv_cache(kv_cache, k, v, cache_index)

        if kv_cache is not None and cache_kv_segment_ids is not None:
            if l == 1:
                out = flash_decode_attention(q[:, 0].contiguous(), ck, cv,
                                             cache_kv_segment_ids)[:, None]
            else:  # a speculative verify chunk, each token up to itself
                out = chunk_decode_attention(
                    q, ck, cv, cache_kv_segment_ids,
                    positions if q_positions is None else q_positions)
        else:
            if nkv != nh:
                k = k.repeat_interleave(nh // nkv, dim=2)
                v = v.repeat_interleave(nh // nkv, dim=2)
            # The ring covers training (no cache) and long-context prefill
            # (cache given, L > 1): the cache write above is local either
            # way, only the attention is distributed.
            out = None
            if cfg.sequence_parallel:
                out = self._ring_attention(q, k, v, segment_ids)
            if out is None:
                out = flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(),
                                      q_segment_ids=segment_ids,
                                      kv_segment_ids=segment_ids, causal=True)
        out = self._proj("o_proj", out.reshape(b, l, nh * hd), dropout_seed)
        return out, kv_cache

    def _ring_attention(self, q, k, v, segment_ids):
        """Sequence-parallel path (cfg.sequence_parallel): ring attention
        over the ambient mesh's "sp" axis. Returns None when no sp > 1 mesh
        is ambient (the caller then runs single-device flash, as JAX does).
        Pads the sequence to an 8-aligned per-chunk multiple; padded
        positions carry segment id 0. The batch rows and heads here are
        already this rank's (the model runs on its (data, fsdp) rows, and
        the column-parallel projections give its tensor heads), which is
        the composition JAX's `batch_axes` / `heads_axis` express."""
        from ..parallel.ring_attention import sequence_sharded_attention

        mesh = ambient_mesh()
        if mesh is None or mesh.shape.get(SP_AXIS, 1) <= 1:
            import warnings

            warnings.warn(
                "sequence_parallel is set but no ambient mesh with an "
                "'sp' axis > 1 was found; falling back to single-device "
                "flash attention", stacklevel=2)
            return None
        sp = mesh.shape[SP_AXIS]
        b, l = q.shape[:2]
        seg = (segment_ids.to(torch.int32) if segment_ids is not None else
               torch.ones((b, l), dtype=torch.int32, device=q.device))
        lp = -(-l // (sp * 8)) * (sp * 8)
        if lp != l:
            pad = (0, 0, 0, 0, 0, lp - l)
            q, k, v = (F.pad(t, pad) for t in (q, k, v))
            seg = F.pad(seg, (0, lp - l))
        out = sequence_sharded_attention(mesh, SP_AXIS, q, k, v,
                                         q_segment_ids=seg, causal=True)
        return out[:, :l]


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = QDense(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = QDense(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = QDense(cfg.intermediate_size, cfg.hidden_size, bias=False)
        self.tp_group = None  # gate/up column-, down row-parallel over it

    def forward(self, x):
        xt = copy_to_tp(x, self.tp_group)
        y = self.down_proj(F.silu(self.gate_proj(xt)) * self.up_proj(xt))
        return reduce_from_tp(y, self.tp_group)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, is_moe: bool = False):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.is_moe = is_moe
        if is_moe:
            self.moe = MoEMLP(cfg)
        else:
            self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, table, segment_ids=None, kv_cache=None,
                cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, q_positions=None):
        """Returns (x, kv_cache, aux): aux is the MoE MLP's load-balance
        term, None in a dense block."""
        attn, new_cache = self.self_attn(
            self.input_layernorm(x), positions, table, segment_ids, kv_cache,
            cache_index, cache_kv_segment_ids, dropout_seed, q_positions)
        x = x + attn
        h = self.post_attention_layernorm(x)
        if not self.is_moe:
            return x + self.mlp(h), new_cache, None
        mask = None if segment_ids is None else segment_ids > 0
        out, aux = self.moe(h, mask, no_drop=kv_cache is not None)
        return x + out, new_cache, aux


class LlamaModel(nn.Module):
    """Decoder stack on input embeddings (the multimodal splice happens
    upstream)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        moe = moe_layers(cfg)
        self.layers = nn.ModuleList(LlamaBlock(cfg, i in moe)
                                    for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, positions, segment_ids=None,
                kv_caches=None, cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, remat=False):
        """Returns (hidden states post final norm, kv caches or None, the
        sum of the MoE blocks' load-balance terms or None without MoE
        blocks). `dropout_seed`: LoRA dropout on, layer i seeded
        fold_in(seed, i). `remat` (with grad mode on): each block's
        activations are recomputed in the backward instead of stored."""
        cfg = self.cfg
        x = inputs_embeds.to(self.norm.weight.dtype)
        table = rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                           device=x.device)
        # A position past the table reads its last row, as JAX's clamped
        # gather does (a long prompt at the tiny preset's 128 positions).
        positions = positions.long()
        rope_positions = positions.clamp(max=cfg.max_seq_len - 1)
        remat = remat and torch.is_grad_enabled()
        new_caches, aux = [], None
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            seed = None if dropout_seed is None else fold_in(dropout_seed, i)
            args = (x, rope_positions, table, segment_ids, cache, cache_index,
                    cache_kv_segment_ids, seed, positions)
            if remat:
                # The dropout masks come from explicit seeds, so the global
                # RNG state need not be saved for the recompute.
                x, cache, block_aux = checkpoint(
                    layer, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, cache, block_aux = layer(*args)
            new_caches.append(cache)
            if block_aux is not None:
                aux = block_aux if aux is None else aux + block_aux
        return (self.norm(x), (new_caches if kv_caches is not None else None),
                aux)


class Embed(nn.Embedding):
    """Token embedding: a row gather whose table gradient is a scatter-add
    in the table's dtype (float32 when trained, which equals the JAX
    one-hot/HIGHEST backward); the rows are cast to `compute_dtype` when it
    is set (see nn/layers.py)."""

    compute_dtype = None
    # Vocab-parallel (parallel/sharding.py): this rank holds the rows from
    # `vocab_start`; a token outside them reads zeros, and the rows are
    # summed over the tensor group.
    tp_group = None
    vocab_start = 0

    def forward(self, ids):
        if self.tp_group is None:
            out = super().forward(ids)
        else:
            local = ids - self.vocab_start
            inside = (local >= 0) & (local < self.weight.shape[0])
            out = F.embedding(torch.where(inside, local, 0), self.weight)
            out = reduce_from_tp(out * inside[..., None].to(out.dtype),
                                 self.tp_group)
        return out if self.compute_dtype is None else out.to(self.compute_dtype)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size)
        self.model = LlamaModel(cfg)
        self.lm_head = QDense(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.tp_group = None  # vocab-parallel lm_head over it

    def embed(self, input_ids):
        return self.embed_tokens(input_ids.long())

    def logits(self, hidden):
        """lm_head(hidden); vocab-parallel under a tensor group: each rank's
        vocabulary rows, all-gathered to the full (padding-trimmed)
        vocabulary."""
        if self.tp_group is None:
            return self.lm_head(hidden)
        local = self.lm_head(copy_to_tp(hidden, self.tp_group))
        full = gather_from_shard(local, self.tp_group, -1)
        return full[..., :self.cfg.vocab_size]

    def forward(self, inputs_embeds, positions, segment_ids=None,
                kv_caches=None, cache_index=None, cache_kv_segment_ids=None,
                dropout_seed=None, remat=False, with_aux=False):
        """Returns (logits, hidden post-norm, kv caches), and with
        `with_aux` a fourth item: the MoE blocks' summed load-balance
        term (None when the model has no MoE block)."""
        hidden, caches, aux = self.model(inputs_embeds, positions,
                                         segment_ids, kv_caches, cache_index,
                                         cache_kv_segment_ids, dropout_seed,
                                         remat)
        out = (self.logits(hidden), hidden, caches)
        return out + (aux,) if with_aux else out
