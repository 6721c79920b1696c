"""TwoWayTransformer: bidirectional token <-> image attention of the SAM
mask decoder (port of haff_tpu/nn/two_way_transformer.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import SamDecoderConfig
from .layers import LayerNorm, MLPBlock, QDense


class DownsampledAttention(nn.Module):
    """MHA whose internal width is embedding_dim // downsample_rate."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        d = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = QDense(embedding_dim, d)
        self.k_proj = QDense(embedding_dim, d)
        self.v_proj = QDense(embedding_dim, d)
        self.out_proj = QDense(d, embedding_dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, _, d = q.shape
        hd = d // self.num_heads
        split = lambda x: x.reshape(b, x.shape[1], self.num_heads, hd)  # noqa: E731
        q, k, v = split(q), split(k), split(v)
        logits = torch.einsum("blnd,bmnd->bnlm", (q / hd ** 0.5).float(),
                              k.float())
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bnlm,bmnd->blnd", probs, v)
        return self.out_proj(out.reshape(b, out.shape[1], d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, skip_first_layer_pe: bool):
        super().__init__()
        d, nh = cfg.prompt_embed_dim, cfg.transformer_num_heads
        rate = cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampledAttention(d, nh)
        self.norm1 = LayerNorm(d)
        self.cross_attn_token_to_image = DownsampledAttention(d, nh, rate)
        self.norm2 = LayerNorm(d)
        self.mlp = MLPBlock(d, cfg.transformer_mlp_dim, act=F.relu)
        self.norm3 = LayerNorm(d)
        self.cross_attn_image_to_token = DownsampledAttention(d, nh, rate)
        self.norm4 = LayerNorm(d)

    def forward(self, queries, keys, query_pe, key_pe):
        dt = queries.dtype
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries).to(dt)

        q, k = queries + query_pe, keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.norm2(queries).to(dt)

        queries = queries + self.mlp(queries)
        queries = self.norm3(queries).to(dt)

        q, k = queries + query_pe, keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = self.norm4(keys).to(dt)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamDecoderConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0))
            for i in range(cfg.transformer_depth))
        self.final_attn_token_to_image = DownsampledAttention(
            d, cfg.transformer_num_heads, cfg.attention_downsample_rate)
        self.norm_final_attn = LayerNorm(d)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, h, w, d), image_pe (1 or B, h, w, d),
        point_embedding (B, N, d) -> (queries (B, N, d), keys (B, h*w, d))."""
        b, h, w, d = image_embedding.shape
        dt = point_embedding.dtype
        keys = image_embedding.reshape(b, h * w, d).to(dt)
        key_pe = image_pe.reshape(-1, h * w, d).expand(b, h * w, d).to(dt)
        queries = point_embedding
        query_pe = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, query_pe, key_pe)
        q, k = queries + query_pe, keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries).to(dt), keys
