"""Shared small modules (port of haff_tpu/nn/layers.py, float path).

Spatial tensors are NHWC at module boundaries, as in the JAX package;
convolutions permute to NCHW inside. Parameters are stored in the model's
compute dtype; normalisations compute in float32 and cast back. A
trainable parameter may instead be held in float32 (flax `param_dtype`),
and its module's `compute_dtype` then names the dtype it is cast to at use
(flax `dtype`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class QDense(nn.Linear):
    """Dense layer with the JAX `QDense` float-path call: the input is cast
    to the weight's dtype, and `out_split` returns a tuple of outputs, each
    an independent product with a contiguous row block of the one weight
    (a column split of the JAX kernel), so the checkpoint layout is that of
    the fused layer. With `compute_dtype` set, input, weight and bias are
    all cast to it."""

    compute_dtype = None

    def forward(self, x, out_split=None):
        dt = self.compute_dtype or self.weight.dtype
        x, weight = x.to(dt), self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if out_split is None:
            return F.linear(x, weight, bias)
        if sum(out_split) != self.out_features:
            raise ValueError(f"out_split {out_split} != {self.out_features}")
        outs, off = [], 0
        for w in out_split:
            b = None if bias is None else bias[off:off + w]
            outs.append(F.linear(x, weight[off:off + w], b))
            off += w
        return tuple(outs)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: statistics and output in float32
    (callers cast to the compute dtype, as the JAX modules do)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


class ChannelLayerNorm(LayerNorm):
    """SAM's LayerNorm2d over the channel (last, NHWC) axis: float32
    statistics, output in the input dtype."""

    def forward(self, x):
        return super().forward(x).to(x.dtype)


def gelu(x):
    """flax `nn.gelu` (approximate=True: the tanh form)."""
    return F.gelu(x, approximate="tanh")


class MLPBlock(nn.Module):
    """Linear -> activation -> Linear (reference common.py MLPBlock)."""

    def __init__(self, dim: int, mlp_dim: int, act=gelu):
        super().__init__()
        self.lin1 = QDense(dim, mlp_dim)
        self.lin2 = QDense(mlp_dim, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class ReluMLP(nn.Module):
    """num_layers-deep MLP with ReLU between layers (reference
    mask_decoder.py MLP: hypernetworks, IoU head, taxonomy head)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            QDense(dims[i], dims[i + 1]) for i in range(num_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def conv_nhwc(conv: nn.Module, x, dtype=None):
    """Apply an NCHW torch convolution to an NHWC tensor, computing in
    `dtype` (default: the module's `compute_dtype` if set, else the
    weight's dtype)."""
    dtype = dtype or getattr(conv, "compute_dtype", None) or conv.weight.dtype
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    xc = x.to(dtype).permute(0, 3, 1, 2)
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(xc, w, b, conv.stride, conv.padding)
    else:
        y = F.conv2d(xc, w, b, conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)
