"""Shared small modules (port of haff_tpu/nn/layers.py).

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

from . import quant


class QDense(nn.Linear):
    """Dense layer with the JAX `QDense` call. Float weight: the input is
    cast to the weight's dtype, and `out_split` returns a tuple of
    outputs, each an independent product with a contiguous row block of
    the one weight (a column split of the JAX kernel), so the checkpoint
    layout is that of the fused layer. With `compute_dtype` set, input,
    weight and bias are all cast to it.

    Quantized (after `quantize_`, `nn.quant.quantize_model_` or a bridged
    quantized tree): `weight` is a buffer, int8 (out, in) with `scale`
    (out,) -> the W8A8 product `quant.int8_matmul`, or packed uint8
    (out, in/2) with `scale` (out, in/group) -> the W4A16 product
    `quant.int4_matmul`. The bias is added after, in the compute dtype
    (the float weight's dtype when the layer was quantized), and
    `out_split` slices weight, scale and bias by output row. `scale`
    stays float32 through `.to(dtype)` and `.half()`-style casts.

    With `dequant_dtype` set (inside `nn.quant.DequantizeAtUse`, the JAX
    package's external-scales family), a quantized layer launches no
    kernel: its weight rows are dequantized to `dequant_dtype` at use,
    cast to the compute dtype, and multiplied by `F.linear`; the float
    weight lives only for that product."""

    compute_dtype = None
    dequant_dtype = None
    # A row-parallel int8 layer's tensor group (parallel/sharding.py): its
    # activations are quantized with their amax over the whole input.
    amax_group = None

    @property
    def quantized(self) -> bool:
        return not self.weight.dtype.is_floating_point

    def set_quantized_(self, weight, scale):
        """Replace the float weight parameter by the buffers `weight`
        (int8 or packed uint8) and `scale` (float32)."""
        if weight.dtype not in (torch.int8, torch.uint8):
            raise TypeError(f"quantized weight dtype {weight.dtype}")
        if not self.quantized:
            if self.compute_dtype is None:
                self.compute_dtype = self.weight.dtype
            del self._parameters["weight"]
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale.float())
        return self

    @torch.no_grad()
    def quantize_(self, bits: int = 8, group: int = 64):
        """Quantize this layer's float weight in place: int8, or packed
        int4 where bits == 4 and in_features divides by `group`."""
        if bits == 4 and self.in_features % group == 0:
            q, s = quant.quantize_kernel_int4(self.weight, group)
        else:
            q, s = quant.quantize_kernel(self.weight)
        return self.set_quantized_(q, s)

    def _apply(self, fn, recurse=True):
        # A dtype cast of the module (model.to(bfloat16)) must not round
        # the float32 scales: keep their bits, follow the device only.
        scale = self._buffers.get("scale")
        super()._apply(fn, recurse)
        if scale is not None:
            moved = self._buffers["scale"]
            if moved.dtype != torch.float32:
                self._buffers["scale"] = scale.to(moved.device)
        return self

    def _dot(self, x, lo, hi):
        """x @ weight[lo:hi].T + bias[lo:hi] in the compute dtype."""
        whole = lo == 0 and hi == self.out_features
        rows = (lambda t: t) if whole else (lambda t: t[lo:hi])
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else rows(self.bias).to(dt)
        if not self.quantized:
            return F.linear(x.to(dt), rows(self.weight).to(dt), bias)
        weight, scale = rows(self.weight), rows(self.scale)
        if self.dequant_dtype is not None:
            w = quant.dequantize_weight(weight, scale, self.dequant_dtype)
            return F.linear(x.to(dt), w.to(dt), bias)
        if weight.dtype == torch.int8:
            y = quant.int8_matmul(x.to(dt), weight, scale, dtype=dt,
                                  amax_group=self.amax_group)
        else:
            y = quant.int4_matmul(x.to(dt), weight, scale,
                                  group=self.in_features // scale.shape[-1],
                                  dtype=dt)
        return y if bias is None else y + bias

    def forward(self, x, out_split=None):
        if out_split is None:
            return self._dot(x, 0, self.out_features)
        if sum(out_split) != self.out_features:
            raise ValueError(f"out_split {out_split} != {self.out_features}")
        outs, off = [], 0
        for w in out_split:
            outs.append(self._dot(x, off, off + w))
            off += w
        return tuple(outs)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: statistics and output in float32
    (callers cast to the compute dtype, as the JAX modules do); `bias`
    False is `use_bias=False` (MPT's norms)."""

    def __init__(self, dim: int, eps: float = 1e-6, bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            bias, self.eps)


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
