"""A residual add and the LayerNorm after it, in one kernel: the MPT
decode step's norms (nn/mpt.py `MptBlock.decode_step`).

`add_layer_norm(x, delta, weight, eps)` returns (x + delta, LayerNorm of
that sum) in x's dtype: the sum rounded as torch's add rounds it, the
norm's statistics in float32 over the rounded sum, the weight read in
its stored dtype. That is `x = x + delta; LayerNorm(x).to(x.dtype)` with
nn/layers.LayerNorm (no bias) computed once. CUDA tensors go to
csrc/add_layer_norm.cu (one launch, counted under `add_layer_norm`), CPU
tensors to `add_layer_norm_plain`; there is no fallback between the two.
With `delta` None, x is returned as it is beside its norm.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_NAME = "add_layer_norm"
_DTYPES = (torch.bfloat16, torch.float32)
D_MAX = 16384  # csrc/add_layer_norm.cu: 16 elements a thread, 1024 threads


def add_layer_norm_plain(x, delta, weight, eps: float):
    """The plain version: torch's add, then the float32 LayerNorm cast back
    to x's dtype."""
    if delta is not None:
        x = x + delta
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), None, eps)
    return x, y.to(x.dtype)


def _lib():
    fn = _build.library(_NAME).add_layer_norm
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, ctypes.c_float, i32, i32,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def add_layer_norm_kernel(x, delta, weight, eps: float):
    """Launch csrc/add_layer_norm.cu over x's rows. Forward only: raises
    when grad mode is on and an input requires grad."""
    ins = (x, weight) if delta is None else (x, delta, weight)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            f"{_NAME}: the CUDA kernel is forward-only, and an input requires "
            "grad; call it under torch.no_grad()")
    d = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"{_NAME}: x {x.dtype}, weight {weight.dtype}; need "
                        "bfloat16 or float32")
    if not 0 < d <= D_MAX:
        raise ValueError(f"{_NAME}: width {d}; need 1..{D_MAX}")
    check = _build.check_operand
    check(_NAME, "x", x, x.dtype, x.shape)
    check(_NAME, "weight", weight, weight.dtype, (d,))
    if delta is not None:
        check(_NAME, "delta", delta, x.dtype, x.shape)
    res = None if delta is None else torch.empty_like(x)
    y = torch.empty_like(x)
    ptr = _build.ptr
    err = _lib()(ptr(x), ptr(delta), ptr(weight), ptr(res), ptr(y),
                 x.numel() // d, d, float(eps), int(x.dtype == torch.bfloat16),
                 int(weight.dtype == torch.bfloat16),
                 _build.stream_handle(x.device))
    _build.LAUNCHES[_NAME] += 1
    _build.check(err, _NAME)
    return (x if res is None else res), y


def add_layer_norm(x, delta, weight, eps: float):
    """x (..., d) and delta (the same shape and dtype, or None); weight
    (d,). Returns (x + delta, its LayerNorm in x's dtype)."""
    run = add_layer_norm_kernel if x.is_cuda else add_layer_norm_plain
    return run(x, delta, weight, eps)
