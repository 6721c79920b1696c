"""SAM ViT attention with the decomposed relative-position bias: the two
CUDA kernels' wrappers and their plain PyTorch versions.

Port of haff_tpu/kernels/sam_attention.py for the two kernels on the
evaluate() path:

* `sam_window_attention_qkv_split` -> csrc/sam_window_attn.cu
  (`sam_window_relpos_attn`), replacing `_window_qkv_kernel_db_iband`;
* `sam_global_attention_qkv` -> csrc/sam_global_attn.cu
  (`sam_global_relpos_attn`), replacing `_global_qkv_kernel`.

The public functions take the JAX entry points' arguments. The TPU-only
artefacts (196 -> 200 tile-pad rows, the -1e30 lane poison, the
head-half grid) are not part of the port: L is the window area. CPU
tensors take the plain version (decomposed bias + softmax attention in
float32, JAX `_window_xla` semantics); CUDA tensors launch the kernel,
with no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import mha_reference

_WINDOW = "sam_window_relpos_attn"
_GLOBAL = "sam_global_relpos_attn"
_SMEM_LIMIT = 227 * 1024


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """Relative positional embeddings for a q/k pair: (q_size, k_size, d)
    (reference image_encoder.py get_rel_pos). Every preset stores tables
    of the exact length, so no interpolation is done."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        raise ValueError(f"rel_pos has {rel_pos.shape[0]} rows, need "
                         f"{max_rel_dist} for sizes {q_size}, {k_size}")
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    idx = torch.as_tensor(relative.astype(np.int64), device=rel_pos.device)
    return rel_pos[idx]


def decomposed_rel_pos_bias(q, rel_pos_h, rel_pos_w, q_hw: Tuple[int, int],
                            k_hw: Tuple[int, int]):
    """q (B, qh*qw, nh, d) -> (B, nh, qh*qw, kh*kw) float32 bias
    (reference image_encoder.py add_decomposed_rel_pos)."""
    q_h, q_w = q_hw
    k_h, k_w = k_hw
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).float()
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).float()
    b, _, nh, _ = q.shape
    r_q = q.reshape(b, q_h, q_w, nh, -1).float()
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", r_q, Rh)
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", r_q, Rw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(b, nh, q_h * q_w, k_h * k_w)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def window_attention_plain(q3, kv3, rel_h, rel_w, hw, num_heads, sm_scale):
    """q3 (BW, L, C), kv3 (BW, L, 2C) with L = hw[0]*hw[1] -> (BW, L, C)."""
    bw, l, c = q3.shape
    d = c // num_heads
    q = q3.reshape(bw, l, num_heads, d)
    kv = kv3.reshape(bw, l, 2, num_heads, d)
    bias = decomposed_rel_pos_bias(q, rel_h, rel_w, hw, hw)
    out = mha_reference(q, kv[:, :, 0], kv[:, :, 1], bias=bias,
                        sm_scale=sm_scale)
    return out.reshape(bw, l, c)


def global_attention_plain(qkv, rel_h, rel_w, hw, num_heads, sm_scale):
    """qkv (B, L, 3C) with L = hw[0]*hw[1] -> (B, L, C)."""
    b, l, f = qkv.shape
    c = f // 3
    qkv5 = qkv.reshape(b, l, 3, num_heads, c // num_heads)
    q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
    bias = decomposed_rel_pos_bias(q, rel_h, rel_w, hw, hw)
    return mha_reference(q, k, v, bias=bias, sm_scale=sm_scale).reshape(b, l, c)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name):
    lib = _build.library(name)
    fn = getattr(lib, _WINDOW if name == "sam_window_attn" else _GLOBAL)
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "sam_window_attn":
            fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                           ctypes.c_float, i32, vp]
        else:
            fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                           ctypes.c_float, i32, vp]
        fn.restype = ctypes.c_int
        smem = getattr(lib, fn.__name__ + "_smem")
        smem.argtypes = [i32, i32, i32]
        smem.restype = ctypes.c_size_t
    return lib


def _forward_only(name, *tensors):
    """The SAM kernels have no backward here (the JAX package's do: a slice
    that trains the SAM encoder ports them). Raise rather than return an
    output without a grad_fn, which would drop the gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only, and an input requires "
            "grad; run the frozen SAM encoder under torch.no_grad()")


def _check_operand(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: operands must be CUDA tensors")
    if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}; need bfloat16 or float32, "
                        "one for all operands")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")


def _check_rel(t, rows, d):
    if tuple(t.shape) != (rows, d):
        raise ValueError(f"rel-pos table {tuple(t.shape)}, expected "
                         f"{(rows, d)}")


def window_attention_kernel(q3, kv3, rel_h, rel_w, hw, num_heads, sm_scale):
    """Launch csrc/sam_window_attn.cu: q3 (BW, L, C), kv3 (BW, L, 2C).
    Forward only: raises when grad mode is on and an input requires grad."""
    _forward_only(_WINDOW, q3, kv3, rel_h, rel_w)
    wh, ww = hw
    bw, l, c = q3.shape
    d = c // num_heads
    if l != wh * ww or c != d * num_heads or d > 128:
        raise ValueError(f"{_WINDOW}: q3 {tuple(q3.shape)} does not match "
                         f"window {hw} with {num_heads} heads")
    _check_operand(_WINDOW, q3, q3.dtype, (bw, l, c))
    _check_operand(_WINDOW, kv3, q3.dtype, (bw, l, 2 * c))
    if kv3.device != q3.device:
        raise ValueError(f"{_WINDOW}: q3 and kv3 on different devices")
    _check_rel(rel_h, 2 * wh - 1, d)
    _check_rel(rel_w, 2 * ww - 1, d)
    rh, rw = (t.to(device=q3.device, dtype=torch.float32).contiguous()
              for t in (rel_h, rel_w))
    lib = _lib("sam_window_attn")
    if lib.sam_window_relpos_attn_smem(wh, ww, d) > _SMEM_LIMIT:
        raise ValueError(f"{_WINDOW}: window {hw} x head dim {d} exceeds "
                         "one block's shared memory")
    out = torch.empty_like(q3)
    if bw:
        ptr = _build.ptr
        err = lib.sam_window_relpos_attn(
            ptr(q3), ptr(kv3), ptr(rh), ptr(rw), ptr(out), bw, wh, ww,
            num_heads, d, float(sm_scale), int(q3.dtype == torch.bfloat16),
            _build.stream_handle(q3.device))
        _build.LAUNCHES[_WINDOW] += 1
        _build.check(err, _WINDOW)
    return out


def band_tables(q, rel_h, rel_w, hw):
    """Band tables of the global kernel, float32: q (B, L, nh, d) ->
    Bh (B, L, nh, H) = q . Rh[row], Bw (B, L, nh, W) = q . Rw[col]
    (JAX `_natural_band_tables`, without the key padding)."""
    H, W = hw
    b, l, nh, d = q.shape
    Rh = get_rel_pos(H, H, rel_h).float()
    Rw = get_rel_pos(W, W, rel_w).float()
    r_q = q.reshape(b, H, W, nh, d).float()
    bh = torch.einsum("bhwnc,hkc->bhwnk", r_q, Rh).reshape(b, l, nh, H)
    bw = torch.einsum("bhwnc,wkc->bhwnk", r_q, Rw).reshape(b, l, nh, W)
    return bh.contiguous(), bw.contiguous()


def global_attention_kernel(qkv, rel_h, rel_w, hw, num_heads, sm_scale):
    """Launch csrc/sam_global_attn.cu on the fused qkv (B, L, 3C).
    Forward only: raises when grad mode is on and an input requires grad."""
    _forward_only(_GLOBAL, qkv, rel_h, rel_w)
    H, W = hw
    b, l, f = qkv.shape
    c = f // 3
    d = c // num_heads
    if l != H * W or f != 3 * c or c != d * num_heads or d > 128:
        raise ValueError(f"{_GLOBAL}: qkv {tuple(qkv.shape)} does not match "
                         f"grid {hw} with {num_heads} heads")
    _check_operand(_GLOBAL, qkv, qkv.dtype, (b, l, f))
    _check_rel(rel_h, 2 * H - 1, d)
    _check_rel(rel_w, 2 * W - 1, d)
    lib = _lib("sam_global_attn")
    if lib.sam_global_relpos_attn_smem(H, W, d) > _SMEM_LIMIT:
        raise ValueError(f"{_GLOBAL}: grid {hw} x head dim {d} exceeds one "
                         "block's shared memory")
    bh, bw = band_tables(qkv[..., :c].reshape(b, l, num_heads, d),
                         rel_h, rel_w, hw)
    out = torch.empty((b, l, c), dtype=qkv.dtype, device=qkv.device)
    if b:
        ptr = _build.ptr
        err = lib.sam_global_relpos_attn(
            ptr(qkv), ptr(bh), ptr(bw), ptr(out), b, H, W, num_heads, d,
            float(sm_scale), int(qkv.dtype == torch.bfloat16),
            _build.stream_handle(qkv.device))
        _build.LAUNCHES[_GLOBAL] += 1
        _build.check(err, _GLOBAL)
    return out


# ---------------------------------------------------------------------------
# Public entry points (JAX argument order)
# ---------------------------------------------------------------------------

def sam_window_attention_qkv_split(q3, kv3, rel_h, rel_w,
                                   hw: Tuple[int, int], num_heads: int,
                                   sm_scale=None):
    """Windowed SAM attention over a column-split qkv projection:
    q3 (BW, L, C), kv3 (BW, L, 2C), L = hw[0]*hw[1]. Returns (BW, L, C)."""
    if sm_scale is None:
        sm_scale = (q3.shape[-1] // num_heads) ** -0.5
    run = window_attention_kernel if q3.is_cuda else window_attention_plain
    return run(q3, kv3, rel_h, rel_w, hw, num_heads, sm_scale)


def sam_global_attention_qkv(qkv, rel_h, rel_w, hw: Tuple[int, int],
                             num_heads: int, sm_scale=None):
    """Global SAM attention over the fused qkv projection (B, L, 3C),
    L = hw[0]*hw[1]. Returns (B, L, C)."""
    if sm_scale is None:
        sm_scale = (qkv.shape[-1] // 3 // num_heads) ** -0.5
    run = global_attention_kernel if qkv.is_cuda else global_attention_plain
    return run(qkv, rel_h, rel_w, hw, num_heads, sm_scale)
