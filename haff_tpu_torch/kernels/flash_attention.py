"""Flash-attention forward for the LLaMA prefill: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of haff_tpu/kernels/flash_attention.py (forward only; the backward
kernels belong to the training slice). Layout as in the JAX package:
q (B, Lq, H, D), k/v (B, Lk, H, D); segment ids (B, L) int32 with
0 = padding; an additive bias broadcastable to (B, H, Lq, Lk).

`flash_attention` takes the plain version for CPU tensors and launches
csrc/flash_prefill.cu (`flash_prefill_fwd`) for CUDA tensors; there is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_KERNEL = "flash_prefill_fwd"
_SMEM_LIMIT = 227 * 1024


def _mask(b, lq, lk, causal, q_seg, kv_seg, device):
    """(B or 1, 1, Lq, Lk) bool mask of visible keys, or None."""
    mask = None
    if causal:
        qi = torch.arange(lq, device=device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=device)[None, :]
        mask = (ki <= qi)[None, None]
    if q_seg is not None or kv_seg is not None:
        qs = q_seg if q_seg is not None else torch.ones(
            (b, lq), dtype=torch.int32, device=device)
        ks = kv_seg if kv_seg is not None else torch.ones(
            (b, lk), dtype=torch.int32, device=device)
        seg = ((qs[:, None, :, None] == ks[:, None, None, :])
               & (ks[:, None, None, :] != 0))
        mask = seg if mask is None else (mask & seg)
    return mask


def attention_plain(q, k, v, bias=None, q_segment_ids=None,
                    kv_segment_ids=None, causal=False, sm_scale=None):
    """Plain version (JAX `mha_reference` semantics) returning
    (out (B, Lq, H, D) in v's dtype, lse (B, H, Lq) float32).

    Logits and softmax in float32; fully-masked rows give out 0 and
    lse 0, as the kernel does."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        logits = logits + bias.float()
    mask = _mask(b, lq, lk, causal, q_segment_ids, kv_segment_ids, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    lse = torch.logsumexp(
        logits if mask is None else logits.masked_fill(~mask, -torch.inf),
        dim=-1)
    if mask is not None:
        row_any = mask.expand(logits.shape).any(-1)
        probs = probs * row_any[..., None]
        lse = torch.where(row_any, lse, torch.zeros_like(lse))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out, lse


def mha_reference(q, k, v, bias=None, q_segment_ids=None,
                  kv_segment_ids=None, causal=False, sm_scale=None):
    """Plain attention (JAX `mha_reference`): returns only the output."""
    return attention_plain(q, k, v, bias, q_segment_ids, kv_segment_ids,
                           causal, sm_scale)[0]


def _lib():
    lib = _build.library("flash_prefill")
    if lib.flash_prefill_fwd.argtypes is None:
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.flash_prefill_fwd.argtypes = [
            vp, vp, vp, vp, i64, i64, i64, i64, vp, vp, vp, vp,
            i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, vp]
        lib.flash_prefill_fwd.restype = ctypes.c_int
        lib.flash_prefill_fwd_smem.argtypes = [i32]
        lib.flash_prefill_fwd_smem.restype = ctypes.c_size_t
    return lib


def flash_prefill_kernel(q, k, v, bias=None, q_segment_ids=None,
                         kv_segment_ids=None, causal=False, sm_scale=None):
    """Launch csrc/flash_prefill.cu on CUDA tensors; returns (out, lse).

    q (B, Lq, H, D) and k/v (B, Lk, H, D) contiguous, one dtype
    (bfloat16 or float32), D <= 128. Segment ids int32
    (B, L); when only one side is given the other is all ones."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_prefill_kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_prefill_kernel: dtype {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; need one of bfloat16, float32")
    if (k.shape != v.shape or k.shape != (b, lk, h, d) or d > 128
            or lq < 1 or lk < 1):
        raise ValueError(f"flash_prefill_kernel: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill_kernel: q, k, v must be contiguous")
    if sm_scale is None:
        sm_scale = d ** -0.5
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).expand(
            b, h, lq, lk)
        strides = tuple(bias.stride())
    if q_segment_ids is not None or kv_segment_ids is not None:
        ones = lambda n: torch.ones((b, n), dtype=torch.int32,  # noqa: E731
                                    device=q.device)
        q_segment_ids = (ones(lq) if q_segment_ids is None else
                         q_segment_ids.to(torch.int32).contiguous())
        kv_segment_ids = (ones(lk) if kv_segment_ids is None else
                          kv_segment_ids.to(torch.int32).contiguous())
        if (q_segment_ids.shape != (b, lq) or kv_segment_ids.shape != (b, lk)
                or q_segment_ids.device != q.device
                or kv_segment_ids.device != q.device):
            raise ValueError("flash_prefill_kernel: segment ids must be "
                             "(B, Lq) and (B, Lk) on q's device")
    lib = _lib()
    if lib.flash_prefill_fwd_smem(d) > _SMEM_LIMIT:
        raise ValueError(f"flash_prefill_kernel: head dim {d} too large")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    ptr = _build.ptr
    err = lib.flash_prefill_fwd(
        ptr(q), ptr(k), ptr(v), ptr(bias), *strides, ptr(q_segment_ids),
        ptr(kv_segment_ids), ptr(out), ptr(lse), b, lq, lk, h, d,
        float(sm_scale), int(bool(causal)), int(q.dtype == torch.bfloat16),
        _build.stream_handle(q.device))
    _build.LAUNCHES[_KERNEL] += 1
    _build.check(err, _KERNEL)
    return out, lse


def flash_attention(q, k, v, bias=None, q_segment_ids=None,
                    kv_segment_ids=None, causal=False, sm_scale=None,
                    return_lse=False):
    """Flash attention (JAX `flash_attention` semantics). CPU tensors take
    the plain version, CUDA tensors the kernel. Returns out (B, Lq, H, D)
    and, with return_lse, also lse (B, H, Lq) float32."""
    if q_segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    run = flash_prefill_kernel if q.is_cuda else attention_plain
    out, lse = run(q, k, v, bias, q_segment_ids, kv_segment_ids, causal,
                   sm_scale)
    return (out, lse) if return_lse else out
