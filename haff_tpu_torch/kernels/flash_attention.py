"""Flash attention for the LLaMA prefill and training step: the CUDA
kernels' wrappers, their plain PyTorch versions and the autograd rule.

Port of haff_tpu/kernels/flash_attention.py. Layout as in the JAX
package: q (B, Lq, H, D), k/v (B, Lk, H, D); segment ids (B, L) int32 with
0 = padding; an additive bias broadcastable to (B, H, Lq, Lk), a constant
for the backward (JAX `_flash_bwd_rule` returns zeros for it).

`flash_attention` takes the plain versions for CPU tensors and the kernels
for CUDA tensors, with no fallback from one to the other: the forward is
csrc/flash_prefill.cu (`flash_prefill_fwd`); when grad mode is on and q, k
or v requires grad it goes through `FlashAttentionFn`, whose backward is
csrc/flash_bwd.cu (`flash_bwd_dq`, `flash_bwd_dkv`), the counterpart of
the JAX `custom_vjp`.

Each of the three kernels has two paths, chosen before the launch by
`kernel_path` from dtype, head dim, pointers and strides: warpgroup MMA
fed by TMA for bf16 operands it can address, the scalar f32-FMA code for
the rest (float32 included). A bf16 launch on the scalar path also counts
under `<kernel>/scalar` in `_build.LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_KERNEL = "flash_prefill_fwd"
_DQ, _DKV = "flash_bwd_dq", "flash_bwd_dkv"
_SMEM_LIMIT = 227 * 1024
# Kernel paths, as the C entry points number them.
SCALAR, WGMMA = 0, 1
PATH_NAMES = ("scalar", "wgmma")


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
                    kv_segment_ids=None, causal=False, sm_scale=None,
                    out_dtype=None):
    """Plain version (JAX `mha_reference` semantics) returning
    (out (B, Lq, H, D) in v's dtype, lse (B, H, Lq) float32); with
    `out_dtype=torch.float32` the product with v is taken in float32.

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
    vt = v if out_dtype is None else v.to(out_dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vt.dtype), vt)
    return out, lse


def mha_reference(q, k, v, bias=None, q_segment_ids=None,
                  kv_segment_ids=None, causal=False, sm_scale=None):
    """Plain attention (JAX `mha_reference`): returns only the output."""
    return attention_plain(q, k, v, bias, q_segment_ids, kv_segment_ids,
                           causal, sm_scale)[0]


def _bwd_scores(q, k, v, bias, q_segment_ids, kv_segment_ids, out, lse,
                do, causal, sm_scale):
    """The float32 terms both backward kernels recompute: (p, ds, q, k, dO)
    with p = where(mask, exp(s - lse), 0) and
    ds = p * (dO V^T - delta) * sm_scale, delta = rowsum(dO * O)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q_segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    if bias is not None:
        s = s + bias.float()
    mask = _mask(b, lq, lk, causal, q_segment_ids, kv_segment_ids, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)       # (B, H, Lq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds, qf, kf, dof


def attention_bwd_plain(q, k, v, bias, q_segment_ids, kv_segment_ids, out,
                        lse, do, causal=False, sm_scale=None, out_dtype=None):
    """Plain backward (JAX `_bwd_impl` equations, float32) returning
    (dq, dk, dv) in the dtypes of q, k, v (or all in `out_dtype`):

    delta = rowsum(dO * O); p = where(mask, exp(s - lse), 0);
    ds = p * (dO V^T - delta) * sm_scale; dq = ds K, dk = ds^T Q (Q
    unscaled), dv = p^T dO. Fully-masked rows (lse 0, p 0) give dq 0."""
    p, ds, qf, kf, dof = _bwd_scores(q, k, v, bias, q_segment_ids,
                                     kv_segment_ids, out, lse, do, causal,
                                     sm_scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return (dq.to(out_dtype or q.dtype), dk.to(out_dtype or k.dtype),
            dv.to(out_dtype or v.dtype))


def attention_bwd_dq_plain(q, k, v, bias, q_segment_ids, kv_segment_ids,
                           out, lse, do, causal=False, sm_scale=None):
    """The plain version of `flash_bwd_dq` alone: dq of
    `attention_bwd_plain`."""
    _, ds, _, kf, _ = _bwd_scores(q, k, v, bias, q_segment_ids,
                                  kv_segment_ids, out, lse, do, causal,
                                  sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def attention_bwd_dkv_plain(q, k, v, bias, q_segment_ids, kv_segment_ids,
                            out, lse, do, causal=False, sm_scale=None):
    """The plain version of `flash_bwd_dkv` alone: (dk, dv) of
    `attention_bwd_plain`."""
    p, ds, qf, _, dof = _bwd_scores(q, k, v, bias, q_segment_ids,
                                    kv_segment_ids, out, lse, do, causal,
                                    sm_scale)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype))


def _lib(name):
    lib = _build.library(name)
    vp, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    if name == "flash_prefill" and lib.flash_prefill_fwd.argtypes is None:
        lib.flash_prefill_fwd.argtypes = [
            vp, vp, vp, vp, i64, i64, i64, i64, vp, vp, vp, vp,
            i32, i32, i32, i32, i32, f32, i32, i32, i32, i32, vp]
        lib.flash_prefill_fwd.restype = i32
        lib.flash_prefill_fwd_smem.argtypes = [i32, i32]
        lib.flash_prefill_fwd_smem.restype = ctypes.c_size_t
    if name == "flash_bwd" and lib.flash_bwd_dq.argtypes is None:
        head = [vp, vp, vp, vp, i64, i64, i64, i64, vp, vp, vp, vp, vp]
        tail = [i32, i32, i32, i32, i32, f32, i32, i32, i32, i32, vp]
        lib.flash_bwd_dq.argtypes = head + [vp] + tail
        lib.flash_bwd_dkv.argtypes = head + [vp, vp] + tail
        for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = i32
        lib.flash_bwd_dq_smem.argtypes = [i32, i32]
        lib.flash_bwd_dkv_smem.argtypes = [i32, i32]
        for fn in (lib.flash_bwd_dq_smem, lib.flash_bwd_dkv_smem):
            fn.restype = ctypes.c_size_t
    return lib


def _tensor_core_ok(*ts) -> bool:
    """Whether the warpgroup-MMA paths can read these (B, L, H, D)
    operands through TMA: bf16, D % 16 == 0 and D <= 128, every base
    16-byte aligned, the last stride 1 and every other stride of a dim
    longer than 1 a multiple of 8 elements (16 bytes). Pure: dtype,
    shape, pointers and strides only, on any device."""
    d = ts[0].shape[-1]
    if d % 16 or d > 128:
        return False
    return all(t.dtype == torch.bfloat16 and t.shape[-1] == d
               and t.data_ptr() % 16 == 0 and t.stride(-1) == 1
               and all(st % 8 == 0 for n, st in zip(t.shape[:-1], t.stride())
                       if n > 1)
               for t in ts)


def kernel_path(*operands) -> int:
    """The path of a forward (q, k, v) or backward dq or dk/dv (q, k, v,
    dO) launch: WGMMA where `_tensor_core_ok`, else SCALAR. Pure, like
    `_tensor_core_ok`."""
    return WGMMA if _tensor_core_ok(*operands) else SCALAR


def _operands(name, q, k, v, bias, q_segment_ids, kv_segment_ids):
    """Check the operands every flash kernel takes and bring the optional
    ones to the kernels' form: returns (bias f32 or None, its four
    strides, q segment ids, kv segment ids), the ids int32 contiguous or
    both None (when only one side is given the other is all ones)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: dtype {q.dtype}/{k.dtype}/{v.dtype}; need "
                        "one of bfloat16, float32")
    if (k.shape != v.shape or k.shape != (b, lk, h, d) or d > 128
            or lq < 1 or lk < 1):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
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
            raise ValueError(f"{name}: segment ids must be (B, Lq) and "
                             "(B, Lk) on q's device")
    return bias, strides, q_segment_ids, kv_segment_ids


def flash_prefill_kernel(q, k, v, bias=None, q_segment_ids=None,
                         kv_segment_ids=None, causal=False, sm_scale=None,
                         out_dtype=None):
    """Launch csrc/flash_prefill.cu on CUDA tensors; returns (out, lse).

    q (B, Lq, H, D) and k/v (B, Lk, H, D) contiguous, one dtype
    (bfloat16 or float32), D <= 128. Segment ids int32
    (B, L); when only one side is given the other is all ones. out is like
    q, or float32 with `out_dtype=torch.float32` (unrounded: the partials
    ring attention merges)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    bias, strides, q_segment_ids, kv_segment_ids = _operands(
        _KERNEL, q, k, v, bias, q_segment_ids, kv_segment_ids)
    if sm_scale is None:
        sm_scale = d ** -0.5
    lib = _lib("flash_prefill")
    path = kernel_path(q, k, v)
    if lib.flash_prefill_fwd_smem(d, path) > _SMEM_LIMIT:
        raise ValueError(f"flash_prefill_kernel: head dim {d} too large")
    out = torch.empty_like(q, dtype=_out_dtype(q, out_dtype))
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    ptr = _build.ptr
    err = lib.flash_prefill_fwd(
        ptr(q), ptr(k), ptr(v), ptr(bias), *strides, ptr(q_segment_ids),
        ptr(kv_segment_ids), ptr(out), ptr(lse), b, lq, lk, h, d,
        float(sm_scale), int(bool(causal)), int(q.dtype == torch.bfloat16),
        path, int(out.dtype == torch.float32),
        _build.stream_handle(q.device))
    _build.count(_KERNEL, q, path)
    _build.check(err, _KERNEL)
    return out, lse


def _bwd_operands(q, k, v, bias, q_segment_ids, kv_segment_ids, out, lse,
                  do, sm_scale):
    """Check the backward operands (those of `_operands`, then dO
    contiguous like q and lse (B, H, Lq) float32) and bring them to the
    form both kernels of csrc/flash_bwd.cu take, as the tuple
    `_bwd_launch` reads. delta = rowsum(dO * O) is one torch reduction here, as JAX computes it
    in XLA outside its kernels."""
    b, lq, h, d = q.shape
    name = "flash_bwd"
    bias, strides, qs, ks = _operands(name, q, k, v, bias, q_segment_ids,
                                      kv_segment_ids)
    if (do.shape != q.shape or out.shape != q.shape or do.dtype != q.dtype
            or do.device != q.device or not do.is_contiguous()):
        raise ValueError(f"{name}: dO {tuple(do.shape)} {do.dtype} and out "
                         f"{tuple(out.shape)} must match q, dO contiguous")
    if (lse.shape != (b, h, lq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"{name}: lse must be (B, H, Lq) float32 on q's "
                         "device")
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    if sm_scale is None:
        sm_scale = d ** -0.5
    return (q, k, v, bias, strides, qs, ks, do, lse.contiguous(), delta,
            float(sm_scale))


def _out_dtype(like, out_dtype):
    """The kernels' output dtype: like the operands, or float32."""
    if out_dtype in (None, like.dtype, torch.float32):
        return like.dtype if out_dtype is None else out_dtype
    raise TypeError(f"flash attention: out_dtype {out_dtype}; the kernels "
                    f"write {like.dtype} or torch.float32")


def _bwd_launch(name, operands, causal, outputs):
    """Launch kernel `name` of csrc/flash_bwd.cu on `_bwd_operands`'s
    result, writing `outputs` (in q's dtype, or float32), on
    `kernel_path(q, k, v, dO)`."""
    q, k, v, bias, strides, qs, ks, do, lse, delta, sm_scale = operands
    b, lq, h, d = q.shape
    lib = _lib("flash_bwd")
    path = kernel_path(q, k, v, do)
    if getattr(lib, name + "_smem")(d, path) > _SMEM_LIMIT:
        raise ValueError(f"{name}: head dim {d} too large")
    ptr = _build.ptr
    err = getattr(lib, name)(
        ptr(q), ptr(k), ptr(v), ptr(bias), *strides, ptr(qs), ptr(ks),
        ptr(do), ptr(lse), ptr(delta), *(ptr(t) for t in outputs), b, lq,
        k.shape[1], h, d, sm_scale, int(bool(causal)),
        int(q.dtype == torch.bfloat16), path,
        int(outputs[0].dtype == torch.float32), _build.stream_handle(q.device))
    _build.count(name, q, path)
    _build.check(err, name)


def flash_bwd_dq_kernel(q, k, v, bias, q_segment_ids, kv_segment_ids, out,
                        lse, do, causal=False, sm_scale=None, out_dtype=None):
    """Launch `flash_bwd_dq` of csrc/flash_bwd.cu on CUDA tensors: dq like
    q (or in `out_dtype`, torch.float32: the unrounded accumulators), from
    the forward's operands, its out and lse, and dO (like q)."""
    ops = _bwd_operands(q, k, v, bias, q_segment_ids, kv_segment_ids, out,
                        lse, do, sm_scale)
    dq = torch.empty_like(q, dtype=_out_dtype(q, out_dtype))
    _bwd_launch(_DQ, ops, causal, (dq,))
    return dq


def flash_bwd_dkv_kernel(q, k, v, bias, q_segment_ids, kv_segment_ids, out,
                         lse, do, causal=False, sm_scale=None, out_dtype=None):
    """Launch `flash_bwd_dkv` of csrc/flash_bwd.cu on CUDA tensors:
    (dk like k, dv like v), or both in `out_dtype` (torch.float32)."""
    ops = _bwd_operands(q, k, v, bias, q_segment_ids, kv_segment_ids, out,
                        lse, do, sm_scale)
    dt = _out_dtype(k, out_dtype)
    dk, dv = torch.empty_like(k, dtype=dt), torch.empty_like(v, dtype=dt)
    _bwd_launch(_DKV, ops, causal, (dk, dv))
    return dk, dv


def flash_bwd_kernel(q, k, v, bias, q_segment_ids, kv_segment_ids, out, lse,
                     do, causal=False, sm_scale=None, out_dtype=None):
    """Both backward kernels on one check of the operands and one delta:
    (dq, dk, dv), as `attention_bwd_plain` (`out_dtype` as there)."""
    ops = _bwd_operands(q, k, v, bias, q_segment_ids, kv_segment_ids, out,
                        lse, do, sm_scale)
    dt = _out_dtype(q, out_dtype)
    dq, dk, dv = (torch.empty_like(t, dtype=dt) for t in (q, k, v))
    _bwd_launch(_DQ, ops, causal, (dq,))
    _bwd_launch(_DKV, ops, causal, (dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward (JAX `_flash_attention`
    custom_vjp): the forward saves `_flash_fwd_rule`'s residuals (q, k, v,
    bias, segment ids, out, lse); the backward runs the two kernels for
    CUDA tensors and `attention_bwd_plain` for CPU tensors. The bias and
    the segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_segment_ids, kv_segment_ids, causal,
                sm_scale):
        run = flash_prefill_kernel if q.is_cuda else attention_plain
        out, lse = run(q, k, v, bias, q_segment_ids, kv_segment_ids, causal,
                       sm_scale)
        ctx.save_for_backward(q, k, v, bias, q_segment_ids, kv_segment_ids,
                              out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, q_seg, kv_seg, out, lse = ctx.saved_tensors
        run = flash_bwd_kernel if q.is_cuda else attention_bwd_plain
        dq, dk, dv = run(q, k, v, bias, q_seg, kv_seg, out, lse,
                         dout.contiguous(), ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, bias=None, q_segment_ids=None,
                    kv_segment_ids=None, causal=False, sm_scale=None,
                    return_lse=False):
    """Flash attention (JAX `flash_attention` semantics). CPU tensors take
    the plain versions, CUDA tensors the kernels; differentiable in q, k,
    v. Returns out (B, Lq, H, D) and, with return_lse, also lse (B, H, Lq)
    float32."""
    if q_segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    args = (q, k, v, bias, q_segment_ids, kv_segment_ids, causal, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttentionFn.apply(*args)
    else:
        run = flash_prefill_kernel if q.is_cuda else attention_plain
        out, lse = run(*args)
    return (out, lse) if return_lse else out
