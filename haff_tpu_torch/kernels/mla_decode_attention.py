"""One decode step of multi-head latent attention (MLA, the deepseek_v3
decoder, nn/deepseek_v3.py) over the latent cache, in its absorbed form:
`mla_decode_write_attention` -> csrc/mla_decode_attn.cu on the card,
`mla_decode_write_attention_plain` for CPU tensors, with no fallback
between the two.

Each layer's cache is one (B, Lmax, R + P) tensor: a token's normed
latent c (R values) and its roped k_pe (P). A row's nh query heads come
as (B, nh, R + P): W_UK^T q_nope, then q_pe. Head h's score of slot j is
`scale * q[b, h] . cache[b, j]` (the whole R + P width), its output
`sum_j softmax_j cache[b, j, :R]` over the live slots (mask > 0); a row
with no live slot gives 0. The new token's row `new` (B, R + P) is
written at slot cache_index[b] first (nothing where it lies outside
[0, Lmax)), in the same launch: the split that holds the slot writes it
and uses the fresh values itself. The nh heads of a row share each slot
read (four a block at Moonlight's 16). The slots are split over blocks
as `mla_plan` says (shapes only, no host sync); a second kernel of the same C entry merges the splits'
softmax states. Softmax and both products run in float32. Counted
under `mla_decode_attn/write`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

_NAME = "mla_decode_attn"
LAUNCH_KEY = _NAME + "/write"
# The kernel's limits and split (csrc/mla_decode_attn.cu): R <= R_MAX,
# R + P <= D_MAX; HEADS_A_BLOCK heads a block; at least MIN_CHUNK slots a
# split, enough splits for TARGET_BLOCKS blocks (two an SM of the H100's
# 132).
R_MAX, D_MAX, HEADS_A_BLOCK = 512, 640, 4
MIN_CHUNK, TARGET_BLOCKS = 16, 2 * 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def mla_plan(b: int, nh: int, lmax: int) -> Tuple[int, int, int]:
    """(splits, chunk, heads a block): each row's Lmax slots cut into
    `splits` runs of `chunk` (the last may be shorter), each run's heads
    into blocks of up to HEADS_A_BLOCK; from the shapes alone."""
    groups = _cdiv(nh, HEADS_A_BLOCK)
    splits = max(min(_cdiv(TARGET_BLOCKS, max(b * groups, 1)),
                     _cdiv(lmax, MIN_CHUNK)), 1)
    chunk = max(_cdiv(lmax, splits), 1)
    return _cdiv(lmax, chunk), chunk, min(nh, HEADS_A_BLOCK)


def mla_decode_write_attention_plain(q, new, cache, kv_mask, cache_index,
                                     rank: int, sm_scale: float):
    """q (B, nh, R + P); new (B, R + P); cache (B, Lmax, R + P), written
    in place at slot cache_index[b] (rounded to its dtype); kv_mask
    (B, Lmax), > 0 = live; `rank` = R. float32 softmax and products.
    Returns (B, nh, R) in q's dtype."""
    slots = torch.arange(cache.shape[1], device=cache.device)
    at = (slots[None] == cache_index.long()[:, None])[..., None]
    cache.copy_(torch.where(at, new[:, None].to(cache.dtype), cache))
    kf = cache.float()
    s = torch.einsum("bhd,bld->bhl", q.float(), kf) * sm_scale
    s = s.masked_fill(~(kv_mask > 0)[:, None, :], -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhl,blr->bhr", p, kf[..., :rank]).to(q.dtype)


def _lib():
    fn = _build.library(_NAME).mla_decode_attn_write
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def mla_decode_write_attention_kernel(q, new, cache, kv_mask, cache_index,
                                      rank: int, sm_scale: float):
    """Launch csrc/mla_decode_attn.cu (bf16 q, new and cache). Forward
    only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, new)):
        raise RuntimeError(f"{LAUNCH_KEY}: the CUDA kernel is forward-only; "
                           "decode under torch.no_grad()")
    b, nh, dq = q.shape
    lmax, dc = cache.shape[1:]
    if dq != dc or rank > R_MAX or dc > D_MAX or dc % 8 or rank % 8 \
            or rank >= dc:
        raise ValueError(f"{LAUNCH_KEY}: R={rank} R+P={dc} (q {dq}); need "
                         f"R <= {R_MAX} and R % 8 == 0, R < R+P <= {D_MAX}, "
                         "R+P % 8 == 0")
    check = _build.check_operand
    check(LAUNCH_KEY, "q", q, torch.bfloat16, (b, nh, dc))
    check(LAUNCH_KEY, "new", new, torch.bfloat16, (b, dc))
    check(LAUNCH_KEY, "cache", cache, torch.bfloat16, (b, lmax, dc))
    mask = kv_mask if kv_mask.dtype == torch.int32 else kv_mask.to(torch.int32)
    mask = mask.contiguous()
    check(LAUNCH_KEY, "kv_mask", mask, torch.int32, (b, lmax))
    index = cache_index.long().contiguous()
    check(LAUNCH_KEY, "cache_index", index, torch.int64, (b,))
    out = q.new_empty((b, nh, rank))
    if b and nh:
        splits, chunk, hpb = mla_plan(b, nh, lmax)
        part = None
        if splits > 1:
            part = torch.empty(b * nh * splits * (rank + 2),
                               dtype=torch.float32, device=q.device)
        ptr = _build.ptr
        err = _lib()(ptr(q), ptr(new), ptr(cache), ptr(mask), ptr(index),
                     ptr(out), ptr(part), b, lmax, nh, rank,
                     dc, float(sm_scale), splits, chunk, hpb,
                     _build.stream_handle(q.device))
        _build.LAUNCHES[LAUNCH_KEY] += 1
        _build.check(err, LAUNCH_KEY)
    return out


def mla_decode_write_attention(q, new, cache, kv_mask, cache_index,
                               rank: int, sm_scale: float):
    """One MLA decode step's attention (see the module docstring): q
    (B, nh, R + P), new (B, R + P), cache (B, Lmax, R + P) written in
    place, kv_mask (B, Lmax), cache_index (B,), `rank` = R. Returns
    (B, nh, R) in q's dtype: the kernel for CUDA tensors, the plain
    version otherwise."""
    run = (mla_decode_write_attention_kernel if q.is_cuda
           else mla_decode_write_attention_plain)
    return run(q, new, cache, kv_mask, cache_index, rank, sm_scale)
