"""Decode attention: one token's queries over a ragged KV cache that is
float or int8 (port of haff_tpu/kernels/decode_attention.py).

`flash_decode_attention` -> csrc/decode_attn.cu (`decode_attn`),
replacing the Pallas streaming kernel `_make_kernel`. On the card every
decode step goes through the kernel, at any cache length and head
geometry with head_dim <= 128 and nh % nkv == 0; CPU tensors take
`decode_attention_plain`, with no fallback between the two. The kernel
splits each (batch row, kv head)'s slots over blocks as `decode_plan`
says (from the shapes alone, never the mask) and merges the splits'
partial softmax states in a second pass; `decode_attention_split` is
that algorithm in plain torch, for the tests.

An int8 cache is a pair of `nn.quant.QuantArray`s: int8 values
(B, Lmax, nkv, hd) with float32 scales (B, Lmax, nkv, 1), one per
token-head. Kernel and plain version dequantize as the Pallas kernel
does, int8 times the float32 scale with no rounding to the query's dtype,
and give 0 for a row with no live slot. (The JAX package's MPT decode
step, an XLA `mha_reference`, rounds the dequantized cache to the query's
dtype first: equal in float32, within the bf16 tolerance in bfloat16.)

ALiBi (the MPT decoder, nn/mpt.py): with per-head `slopes` (nh,) float32,
slot j's score gains slopes[h] * j, the column form of the bias, exact
under softmax. On the card it is a template flag of the kernel; without
slopes the kernel compiled is the one without the term.

`decode_write_attention` is the MPT decode step's variant (another
template flag, entry `decode_attn_write`): it takes q and the new token's
k and v from the fused Wqkv output by strides, writes k and v into a
float32 or bf16 cache at each row's `cache_index` as `write_kv_cache`
would, attends with the fresh values at that slot, and merges the splits
in the same launch (the last split of a row to finish merges). One launch
where there were the cache write's index kernels, a copy of q, the split
kernel and the merge kernel. `decode_write_attention_split` is its plain
version. An int8 cache keeps `write_kv_cache` and `decode_attn`.

`chunk_decode_attention` is the speculative verify step's attention: a
chunk of D queries over the cache, each up to its own position. In the
JAX package it is XLA, not a Pallas kernel, so here it is plain torch on
both devices (the (B, nh, D, Lmax) scores are ~1 MB at 7b), and it
dequantizes an int8 cache as the decode kernel does, in float32 without
rounding, so that a verify chunk and a decode step compute the same
function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..nn.quant import QuantArray
from . import _build

_DECODE = "decode_attn"
Cache = Union[torch.Tensor, QuantArray]
# The kernel's code for the cache's storage type.
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def dequantize_cache(c: Cache):
    """A cache as float32: int8 values times their float32 scales, with
    no rounding in between."""
    if isinstance(c, QuantArray):
        return c.values.float() * c.scales.float()
    return c.float()


def _float_repeat(k_cache: Cache, v_cache: Cache, nh: int):
    """Both caches in float32 (dequantized without rounding), their kv
    heads repeated to nh."""
    k, v = dequantize_cache(k_cache), dequantize_cache(v_cache)
    nkv = k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    return k, v


def alibi_columns(slopes, lmax: int, device):
    """(nh, Lmax) float32: slopes[h] * j, the ALiBi term of slot j."""
    cols = torch.arange(lmax, dtype=torch.float32, device=device)
    return slopes.float().to(device)[:, None] * cols[None, :]


def decode_attention_plain(q, k_cache: Cache, v_cache: Cache, kv_mask,
                           sm_scale: float, slopes=None):
    """q (B, nh, hd) over caches (B, Lmax, nkv, hd) (tensors or
    QuantArrays) with kv_mask (B, Lmax), > 0 = live slot; `slopes` (nh,)
    adds slopes[h] * j to slot j's score. float32 softmax over the live
    slots; a row with none gives 0. Returns (B, nh, hd) in q's dtype."""
    nh = q.shape[1]
    k, v = _float_repeat(k_cache, v_cache, nh)
    live = (kv_mask > 0)[:, None, :]
    s = torch.einsum("bnd,blnd->bnl", q.float() * sm_scale, k)
    if slopes is not None:
        s = s + alibi_columns(slopes, k.shape[1], q.device)
    s = s.masked_fill(~live, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # masked slots: exp(-inf) = 0
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bnl,blnd->bnd", p / denom, v).to(q.dtype)


# The kernel's split (csrc/decode_attn.cu): at most CHUNK_MAX slots and
# HEADS_MAX query heads a block; enough splits for TARGET_BLOCKS blocks
# (four an SM of the H100's 132), with at least MIN_CHUNK slots a split.
CHUNK_MAX, HEADS_MAX, MIN_CHUNK = 64, 8, 16
TARGET_BLOCKS = 4 * 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, nh: int, nkv: int, lmax: int) -> Tuple[int, int]:
    """(splits, chunk): the kernel cuts each (batch row, kv head)'s Lmax
    slots into `splits` runs of `chunk` (the last may be shorter). Pure:
    shapes only, never the mask or the live lengths, so choosing it needs
    no device sync. Enough splits to give TARGET_BLOCKS blocks, no run
    shorter than MIN_CHUNK unless Lmax is, none longer than CHUNK_MAX."""
    blocks = b * nkv * _cdiv(nh // nkv, HEADS_MAX)
    splits = max(min(_cdiv(TARGET_BLOCKS, max(blocks, 1)),
                     lmax // MIN_CHUNK), _cdiv(lmax, CHUNK_MAX), 1)
    chunk = max(_cdiv(lmax, splits), 1)
    return max(_cdiv(lmax, chunk), 1), chunk


def decode_attention_split(q, k_cache: Cache, v_cache: Cache, kv_mask,
                           sm_scale: float, plan=None, slopes=None):
    """The kernel's algorithm in plain torch (float32): each split's
    softmax state (m, l, acc) over its slots, an empty one (m = -inf,
    l = 0) where no slot is live, then the merge (max, rescaled sums,
    acc / l; a row with no live slot gives 0). `plan` defaults to
    decode_plan's; `slopes` as in decode_attention_plain. Returns
    (B, nh, hd) float32."""
    b, nh, hd = q.shape
    nkv = (k_cache.values if isinstance(k_cache, QuantArray)
           else k_cache).shape[2]
    k, v = _float_repeat(k_cache, v_cache, nh)
    lmax = k.shape[1]
    splits, chunk = plan or decode_plan(b, nh, nkv, lmax)
    live = kv_mask > 0
    qs = q.float() * sm_scale
    alibi = None if slopes is None else alibi_columns(slopes, lmax, q.device)
    ms, ls, accs = [], [], []
    for i in range(splits):
        sl = slice(i * chunk, min((i + 1) * chunk, lmax))
        s = torch.einsum("bnd,blnd->bnl", qs, k[:, sl])
        if alibi is not None:
            s = s + alibi[:, sl]
        s = s.masked_fill(~live[:, None, sl], -torch.inf)
        m = s.amax(dim=-1)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bnl,blnd->bnd", p, v[:, sl]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    mx = m.amax(0)
    w = torch.where(torch.isfinite(m), torch.exp(m - mx), 0.0)
    den = (l * w).sum(0)
    num = (acc * w[..., None]).sum(0)
    return torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None],
                       0.0)


def _lib():
    fn = _build.library(_DECODE).decode_attn
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                       i32, i32, ctypes.c_float, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_kernel(q, k_cache: Cache, v_cache: Cache, kv_mask,
                            sm_scale: float, slopes=None):
    """Launch csrc/decode_attn.cu (its ALiBi variant when `slopes`, (nh,)
    float32, is given; such a launch also counts under
    `decode_attn/alibi`). Forward only: raises when grad mode is on and an
    input requires grad."""
    quant = isinstance(k_cache, QuantArray)
    if quant != isinstance(v_cache, QuantArray):
        raise TypeError(f"{_DECODE}: k and v caches of different kinds")
    kv, vv = (k_cache.values, v_cache.values) if quant else (k_cache, v_cache)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, kv, vv)):
        raise RuntimeError(
            f"{_DECODE}: the CUDA kernel is forward-only, and an input "
            "requires grad; decode under torch.no_grad()")
    b, nh, hd = q.shape
    lmax, nkv = kv.shape[1], kv.shape[2]
    if hd > 128 or nkv == 0 or nh % nkv:
        raise ValueError(f"{_DECODE}: nh={nh} nkv={nkv} hd={hd}; need "
                         "hd <= 128 and nh % nkv == 0")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{_DECODE}: q dtype {q.dtype}; need bfloat16 or "
                        "float32")
    if kv.dtype not in _KV_CODES or quant != (kv.dtype == torch.int8):
        raise TypeError(f"{_DECODE}: cache dtype {kv.dtype}; need float32 or "
                        "bfloat16 tensors, or int8 QuantArrays")
    check = _build.check_operand
    check(_DECODE, "q", q, q.dtype, (b, nh, hd))
    check(_DECODE, "k cache", kv, kv.dtype, (b, lmax, nkv, hd))
    check(_DECODE, "v cache", vv, kv.dtype, (b, lmax, nkv, hd))
    ks = vs = None
    if quant:
        ks, vs = k_cache.scales, v_cache.scales
        check(_DECODE, "k scales", ks, torch.float32, (b, lmax, nkv, 1))
        check(_DECODE, "v scales", vs, torch.float32, (b, lmax, nkv, 1))
    mask = kv_mask if kv_mask.dtype == torch.int32 else kv_mask.to(torch.int32)
    mask = mask.contiguous()
    check(_DECODE, "kv_mask", mask, torch.int32, (b, lmax))
    if slopes is not None:
        check(_DECODE, "slopes", slopes, torch.float32, (nh,))
    out = torch.empty_like(q)
    if b and nh:
        splits, chunk = decode_plan(b, nh, nkv, lmax)
        # The splits' partial states: acc (B, nh, splits, hd), then (m, l).
        part = (torch.empty(b * nh * splits * (hd + 2), dtype=torch.float32,
                            device=q.device) if splits > 1 else None)
        ptr = _build.ptr
        err = _lib()(ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(slopes),
                     ptr(mask), ptr(out), ptr(part), b, lmax, nh, nkv, hd,
                     float(sm_scale), int(q.dtype == torch.bfloat16),
                     _KV_CODES[kv.dtype], splits, chunk,
                     _build.stream_handle(q.device))
        _build.LAUNCHES[_DECODE] += 1
        if slopes is not None:
            _build.LAUNCHES[_DECODE + "/alibi"] += 1
        _build.check(err, _DECODE)
    return out


def flash_decode_attention(q, k_cache: Cache, v_cache: Cache, kv_mask,
                           sm_scale: Optional[float] = None, slopes=None):
    """q (B, nh, hd), one decode step's queries; k/v_cache
    (B, Lmax, nkv, hd) tensors, or QuantArrays with (B, Lmax, nkv, 1)
    scales; kv_mask (B, Lmax), 1 = live slot; `slopes` (nh,) float32 the
    ALiBi slopes, or None. Returns (B, nh, hd)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    run = decode_attention_kernel if q.is_cuda else decode_attention_plain
    return run(q, k_cache, v_cache, kv_mask, sm_scale, slopes=slopes)


def decode_write_attention_split(qkv, k_cache, v_cache, kv_mask, cache_index,
                                 nh: int, sm_scale: float, plan=None,
                                 slopes=None):
    """The write variant in plain torch: qkv (B, nh*hd + 2*nkv*hd) holds
    q, then the new token's k, then its v; each row's k/v go into the
    (B, Lmax, nkv, hd) tensor caches, in place, at slot cache_index[b]
    (rounded to the cache's dtype; a slot outside [0, Lmax) writes
    nothing), then decode_attention_split over the caches with kv_mask.
    Returns (B, nh, hd) float32."""
    b = qkv.shape[0]
    lmax, nkv, hd = k_cache.shape[1:]
    q, k, v = qkv.reshape(b, -1).split((nh * hd, nkv * hd, nkv * hd), dim=-1)
    slots = torch.arange(lmax, device=qkv.device)
    at = (slots[None] == cache_index.long()[:, None])[..., None, None]
    for cache, fresh in ((k_cache, k), (v_cache, v)):
        fresh = fresh.reshape(b, 1, nkv, hd).to(cache.dtype)
        cache.copy_(torch.where(at, fresh, cache))
    return decode_attention_split(q.reshape(b, nh, hd), k_cache, v_cache,
                                  kv_mask, sm_scale, plan=plan, slopes=slopes)


# The write variant's split counters, device index -> int32 zeros: a
# launch with more than one split counts each (batch row, head block)'s
# finished splits there and leaves them zero, so the launches on a device
# share one buffer and run one after another (the port decodes on one
# stream at a time). The buffer is made and zeroed eagerly, never inside
# a CUDA graph capture, where its zero fill would only be recorded in
# that graph: a capture finds it made by the eager warm-up before it. An
# outgrown buffer is kept, since a captured graph may still point at it.
_COUNTERS: Dict[int, List[torch.Tensor]] = {}


def _split_counters(device, n: int):
    bufs = _COUNTERS.setdefault(device.index, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{_DECODE}/write: its split counters are made outside a "
                "CUDA graph capture; run the step once eagerly first")
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _write_lib():
    fn = _build.library(_DECODE).decode_attn_write
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_long, vp, vp, vp, vp, vp, vp, vp, vp, i32,
                       i32, i32, i32, i32, ctypes.c_float, i32, i32, i32, i32,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def decode_write_attention_kernel(qkv, k_cache, v_cache, kv_mask, cache_index,
                                  nh: int, sm_scale: float, slopes=None):
    """Launch csrc/decode_attn.cu's write variant (counted under
    `decode_attn/write`, not `decode_attn`). Forward only, as
    decode_attention_kernel."""
    name = _DECODE + "/write"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, k_cache, v_cache)):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only, and an input "
            "requires grad; decode under torch.no_grad()")
    if isinstance(k_cache, QuantArray) or isinstance(v_cache, QuantArray):
        raise TypeError(f"{name}: an int8 cache is written by write_kv_cache")
    b = qkv.shape[0]
    lmax, nkv, hd = k_cache.shape[1:]
    if hd > 128 or nkv == 0 or nh % nkv:
        raise ValueError(f"{name}: nh={nh} nkv={nkv} hd={hd}; need "
                         "hd <= 128 and nh % nkv == 0")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: qkv dtype {qkv.dtype}; need bfloat16 or "
                        "float32")
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: cache dtype {k_cache.dtype}; need float32 "
                        "or bfloat16 tensors")
    check = _build.check_operand
    check(name, "qkv", qkv, qkv.dtype, (b, (nh + 2 * nkv) * hd))
    check(name, "k cache", k_cache, k_cache.dtype, (b, lmax, nkv, hd))
    check(name, "v cache", v_cache, k_cache.dtype, (b, lmax, nkv, hd))
    mask = kv_mask if kv_mask.dtype == torch.int32 else kv_mask.to(torch.int32)
    mask = mask.contiguous()
    check(name, "kv_mask", mask, torch.int32, (b, lmax))
    index = cache_index.long().contiguous()
    check(name, "cache_index", index, torch.int64, (b,))
    if slopes is not None:
        check(name, "slopes", slopes, torch.float32, (nh,))
    out = qkv.new_empty((b, nh, hd))
    if b and nh:
        splits, chunk = decode_plan(b, nh, nkv, lmax)
        part = counters = None
        if splits > 1:
            part = torch.empty(b * nh * splits * (hd + 2), dtype=torch.float32,
                               device=qkv.device)
            counters = _split_counters(
                qkv.device, b * nkv * _cdiv(nh // nkv, HEADS_MAX))
        ptr = _build.ptr
        err = _write_lib()(
            ptr(qkv), qkv.stride(0), ptr(k_cache), ptr(v_cache), ptr(slopes),
            ptr(mask), ptr(index), ptr(out), ptr(part), ptr(counters), b, lmax,
            nh, nkv, hd, float(sm_scale), int(qkv.dtype == torch.bfloat16),
            _KV_CODES[k_cache.dtype], splits, chunk,
            _build.stream_handle(qkv.device))
        _build.LAUNCHES[name] += 1
        _build.check(err, name)
    return out


def decode_write_attention(qkv, k_cache, v_cache, kv_mask, cache_index,
                           nh: int, sm_scale: Optional[float] = None,
                           slopes=None):
    """One decode step's attention straight from the fused projection:
    qkv (B, nh*hd + 2*nkv*hd), q then the new token's k and v; k/v_cache
    (B, Lmax, nkv, hd) float32 or bf16 tensors, written in place at slot
    cache_index[b] (B,); kv_mask (B, Lmax), 1 = live slot, the new slot
    included; `slopes` (nh,) float32 the ALiBi slopes, or None. Returns
    (B, nh, hd) in qkv's dtype."""
    hd = k_cache.shape[-1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    if qkv.is_cuda:
        return decode_write_attention_kernel(qkv, k_cache, v_cache, kv_mask,
                                             cache_index, nh, sm_scale,
                                             slopes=slopes)
    return decode_write_attention_split(qkv, k_cache, v_cache, kv_mask,
                                        cache_index, nh, sm_scale,
                                        slopes=slopes).to(qkv.dtype)


def chunk_decode_attention(q, k_cache: Cache, v_cache: Cache, kv_mask,
                           q_positions, sm_scale: Optional[float] = None):
    """Multi-token ("verify") attention over the KV cache (JAX
    `chunk_decode_attention`): a chunk of D tokens, already written into
    the cache at per-row offsets, each attending over the live slots up
    to its own position. q (B, D, nh, hd); k/v_cache (B, Lmax, nkv, hd)
    tensors or QuantArrays; kv_mask (B, Lmax), > 0 = live slot, the
    chunk's slots included; q_positions (B, D) the chunk's absolute
    positions (slot j holds position j, so a query sees slot <= its
    position). Plain torch on every device, float32 softmax. Returns
    (B, D, nh, hd) in q's dtype."""
    b, d, nh, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    k, v = _float_repeat(k_cache, v_cache, nh)
    slots = torch.arange(k.shape[1], device=q.device)
    s = torch.einsum("bdnh,blnh->bndl", q.float() * sm_scale, k)
    visible = ((kv_mask > 0)[:, None, :]
               & (slots[None, None, :] <= q_positions[:, :, None]))
    s = s.masked_fill(~visible[:, None], -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bndl,blnh->bdnh", p, v).to(q.dtype)
