"""Ring attention — sequence-parallel flash attention over a mesh axis
(port of haff_tpu/parallel/ring_attention.py).

Each rank of the axis holds a (B, L/n, H, D) chunk of q, k and v. K/V
chunks rotate around the ring (`collectives.ppermute_tensors`, one message
a step) while every rank merges online-softmax partials for its own
queries:

  * per-chunk compute is the port's flash kernels on CUDA tensors
    (`flash_prefill_kernel`, `flash_bwd_kernel`) and their plain versions
    on CPU tensors (`attention_plain`, `attention_bwd_plain`): the forward
    returns the logsumexp the merge needs, and the backward applied with
    the GLOBAL (merged) out/lse against one K/V chunk gives the
    distributed-flash partial gradients;
  * causal masking is resolved per ring step by the chunk's relation: a
    past chunk runs the dense kernel, the diagonal chunk the causal kernel,
    and a future chunk launches nothing;
  * the backward is a second ring pass: the dK/dV accumulators (float32)
    travel with their chunk and take one final hop home. Nothing larger
    than a chunk is saved.

`RingAttention` runs on each rank of the group with its local chunks;
`sequence_sharded_attention` takes logically global tensors and shards
them over the mesh (JAX's `shard_map` wrapper).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from ..core.mesh import Mesh
from ..kernels.flash_attention import (DEFAULT_MASK_VALUE, attention_bwd_plain,
                                       attention_plain, flash_bwd_kernel,
                                       flash_prefill_kernel)
from . import collectives as C

PAST, DIAGONAL, FUTURE = 0, 1, 2
RELATION_NAMES = ("past", "diagonal", "future")
# Chunk steps run by this process, by pass and relation ("fwd/past", ...):
# a record of the ring's schedule, read by the tests.
RELATIONS: "collections.Counter[str]" = collections.Counter()


def _merge(o1, lse1, o2, lse2):
    """Merge two online-softmax partials over disjoint key sets.

    o: (B, Lq, H, D) float32 (each already normalised over its keys), lse:
    (B, H, Lq) float32. A fully-masked partial carries lse ~=
    DEFAULT_MASK_VALUE and merges with weight exp(MASK - valid) == 0."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    lse = m + torch.log(w1 + w2)
    wo1 = w1.permute(0, 2, 1)[..., None]
    wo2 = w2.permute(0, 2, 1)[..., None]
    return (o1 * wo1 + o2 * wo2) / (wo1 + wo2), lse


def _fix_seg_lse(lse, q_seg, k_seg):
    """Rows whose q segment has NO match in this k/v chunk must merge with
    zero weight. The kernel emits lse == 0.0 for its rows with no visible
    key (the right sentinel for all-padding q rows, whose backward needs
    p == exp(MASK - 0) == 0); a VALID q row that merely has no key in this
    chunk gets the mask sentinel instead. All-padding q rows keep 0.0."""
    match = ((q_seg[:, :, None] == k_seg[:, None, :])
             & (k_seg[:, None, :] != 0)).any(-1)          # (B, Lq)
    no_valid = (q_seg != 0) & ~match
    return torch.where(no_valid[:, None, :],
                       torch.full_like(lse, DEFAULT_MASK_VALUE), lse)


def _relation(idx: int, src: int, n: int) -> int:
    """PAST, DIAGONAL or FUTURE, with the chunk index taken mod n (src
    arrives as idx - s, which may be negative)."""
    src = src % n
    return DIAGONAL if src == idx else (PAST if src < idx else FUTURE)


def _chunk_fwd(q, k_c, v_c, q_seg, k_seg, rel, causal, sm_scale):
    """One ring step's partial (out float32, unrounded, as the kernel
    accumulates it; lse (B, H, Lq))."""
    b, lq, h, _ = q.shape
    RELATIONS["fwd/" + RELATION_NAMES[rel if causal else PAST]] += 1
    if causal and rel == FUTURE:
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, lq), DEFAULT_MASK_VALUE, dtype=torch.float32,
                         device=q.device)
    else:
        run = flash_prefill_kernel if q.is_cuda else attention_plain
        out, lse = run(q, k_c, v_c, None, q_seg, k_seg,
                       causal and rel == DIAGONAL, sm_scale,
                       out_dtype=torch.float32)
    if k_seg is not None:
        lse = _fix_seg_lse(lse, q_seg, k_seg)
    return out, lse


def _chunk_bwd(q, k_c, v_c, q_seg, k_seg, out, lse, g, rel, causal,
               sm_scale):
    """Partial (dq, dk_chunk, dv_chunk) for one ring step, float32, or None
    for a skipped future chunk. Feeding the GLOBAL merged out/lse to the
    single-chunk backward gives the distributed-flash partials: p =
    exp(s - lse_global) is the globally normalised probability and delta =
    rowsum(dO * out_global) the global correction term. The kernels write
    the partials unrounded (JAX's are rounded to q's dtype before the sum),
    so the ring's gradient rounds once, as the whole-sequence one does."""
    RELATIONS["bwd/" + RELATION_NAMES[rel if causal else PAST]] += 1
    if causal and rel == FUTURE:
        return None
    run = flash_bwd_kernel if q.is_cuda else attention_bwd_plain
    return run(q, k_c, v_c, None, q_seg, k_seg, out, lse, g,
               causal and rel == DIAGONAL, sm_scale, out_dtype=torch.float32)


class RingAttention(torch.autograd.Function):
    """Sequence-parallel flash attention on this rank's chunks.

    q/k/v: the LOCAL chunk (B, L/n, H, D) of the group `group` (global
    ranks `ranks`, in chunk order); segment ids (B, L/n) int32 (0 =
    padding), both given or both None. Returns the local output chunk.
    For causal=True, q and kv must be the same sequence (aligned chunks of
    equal length)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, group, ranks, causal, sm_scale):
        b, lq, h, d = q.shape
        if causal and k.shape[1] != lq:
            raise ValueError("causal ring attention needs aligned "
                             "equal-length q/kv chunks")
        if sm_scale is None:
            sm_scale = d ** -0.5
        n = len(ranks)
        idx = ranks.index(torch.distributed.get_rank()) if n > 1 else 0
        o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, lq), DEFAULT_MASK_VALUE, dtype=torch.float32,
                         device=q.device)
        k_c, v_c, kseg_c = k, v, k_seg
        for s in range(n):
            o_s, lse_s = _chunk_fwd(q, k_c, v_c, q_seg, kseg_c,
                                    _relation(idx, idx - s, n), causal,
                                    sm_scale)
            o, lse = _merge(o, lse, o_s, lse_s)
            # The last chunk needs no rotation afterwards: 1/n of the ring
            # K/V traffic never happens.
            if s < n - 1:
                k_c, v_c, kseg_c = C.ppermute_tensors(
                    [k_c, v_c, kseg_c], group, ranks)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_seg, k_seg, out, lse)
        ctx.group, ctx.ranks, ctx.idx = group, ranks, idx
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_seg, k_seg, out, lse = ctx.saved_tensors
        group, ranks, idx = ctx.group, ctx.ranks, ctx.idx
        n = len(ranks)
        g = g.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_c = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_c = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_c, v_c, kseg_c = k, v, k_seg
        for s in range(n):
            part = _chunk_bwd(q, k_c, v_c, q_seg, kseg_c, out, lse, g,
                              _relation(idx, idx - s, n), ctx.causal,
                              ctx.sm_scale)
            if part is not None:
                dq += part[0].float()
                dk_c += part[1].float()
                dv_c += part[2].float()
            # dK/dV accumulators travel WITH their chunk; after n rotations
            # each chunk's gradient is home. The last step moves only them.
            if s < n - 1:
                k_c, v_c, kseg_c, dk_c, dv_c = C.ppermute_tensors(
                    [k_c, v_c, kseg_c, dk_c, dv_c], group, ranks)
            else:
                dk_c, dv_c = C.ppermute_tensors([dk_c, dv_c], group, ranks)
        return (dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype), None,
                None, None, None, None, None)


def ring_attention(q, k, v, q_segment_ids, kv_segment_ids, group, ranks,
                   causal: bool = False, sm_scale: Optional[float] = None):
    """Sequence-parallel flash attention on this rank's chunks of the
    group (see `RingAttention`); differentiable in q, k and v."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("ring_attention: give both segment ids or neither")
    return RingAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, group,
                               list(ranks), causal, sm_scale)


def sequence_sharded_attention(mesh: Mesh, axis: str, q, k, v,
                               q_segment_ids=None, kv_segment_ids=None,
                               causal: bool = False,
                               sm_scale: Optional[float] = None,
                               batch_axes=None, heads_axis=None):
    """q/k/v (B, L, H, D) logically global, here the same full tensors on
    every rank of the mesh; each rank takes its sequence chunk over mesh
    axis `axis` (L must divide by its size into 8-aligned chunks), its
    batch rows over `batch_axes` and its heads over `heads_axis` (TP x SP
    composition: heads are independent, so each tensor shard rings over
    its own heads), runs the ring, and all-gathers the output back to
    (B, L, H, D). Gradients flow to the global q, k, v (the region around
    is replicated: the slice's transpose all-gathers, the gather's
    slices)."""
    n = mesh.shape[axis]
    for name, length in (("q", q.shape[1]), ("kv", k.shape[1])):
        if length % n or (length // n) % 8:
            raise ValueError(
                f"{name} sequence {length} must split into 8-aligned "
                f"chunks over {n} '{axis}' devices")
    if q_segment_ids is not None or kv_segment_ids is not None:
        if kv_segment_ids is None:
            kv_segment_ids = q_segment_ids
        if q_segment_ids is None:
            q_segment_ids = torch.ones(q.shape[:2], dtype=torch.int32,
                                       device=q.device)
    sp = mesh.group(axis)
    steps = ((mesh.group(batch_axes), 0), (sp, 1), (mesh.group(heads_axis), 2))
    qs, ks, vs = q, k, v
    segs = [q_segment_ids, kv_segment_ids]
    for grp, dim in steps:
        qs, ks, vs = (C.slice_to_shard(t, grp, dim) for t in (qs, ks, vs))
        if dim < 2:
            segs = [None if s is None else
                    C.block(s, grp, dim).to(torch.int32).contiguous()
                    for s in segs]
    out = ring_attention(qs, ks, vs, segs[0], segs[1], sp,
                         mesh.group_ranks(axis), causal, sm_scale)
    for grp, dim in reversed(steps):
        out = C.gather_from_shard(out, grp, dim)
    return out
