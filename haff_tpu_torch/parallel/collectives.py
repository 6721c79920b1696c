"""Autograd-aware collectives over a process group.

JAX gets these from `shard_map` and GSPMD: every collective there has a
transpose the autodiff applies. Here each is a `torch.autograd.Function`
with the same transpose:

  ppermute            forward: send to the rank `shift` ahead;
                      backward: the reverse permutation
  slice_to_shard      forward: this rank's block along `dim`;
                      backward: all-gather (the region before is replicated)
  gather_from_shard   forward: all-gather along `dim`;
                      backward: this rank's block of the gradient
  copy_to_tp          forward: identity; backward: all-reduce (Megatron's
                      entry into a tensor-parallel region)
  reduce_from_tp      forward: all-reduce; backward: identity (its exit)
  FsdpGather          forward: all-gather a flat parameter shard;
                      backward: sum the gradient over the group, keep the
                      shard (reduce-scatter)

torch's own `torch.distributed.nn.functional.all_reduce` all-reduces the
gradient too, which multiplies it by the group size where the result
feeds a replicated region; these are the transposes JAX uses.

Transport: NCCL groups move CUDA tensors directly. Gloo moves host memory,
so a CUDA tensor is copied to the host, sent, and copied back; the
compute stays on the tensor's device. A bf16 sum is taken in float32 (see
`all_reduce`) and comes back in bf16. A group of None (one rank) makes
every collective the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_LOW = (torch.float16, torch.bfloat16)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def backend(group) -> str:
    return dist.get_backend(group)


def _staged(t, group):
    """`t` as the group's transport takes it: host memory for a CUDA
    tensor under gloo, else itself."""
    if t.is_cuda and backend(group) == "gloo":
        return t.detach().to("cpu")
    return t.detach()


def all_reduce(t, group, op: str = "sum"):
    """The sum (or, with op "max", the maximum) of `t` over the group, as a
    new tensor on t's device in t's dtype. A bf16 / fp16 tensor moves in
    its own dtype and is reduced in float32 on its device, in group-rank
    order (one rounding, the same bits on every rank); other dtypes use
    the backend's all-reduce."""
    if group is None:
        return t
    if t.dtype in _LOW:
        parts = all_gather(t.contiguous()[None], group, 0).float()
        red = parts.sum(0) if op == "sum" else parts.amax(0)
        return red.to(t.dtype)
    x = _staged(t, group).contiguous()
    if x.data_ptr() == t.data_ptr():
        x = x.clone()
    dist.all_reduce(x, group=group, op=(dist.ReduceOp.SUM if op == "sum"
                                        else dist.ReduceOp.MAX))
    return x.to(t.device)


def broadcast_from(t, group, src: int):
    """`t` of global rank `src` on every rank of the group (exact: its
    bytes are sent, as uint8, which every backend takes in any dtype).
    Every rank passes a tensor of the same shape and dtype; the others'
    values are not read."""
    if group is None:
        return t
    x = _staged(t, group).contiguous()
    if x.data_ptr() == t.data_ptr():
        x = x.clone()
    dist.broadcast(x.reshape(-1).view(torch.uint8), src=src, group=group)
    return x.to(t.device)


def all_gather(t, group, dim: int = 0):
    """The group's tensors concatenated along `dim`, in group-rank order."""
    if group is None:
        return t
    x = _staged(t, group).contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def block(t, group, dim: int):
    """This rank's block of `t` along `dim` (the length divides)."""
    n = group_size(group)
    if n == 1:
        return t
    c = t.shape[dim] // n
    return t.narrow(dim, group_rank(group) * c, c)


def _pack(ts: Sequence[torch.Tensor]):
    """One uint8 buffer holding every tensor, each at a 256-byte-aligned
    offset, and the layout to unpack it."""
    layout, off = [], 0
    for t in ts:
        n = t.numel() * t.element_size()
        layout.append((off, n, t.dtype, tuple(t.shape)))
        off += -(-n // 256) * 256
    buf = torch.zeros(off, dtype=torch.uint8, device=ts[0].device)
    for t, (o, n, _, _) in zip(ts, layout):
        buf[o:o + n] = t.detach().contiguous().view(-1).view(torch.uint8)
    return buf, layout


def _unpack(buf, layout, device) -> List[torch.Tensor]:
    """Tensors from `_pack`'s buffer on `device`, each its own allocation
    (contiguous and 256-byte aligned as the kernels' TMA paths want)."""
    out = []
    for o, n, dtype, shape in layout:
        out.append(buf[o:o + n].view(dtype).view(shape).to(device,
                                                             copy=True))
    return out


def ppermute_tensors(ts: Sequence[Optional[torch.Tensor]], group,
                     ranks: Sequence[int], shift: int = 1):
    """Send the tensors to the rank `shift` places ahead in `ranks` (the
    group's global ranks in order) and receive those of the rank `shift`
    places behind (JAX `lax.ppermute` with perm i -> i + shift); Nones
    pass through. One message each way."""
    n = len(ranks)
    if n == 1 or shift % n == 0:
        return list(ts)
    me = ranks.index(dist.get_rank())
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    real = [t for t in ts if t is not None]
    device = real[0].device
    buf, layout = _pack(real)
    buf = _staged(buf, group)
    recv = torch.empty_like(buf)
    reqs = [dist.isend(buf, dst, group=group),
            dist.irecv(recv, src, group=group)]
    for r in reqs:
        r.wait()
    got = iter(_unpack(recv, layout, device))
    return [None if t is None else next(got) for t in ts]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, ranks, shift):
        ctx.group, ctx.ranks, ctx.shift = group, ranks, shift
        return ppermute_tensors([t], group, ranks, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return (ppermute_tensors([g.contiguous()], ctx.group, ctx.ranks,
                                 -ctx.shift)[0], None, None, None)


def ppermute(t, group, ranks: Sequence[int], shift: int = 1):
    return _Ppermute.apply(t, group, list(ranks), shift)


class _SliceToShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return block(t, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _GatherFromShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.group, ctx.dim).contiguous(), None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def slice_to_shard(t, group, dim: int):
    return t if group is None else _SliceToShard.apply(t, group, dim)


def gather_from_shard(t, group, dim: int):
    return t if group is None else _GatherFromShard.apply(t, group, dim)


def copy_to_tp(t, group):
    return t if group is None else _CopyToTP.apply(t, group)


def reduce_from_tp(t, group):
    return t if group is None else _ReduceFromTP.apply(t, group)


class FsdpGather(torch.autograd.Function):
    """A parameter from its flat fsdp shard: all-gather, trim the padding
    to `numel`, view as `shape`. The backward sums the full gradient over
    the group (each rank's holds its own batch rows' share) and keeps this
    rank's shard."""

    @staticmethod
    def forward(ctx, shard, group, numel, shape):
        ctx.group = group
        full = all_gather(shard, group, 0)
        return full[:numel].view(shape)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        flat = g.reshape(-1)
        c = -(-flat.numel() // n)
        flat = torch.nn.functional.pad(flat, (0, c * n - flat.numel()))
        total = all_reduce(flat, ctx.group)
        return total[group_rank(ctx.group) * c:][:c].clone(), None, None, None
