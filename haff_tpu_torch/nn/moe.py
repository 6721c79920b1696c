"""Mixture-of-Experts decoder MLP (port of haff_tpu/nn/moe.py).

The GShard/Switch static-shape formulation, as in the JAX package: router
logits in the compute dtype, softmax in float32, an iterative top-k (K
unrolled amax/argmax steps), a fixed expert capacity with k-major slot
priority (every first choice outranks every second choice), and
dispatch/combine as one-hot products, so every shape is static and the
forward never waits for the device (a decode step or a speculative verify
step with MoE layers is captured in a CUDA graph). Overflowed tokens get
no expert output and pass through on the residual.

The dispatch, expert SwiGLU and combine are the einsums JAX computes
outside any Pallas kernel; here they are `torch.einsum` (batched GEMMs).
The stacked expert weights keep JAX's layout, (E, d, f) for gate/up and
(E, f, d) for down, so a flax tree loads unchanged through tools/bridge.py.

On a mesh (parallel/sharding.py), where JAX's `_expert_constraint` lets
GSPMD place the experts:

  * expert parallelism: a rank holds E / ep experts (`expert_start` on);
    the expert ranks hold the same batch rows, route them alike, run their
    own experts' slots, and the combine is summed over the expert group.
    The router's probabilities and the tokens enter that region through
    `copy_to_tp` (their gradients summed over the group); the aux term is
    taken from the probabilities before it, so its gradient is counted
    once;
  * tensor parallelism splits each expert's `mlp` width (gate/up columns,
    down rows), summed over the tensor group;
  * a batch sharded over (data, fsdp) keeps JAX's one capacity pool over
    the global batch: the capacity counts the global tokens, each shard
    offsets its k-major slot positions by the earlier shards' per-(k, e)
    counts (after every k' < k choice of every shard), and the Switch
    term uses the global f_e and this shard's share of P_e, so the shares
    summed over the shards are JAX's aux. Per-row (`no_drop`) routing
    needs nothing from other shards.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import LlamaConfig
from ..core.mesh import current_batch_rows
from ..parallel.collectives import (all_gather, all_reduce, copy_to_tp,
                                    group_rank, reduce_from_tp)
from .layers import QDense


def moe_layers(cfg: LlamaConfig) -> Tuple[int, ...]:
    """Indices of the decoder layers whose MLP is an MoE MLP: layer i when
    i % moe_every == moe_every - 1 (none when moe_num_experts is 0)."""
    if cfg.moe_num_experts <= 0:
        return ()
    return tuple(i for i in range(cfg.num_layers)
                 if i % cfg.moe_every == cfg.moe_every - 1)


def _one_hot(index, n: int):
    """float32 one-hot of an integer tensor over n classes; an index
    outside [0, n) gives a zero row (jax.nn.one_hot's rule, which the slot
    one-hot relies on for tokens past capacity)."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


class MoEMLP(nn.Module):
    """LlamaMLP's (B, L, d) -> (B, L, d) contract, each token routed to the
    top-k of E SwiGLU experts; `forward` returns (y, aux), aux being the
    Switch load-balance term E * sum_e f_e * P_e (1.0 at perfect balance).

    Routing modes (`no_drop`, chosen by the caller at each call):

      * training / plain forward (False): one capacity pool over all b*l
        tokens, ceil(K * n / E * capacity_factor) slots an expert, k-major
        priority; overflowed tokens pass through on the residual.
      * serving (True; nn/llama.py sets it whenever a KV cache is passed):
        a slot pool per row, capacity l for l <= 64 (nothing drops: a
        decode step, a verify chunk) and min(l, ceil(K * l / E * cf))
        for longer rows (prefill), so a token's experts never depend on
        the rows batched with it.

    `token_mask` (b, l) excludes padding: masked tokens take no slot, get
    zero output and are left out of the aux statistics.

    `compute_dtype` (set by train.trainer.partition_params when the
    experts are trained in float32 inside a lower-precision model) is the
    dtype the stacked weights are cast to at use."""

    compute_dtype = None
    # Meshes (parallel/sharding.py): the expert group and this rank's first
    # expert; the tensor group over each expert's mlp width.
    ep_group = None
    expert_start = 0
    tp_group = None

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, d, f = cfg.moe_num_experts, cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.router = QDense(d, E, bias=False)
        self.gate_proj = nn.Parameter(torch.empty(E, d, f))
        self.up_proj = nn.Parameter(torch.empty(E, d, f))
        self.down_proj = nn.Parameter(torch.empty(E, f, d))

    def _route(self, xt, token_mask):
        """Router probabilities (n, E) f32, gates (K, n) and one-hots
        (K, n, E) (masked tokens' rows zero), the live mask (n,) or None."""
        cfg = self.cfg
        E = cfg.moe_num_experts
        K = min(cfg.moe_top_k, E)
        probs = torch.softmax(self.router(xt).float(), dim=-1)
        # Into the expert-parallel region: each expert rank's combine
        # reaches the router through its own experts only.
        routed = copy_to_tp(probs, self.ep_group)
        gates, onehots = [], []
        masked = routed
        for _ in range(K):
            # amax: the gradient spreads over ties as jnp.max's does;
            # argmax takes the first index on ties, as JAX's.
            gates.append(torch.amax(masked, dim=-1))
            oh = _one_hot(torch.argmax(masked, dim=-1), E)
            onehots.append(oh)
            masked = masked * (1.0 - oh)
        gates = torch.stack(gates)
        onehot = torch.stack(onehots)
        if K > 1:
            gates = gates / (gates.sum(dim=0, keepdim=True) + 1e-9)
        live = None
        if token_mask is not None:
            live = token_mask.reshape(-1).float()
            onehot = onehot * live[None, :, None]
        return probs, gates, onehot, live

    def _experts(self, xin, spec: str):
        """The stacked SwiGLU over dispatched tokens; `spec` names xin's
        axes ("becd" per row, "ecd" pooled)."""
        dt = self.compute_dtype or xin.dtype
        wg, wu, wd = (w.to(dt) for w in (self.gate_proj, self.up_proj,
                                         self.down_proj))
        xin = copy_to_tp(xin, self.tp_group)
        out = spec[:-1] + "f"
        h = (F.silu(torch.einsum(f"{spec},edf->{out}", xin, wg))
             * torch.einsum(f"{spec},edf->{out}", xin, wu))
        return reduce_from_tp(torch.einsum(f"{out},efd->{spec}", h, wd),
                              self.tp_group)

    def _global_offsets(self, onehot, group):
        """(K, E) offsets that turn this batch shard's k-major exclusive
        slot positions into the global batch's: the global counts of every
        k' < k choice, less this shard's, plus the earlier shards' k-th
        choices."""
        counts = onehot.sum(dim=1)                          # (K, E)
        shards = all_gather(counts[None], group, 0)         # (S, K, E)
        total = shards.sum(dim=0)
        me = group_rank(group)
        before_k = torch.cumsum(total, 0) - total
        mine_before_k = torch.cumsum(counts, 0) - counts
        return before_k - mine_before_k + shards[:me].sum(dim=0)

    def forward(self, x, token_mask=None, no_drop: bool = False):
        cfg = self.cfg
        E = cfg.moe_num_experts
        K = min(cfg.moe_top_k, E)
        b, l, d = x.shape
        n = b * l
        xt = x.reshape(n, d)
        probs, gates, onehot, live = self._route(xt, token_mask)
        # This rank's experts [e0, e1) (all of them off an expert axis).
        e0 = self.expert_start
        e1 = e0 + self.gate_proj.shape[0]
        xe = copy_to_tp(x, self.ep_group)
        rows = current_batch_rows()
        group = (rows.group if rows is not None and rows.sharded and
                 not no_drop else None)
        if no_drop:
            if l <= 64:
                capacity = l
            else:
                capacity = max(1, min(l, math.ceil(
                    K * l / E * cfg.moe_capacity_factor)))
            oh_b = onehot.reshape(K, b, l, E).transpose(0, 1)
            flat = oh_b.reshape(b, K * l, E)
            pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, K, l, E)
            slot = (pos * oh_b).sum(dim=-1).long()
            kept = ((pos < capacity) * oh_b).sum(dim=-1)
            slot_oh = _one_hot(slot, capacity) * kept[..., None]
            gates_b = gates.reshape(K, b, l).transpose(0, 1)
            oh_b = oh_b[..., e0:e1]
            dispatch = torch.einsum("bkle,bklc->blec", oh_b, slot_oh)
            combine = torch.einsum("bkle,bklc,bkl->blec", oh_b, slot_oh,
                                   gates_b)
            xin = torch.einsum("blec,bld->becd", dispatch.to(x.dtype), xe)
            ye = self._experts(xin, "becd")
            y = torch.einsum("blec,becd->bld", combine.to(x.dtype), ye)
        else:
            total = n if group is None else rows.total * l
            capacity = max(1, math.ceil(K * total / E
                                        * cfg.moe_capacity_factor))
            flat = onehot.reshape(K * n, E)
            pos = (torch.cumsum(flat, dim=0) - flat).reshape(K, n, E)
            if group is not None:
                pos = pos + self._global_offsets(onehot, group)[:, None, :]
            slot = (pos * onehot).sum(dim=-1).long()
            kept = ((pos < capacity) * onehot).sum(dim=-1)
            slot_oh = _one_hot(slot, capacity) * kept[..., None]
            mine = onehot[..., e0:e1]
            dispatch = torch.einsum("kne,knc->nec", mine, slot_oh)
            combine = torch.einsum("kne,knc,kn->nec", mine, slot_oh, gates)
            xin = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype),
                               xe.reshape(n, d))
            ye = self._experts(xin, "ecd")
            y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), ye)
        y = reduce_from_tp(y, self.ep_group)

        # Switch load balance: f_e the top-1 assignment share, P_e the mean
        # router probability, over live tokens when there is a mask; over
        # a sharded batch, the global f_e and this shard's share of P_e.
        if group is None:
            if live is not None:
                denom = live.sum().clamp(min=1.0)
                f_e = onehot[0].sum(dim=0) / denom
                p_e = (probs * live[:, None]).sum(dim=0) / denom
            else:
                f_e = onehot[0].mean(dim=0)
                p_e = probs.mean(dim=0)
        else:
            live = torch.ones(n, device=x.device) if live is None else live
            stats = all_reduce(torch.cat([onehot[0].sum(dim=0),
                                          live.sum()[None]]).detach(), group)
            denom = stats[E].clamp(min=1.0)
            f_e = stats[:E] / denom
            p_e = (probs * live[:, None]).sum(dim=0) / denom
        aux = E * (f_e * p_e).sum()
        return y.reshape(b, l, d).to(x.dtype), aux
