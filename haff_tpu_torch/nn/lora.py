"""LoRA adapters (port of haff_tpu/nn/lora.py).

Rank-r adapters on the LLM's q/v projections (reference train_ds.py:
192-231): y = base(x) + ((drop(x) @ a) @ b) * alpha / r, with `lora_a`
(in, r) and `lora_b` (r, out) in the JAX layout, so a JAX tree bridges
unchanged. The q/v projections keep the `base` layout at rank 0 too.

Input dropout runs only when the caller passes a `dropout_seed`, and its
mask comes from a generator seeded with it: under activation
checkpointing the recomputed forward redraws the same mask, as JAX's
`fold_in` keys do (torch.utils.checkpoint restores only the default RNG
states, never an explicit generator's).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.mesh import current_batch_rows
from ..parallel.collectives import copy_to_tp, reduce_from_tp
from .layers import QDense

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, *data: int) -> int:
    """Deterministically mix integers into a seed (splitmix64 finaliser),
    the counterpart of `jax.random.fold_in`; returns a seed in [0, 2^63)."""
    x = seed & _MASK64
    for d in data:
        x = (x ^ ((d + 0x9E3779B97F4A7C15) & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def dropout(x, rate: float, seed: int, cols: Optional[Tuple[int, int]] = None):
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the mask is drawn from a generator seeded `seed`.

    The mask does not depend on the mesh, as JAX's threefry draws do not:
    it is drawn over the GLOBAL shape of x (B, ..., in) and this rank keeps
    its block: its rows of a batch sharded over (data, fsdp) (the ambient
    `core.mesh.BatchRows`), and, for a row-parallel input holding columns
    [c0, c0 + in_local) of `in_full`, `cols = (c0, in_full)`."""
    shape, b0, c0 = list(x.shape), 0, 0
    rows = current_batch_rows()
    if rows is not None and rows.sharded:
        shape[0], b0 = rows.total, rows.offset
    if cols is not None:
        c0, shape[-1] = cols
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(shape, generator=g, device=x.device) >= rate
    if shape != list(x.shape):
        keep = keep[b0:b0 + x.shape[0]].narrow(-1, c0, x.shape[-1])
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LoraDense(nn.Module):
    # Set for float32-held trainable adapters: the dtype they are cast to at
    # use (flax `dtype`); None computes in the parameters' own dtype.
    compute_dtype: Optional[torch.dtype] = None
    # Tensor parallelism (parallel/sharding.py): "column" (base rows and
    # lora_b columns are this rank's outputs; x @ lora_a is replicated and
    # enters the region through copy_to_tp) or "row" (base columns and
    # lora_a rows are this rank's inputs, `in_cols` = (first column, full
    # width) for the dropout mask; both products are summed over the group).
    tp_mode: Optional[str] = None
    tp_group = None
    in_cols: Optional[Tuple[int, int]] = None

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 alpha: float = 16.0, dropout: float = 0.0,
                 use_bias: bool = False):
        super().__init__()
        self.rank, self.alpha, self.dropout = rank, alpha, dropout
        self.base = QDense(in_features, features, bias=use_bias)
        if rank:
            self.lora_a = nn.Parameter(torch.empty(in_features, rank))
            self.lora_b = nn.Parameter(torch.empty(rank, features))
            self.reset_lora_()

    @torch.no_grad()
    def reset_lora_(self, generator: Optional[torch.Generator] = None):
        """flax he_uniform over fan-in `in` for a, zeros for b."""
        bound = math.sqrt(6.0 / self.lora_a.shape[0])
        a = torch.rand(self.lora_a.shape, generator=generator,
                       device=(self.lora_a.device if generator is None
                               else generator.device)) * (2 * bound) - bound
        if not self.lora_a.is_meta:  # a meta shadow's draw is dropped
            self.lora_a.copy_(a)
        self.lora_b.zero_()

    def forward(self, x, dropout_seed: Optional[int] = None, base_input=None):
        """`base_input` (default x) feeds the base product: a column-parallel
        caller passes x already entered into the tensor-parallel region."""
        y = self.base(x if base_input is None else base_input)
        if self.tp_mode == "row":
            y = reduce_from_tp(y, self.tp_group)
        if not self.rank:
            return y
        dt = self.compute_dtype or self.lora_a.dtype
        h = x
        if self.dropout > 0.0 and dropout_seed is not None:
            h = dropout(h, self.dropout, dropout_seed, self.in_cols)
        h = h.to(dt) @ self.lora_a.to(dt)
        if self.tp_mode == "row":
            h = reduce_from_tp(h, self.tp_group)
        elif self.tp_mode == "column":
            h = copy_to_tp(h, self.tp_group)
        delta = h @ self.lora_b.to(dt)
        return y + delta * (self.alpha / self.rank)
