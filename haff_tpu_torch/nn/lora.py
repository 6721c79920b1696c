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
from typing import Optional

import torch
from torch import nn

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


def dropout(x, rate: float, seed: int):
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the mask is drawn from a generator seeded `seed`."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LoraDense(nn.Module):
    # Set for float32-held trainable adapters: the dtype they are cast to at
    # use (flax `dtype`); None computes in the parameters' own dtype.
    compute_dtype: Optional[torch.dtype] = None

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
        self.lora_a.copy_(torch.rand(self.lora_a.shape, generator=generator,
                                     device=self.lora_a.device)
                          * (2 * bound) - bound)
        self.lora_b.zero_()

    def forward(self, x, dropout_seed: Optional[int] = None):
        y = self.base(x)
        if not self.rank:
            return y
        dt = self.compute_dtype or self.lora_a.dtype
        h = x
        if self.dropout > 0.0 and dropout_seed is not None:
            h = dropout(h, self.dropout, dropout_seed)
        delta = (h.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
        return y + delta * (self.alpha / self.rank)
