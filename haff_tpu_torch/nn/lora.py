"""LoRA adapter layout (port of haff_tpu/nn/lora.py, rank 0).

The q/v projections of the LLM keep the `q_proj.base` / `v_proj.base`
parameter layout of the JAX package even without adapters, so a
checkpoint of the default tree loads unchanged. Rank > 0 adapters belong
to the training slice.
"""

from __future__ import annotations

from torch import nn

from .layers import QDense


class LoraDense(nn.Module):
    def __init__(self, in_features: int, features: int, rank: int = 0,
                 use_bias: bool = False):
        super().__init__()
        if rank:
            raise NotImplementedError(
                "LoRA adapters (rank > 0) are not ported yet; merge them "
                "into the base kernels first (tools/merge_lora.py)")
        self.base = QDense(in_features, features, bias=use_bias)

    def forward(self, x):
        return self.base(x)
