"""Dtype policy: names to torch dtypes (port of haff_tpu/core/dtypes.py).

Compute runs in the model dtype (bfloat16 on the card); layer norms,
RMSNorm, softmax and the SAM neck run in float32, as in the reference.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def resolve(name_or_dtype):
    if isinstance(name_or_dtype, str):
        return _DTYPES[name_or_dtype]
    return name_or_dtype


def set_reference_precision() -> None:
    """Keep float32 products in full float32 on the card, as the reference
    does (JAX tests run at matmul precision "highest"). PyTorch's default
    lets cuDNN run float32 convolutions in TF32 (about three decimal
    digits), which would cover the float32 SAM neck; matmuls already
    default to full float32, and stay so."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
