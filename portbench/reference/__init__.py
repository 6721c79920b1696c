"""Plain float32 PyTorch references of the benchmark's models.

Written from the published descriptions (segment-anything's
`image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py` and
`transformer.py`; HF `CLIPVisionModel` with LLaVA's feature selection;
MosaicML's `modeling_mpt.py` with ALiBi; LISA's and 2HandedAfforder's
evaluate), with no kernel, cache or batching. They import nothing of the
program: weights come as a dict of tensors named as the program's
parameters, made by `portbench.weights` from the run's seed.

Set `plain_precision()` before running one on the card: float32
products stay float32 (TF32 off).
"""

import torch


def plain_precision() -> None:
    """Full float32 matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
