"""Modules of the port (float path), NHWC at public boundaries.

The JAX package's `haff_tpu.nn` exports, resolved at first access: the
decoders import the kernel modules, which import `nn.quant`, so importing
them eagerly here would make `kernels` and `nn` import each other."""

import importlib

_EXPORTS = {
    "ChannelLayerNorm": "layers", "MLPBlock": "layers", "ReluMLP": "layers",
    "MaskDecoder": "mask_decoder",
    "PositionEmbeddingRandom": "prompt_encoder",
    "PromptEncoder": "prompt_encoder",
    "Sam": "sam", "preprocess_image": "sam",
    "SamImageEncoder": "sam_image_encoder",
    "TwoWayTransformer": "two_way_transformer",
    "ClipVisionTower": "clip_vit",
    "LlamaForCausalLM": "llama", "RMSNorm": "llama",
    "LoraDense": "lora",
    "MptConfig": "mpt", "MptForCausalLM": "mpt",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
