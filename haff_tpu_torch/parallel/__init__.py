"""Mesh parallelism (port of haff_tpu/parallel): sharding rules, ring
attention, the GPipe pipeline and the autograd-aware collectives they run
on.

The names resolve at first use, so that nn/llama.py can import
parallel/collectives.py while parallel/sharding.py imports nn/llama.py.
"""

import importlib

_NAMES = {
    "LOGICAL_RULES": "sharding",
    "batch_sharding": "sharding",
    "param_shardings": "sharding",
    "shard_batch_tree": "sharding",
    "auto_microbatches": "pipeline",
    "pipeline_blocks": "pipeline",
    "pipelined_llm_forward": "pipeline",
    "pipelined_mpt_forward": "pipeline",
    "pipelined_lisa_forward": "pipeline",
    "stack_layer_params": "pipeline",
    "unstack_layer_params": "pipeline",
    "ring_attention": "ring_attention",
    "sequence_sharded_attention": "ring_attention",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_NAMES[name]}", __name__),
                   name)
