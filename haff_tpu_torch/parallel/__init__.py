"""Mesh parallelism (port of haff_tpu/parallel): sharding rules, ring
attention and the autograd-aware collectives they run on. The GPipe
pipeline (`pipeline_blocks`, `pipelined_*_forward`) is not ported yet.

The names resolve at first use, so that nn/llama.py can import
parallel/collectives.py while parallel/sharding.py imports nn/llama.py.
"""

import importlib

_NAMES = {
    "LOGICAL_RULES": "sharding",
    "batch_sharding": "sharding",
    "param_shardings": "sharding",
    "shard_batch_tree": "sharding",
    "ring_attention": "ring_attention",
    "sequence_sharded_attention": "ring_attention",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_NAMES[name]}", __name__),
                   name)
