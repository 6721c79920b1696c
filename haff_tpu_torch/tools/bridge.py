"""Carry JAX parameters into the port, and the port's back out.

Two sources:

* a JAX parameter tree: the nested dict of arrays that
  `jax.jit(LisaModel.init)` gives (optionally under a "params" key), with
  array leaves (unbox flax partitioning metadata first);
* the flat `.npz` that haff_tpu/tools/export_params.py writes: keys are
  "/"-joined paths; a "::bf16" suffix marks a bfloat16 bit pattern stored
  as uint16, which `load_npz` widens to float32 with numpy alone.

`flax_to_state_dict` maps each leaf to the port's state_dict name and
layout: `layers_N` / `blocks_N` / `hyper_mlps_N` scopes become list
indices; Dense kernels (in, out) become Linear weights (out, in); Conv
kernels HWIO become OIHW; flax ConvTranspose(transpose_kernel=True)
kernels (kh, kw, out, in) become ConvTranspose2d weights (in, out, kh,
kw) (the inverse of haff_tpu/tools/convert_weights.py t_convT);
LayerNorm `scale` and Embed `embedding` become `weight`. An MPT decoder's
tree (`llm/blocks_i/{norm_1, attn/Wqkv, attn/out_proj, norm_2, up_proj,
down_proj}`, `llm/wte/embedding`, `llm/norm_f/scale`) maps by the same
rules.

A tree that `quantize_dense_tree` made loads too: a Dense scope with an
int8 `kernel` (in, out) and `scale` (out,), or a packed uint8 `kernel`
(in/2, out) and `scale` (in/group, out), becomes the quantized `QDense`
buffers `weight` (out, in) / (out, in/2) and `scale` (out,) /
(out, in/group), integer dtypes kept.

The inverse, `state_dict_to_flax`, gives a float model's JAX tree from
its modules' types (a Linear's `weight` is a Dense `kernel`, a
LayerNorm's a `scale`, an embedding's an `embedding`); `save_npz` writes a tree as
the flat export `.npz` (bfloat16 as "::bf16" uint16 bit patterns,
rounded to nearest even), which haff_tpu's `load_exported_params` and
`load_npz` read.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(layers|blocks|hyper_mlps)_(\d+)$")
_INDEX_OF = re.compile(r"^(layers|blocks|hyper_mlps)\.(\d+)(?=\.|$)")


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def load_npz(path: str) -> Dict:
    """Flat export .npz -> nested dict of float32/int numpy arrays."""
    flat = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if key.endswith("::bf16"):
                key = key[: -len("::bf16")]
                arr = widen_bf16(arr)
            elif arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            flat[key] = arr
    return unflatten_tree(flat)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(path, dense_scale: bool = False) -> str:
    """`dense_scale`: the leaf is the `scale` beside a quantized Dense
    `kernel` (kept as `scale`), not a LayerNorm's (which is its weight)."""
    *scopes, leaf = path
    names = []
    for s in scopes:
        m = _INDEXED.match(s)
        names.append(f"{m.group(1)}.{m.group(2)}" if m else s)
    if leaf in ("kernel", "embedding") or (leaf == "scale"
                                           and not dense_scale):
        leaf = "weight"
    return ".".join(names + [leaf])


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LisaModel parameter tree -> the port's LisaModel state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    leaves = dict(_flatten(params))
    sd = {}
    for path, value in leaves.items():
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        dense_scale = (path[-1] == "scale"
                       and path[:-1] + ("kernel",) in leaves)
        if path[-1] == "kernel" or (dense_scale and arr.ndim == 2):
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"kernel {'/'.join(path)} of rank {arr.ndim}")
        sd[_torch_name(path, dense_scale)] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd


def load_jax_params(model: torch.nn.Module, params,
                    scope: str = None) -> torch.nn.Module:
    """Load a JAX parameter tree, or the path of an export .npz, into the
    port's model (strict: every parameter must be matched): a `LisaModel`
    from a `LisaModel.init` tree, a `Sam` from a `Sam.init` tree, or, with
    `scope="visual_model"`, a `Sam` from the subtree of that name in a
    whole-model tree or export. A `QDense` whose weight arrives quantized
    (int8 or packed uint8, with its `scale`) is switched to its quantized
    form first."""
    if isinstance(params, str):
        params = load_npz(params)
    if set(params) == {"params"}:
        params = params["params"]
    if scope is not None:
        params = params[scope]
    sd = flax_to_state_dict(params)
    modules = dict(model.named_modules())
    for name, scale in sd.items():
        prefix, _, leaf = name.rpartition(".")
        weight = sd.get(prefix + ".weight")
        mod = modules.get(prefix)
        if (leaf == "scale" and weight is not None
                and not weight.dtype.is_floating_point
                and hasattr(mod, "set_quantized_")):
            dev = mod.weight.device
            mod.set_quantized_(weight.to(dev), scale.to(dev))
    model.load_state_dict(sd, strict=True)
    return model


def _leaf_name(module) -> str:
    """The JAX leaf name of a module's `weight`."""
    from torch import nn

    from ..nn.layers import ChannelLayerNorm, LayerNorm

    if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
        return "kernel"
    if isinstance(module, nn.Embedding):
        return "embedding"
    if (isinstance(module, (LayerNorm, nn.LayerNorm))
            and not isinstance(module, ChannelLayerNorm)):
        return "scale"
    return "weight"  # SAM's LayerNorm2d and LLaMA's RMSNorm: `weight` in JAX


def flax_path(name: str, module) -> tuple:
    """The JAX path of state_dict entry `name` whose owner is `module`."""
    prefix, _, leaf = name.rpartition(".")
    scopes = []
    rest = prefix
    while rest:
        m = _INDEX_OF.match(rest)
        if m:
            scopes.append(f"{m.group(1)}_{m.group(2)}")
            rest = rest[m.end():].lstrip(".")
        else:
            head, _, rest = rest.partition(".")
            scopes.append(head)
    if leaf == "weight":
        leaf = _leaf_name(module)
    return tuple(scopes) + (leaf,)


def to_flax_array(tensor: torch.Tensor, leaf: str) -> np.ndarray:
    """A port tensor in its JAX layout, float32 for floats: a kernel (out,
    in) -> (in, out), OIHW (or ConvTranspose (in, out, kh, kw)) -> the
    JAX kernel (the inverse of `flax_to_state_dict`)."""
    t = tensor.detach().cpu()
    if not t.dtype.is_floating_point:
        raise TypeError("state_dict_to_flax: a quantized model; export the "
                        "float model")
    arr = t.float().numpy()
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
    return np.ascontiguousarray(arr)


def state_dict_to_flax(model: torch.nn.Module,
                       state_dict: Mapping[str, torch.Tensor] = None) -> Dict:
    """The JAX parameter tree (nested dicts of float32 numpy arrays) of a
    float model: its own state_dict, or `state_dict` (entries named as
    the model's) mapped through the model's module types."""
    modules = dict(model.named_modules())
    if state_dict is None:
        state_dict = model.state_dict()
    tree: Dict = {}
    for name, tensor in state_dict.items():
        path = flax_path(name, modules[name.rpartition(".")[0]])
        node = tree
        for s in path[:-1]:
            node = node.setdefault(s, {})
        node[path[-1]] = to_flax_array(tensor, path[-1])
    return tree


def flatten_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """Nested tree -> {"a/b/c": array}."""
    return {"/".join(path): np.asarray(v) for path, v in _flatten(tree)}


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def save_npz(tree: Mapping, out: str, dtype: str = "bfloat16") -> int:
    """Write a tree as the flat export .npz (haff_tpu/tools/export_params.py
    layout, compressed): float leaves as "::bf16" bit patterns when
    `dtype` is "bfloat16", else float32; other leaves as they are.
    Returns the number of arrays."""
    import os

    flat = {}
    for key, arr in flatten_tree(tree).items():
        if np.issubdtype(arr.dtype, np.floating) and dtype == "bfloat16":
            flat[key + "::bf16"] = bf16_bits(arr)
        elif np.issubdtype(arr.dtype, np.floating):
            flat[key] = arr.astype(np.float32)
        else:
            flat[key] = arr
    os.makedirs(os.path.dirname(os.path.abspath(out)) or ".", exist_ok=True)
    np.savez_compressed(out, **flat)
    return len(flat)
