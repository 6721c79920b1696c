"""Sharding rules (port of haff_tpu/parallel/sharding.py) — the
replacement for DeepSpeed ZeRO-2 + NCCL (reference train_ds.py:344-393).

The JAX package annotates parameters with logical axis names and lets
GSPMD lay them out. The port's parameter names mirror the flax scopes, so
`PARAM_AXES` gives each LLaMA parameter's logical axes (per dim of the
torch tensor, whose Linear weights are (out, in)), and `LOGICAL_RULES`
maps them to mesh axes as JAX does:

  * `tensor` — Megatron tensor parallelism: q/k/v and gate/up are
    column-parallel (with their LoRA B), o/down row-parallel (with their
    LoRA A), embedding and lm_head vocab-parallel;
  * `fsdp`   — every LLaMA parameter, and with it its optimizer state, is
    kept as a flat 1/fsdp shard and all-gathered per unit (a decoder block,
    the embedding, the final norm, the lm_head) where it is used: JAX
    shards the `embed` dim over fsdp, the port takes FSDP's flat shards;
  * `data`   — pure data parallelism; the batch shards over (data, fsdp).

SAM, CLIP, the projector and the [SEG] head stay replicated, as in JAX.
`param_shardings(model, mesh)` applies this in place; each sharded
parameter records its `Placement`, from which `full_tensor` /
`local_tensor` convert its tensors (and its AdamW moments) between the
rank's layout and the full one (checkpoints).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..core.mesh import (BATCH_AXES, DATA_AXIS, EXPERT_AXIS, FSDP_AXIS,
                         PIPE_AXIS, TENSOR_AXIS, BatchRows, Mesh)
from ..nn.llama import EMBED, HEADS, KV_HEADS, MLP, VOCAB
from . import collectives as C

# logical name -> mesh axis (None = replicated)
LOGICAL_RULES = (
    ("batch", (DATA_AXIS, FSDP_AXIS)),
    (VOCAB, TENSOR_AXIS),
    (EMBED, FSDP_AXIS),
    (HEADS, TENSOR_AXIS),
    (KV_HEADS, TENSOR_AXIS),
    (MLP, TENSOR_AXIS),
    ("experts", EXPERT_AXIS),  # stacked MoE expert weights (nn/moe.py)
    ("head_dim", None),
)

# LLaMA parameter (name suffix under `llm.`) -> logical axes of its torch
# dims. LoRA A/B carry no axes in JAX (replicated there); the port slices
# the one on the sharded side of a tensor-parallel product.
PARAM_AXES = (
    (r"embed_tokens\.weight", (VOCAB, EMBED)),
    (r"lm_head\.weight", (VOCAB, EMBED)),
    (r"(input_layernorm|post_attention_layernorm|norm)\.weight", (EMBED,)),
    (r"self_attn\.q_proj\.(base\.)?weight", (HEADS, EMBED)),
    (r"self_attn\.(k|v)_proj\.(base\.)?weight", (KV_HEADS, EMBED)),
    (r"self_attn\.o_proj\.(base\.)?weight", (EMBED, HEADS)),
    (r"self_attn\.q_proj\.lora_b", (None, HEADS)),
    (r"self_attn\.(k|v)_proj\.lora_b", (None, KV_HEADS)),
    (r"self_attn\.(q|k|v)_proj\.lora_a", (EMBED, None)),
    (r"self_attn\.o_proj\.lora_a", (HEADS, None)),
    (r"self_attn\.o_proj\.lora_b", (None, EMBED)),
    (r"mlp\.(gate|up)_proj\.weight", (MLP, EMBED)),
    (r"mlp\.down_proj\.weight", (EMBED, MLP)),
)

_NOT_PORTED = "not ported yet (slice 18)"


def logical_axes(name: str) -> Optional[Tuple]:
    """The logical axes of LLaMA parameter `name`, or None (replicated)."""
    for pattern, axes in PARAM_AXES:
        if re.search(r"(^|\.)" + pattern + "$", name):
            return axes
    return None


def mesh_axis(logical) -> Optional[Any]:
    return dict(LOGICAL_RULES).get(logical)


@dataclass
class Placement:
    """How a parameter's tensors on this rank relate to the full one:
    sliced along `tp_dim` into the tensor group's blocks (the full length
    `tp_full`, padded up to a multiple of the group's size), then, under
    fsdp, flattened, padded and cut into the fsdp group's shards of a
    `shape` tensor with `numel` elements."""

    tp_dim: Optional[int] = None
    tp_full: int = 0
    tp_group: Any = None
    fsdp_group: Any = None
    numel: int = 0
    shape: Tuple[int, ...] = ()

    @property
    def shards(self) -> int:
        """How many distinct blocks the full tensor is cut into."""
        return C.group_size(self.tp_group) * C.group_size(self.fsdp_group)


def placement(p) -> Optional[Placement]:
    return getattr(p, "_haff_placement", None)


def _set_placement(p, **kw):
    pl = placement(p) or Placement()
    for k, v in kw.items():
        setattr(pl, k, v)
    p._haff_placement = pl
    return pl


def full_tensor(t, pl: Optional[Placement]):
    """A tensor in a parameter's local layout (the parameter, its gradient
    or an AdamW moment) gathered to the full layout. Every rank of the
    groups takes part."""
    if pl is None or t is None or t.ndim == 0:
        return t
    if pl.fsdp_group is not None:
        t = C.all_gather(t.reshape(-1), pl.fsdp_group, 0)[:pl.numel]
        t = t.view(pl.shape)
    if pl.tp_group is not None:
        t = C.all_gather(t.contiguous(), pl.tp_group, pl.tp_dim)
        t = t.narrow(pl.tp_dim, 0, pl.tp_full)
    return t


def local_tensor(full, pl: Optional[Placement]):
    """The inverse of `full_tensor`: this rank's block of a full tensor."""
    if pl is None or full is None or full.ndim == 0:
        return full
    t = full
    if pl.tp_group is not None:
        n = C.group_size(pl.tp_group)
        c = -(-pl.tp_full // n)
        pad = [0, 0] * (t.ndim - 1 - pl.tp_dim) + [0, c * n - pl.tp_full]
        t = torch.nn.functional.pad(t, pad).narrow(
            pl.tp_dim, C.group_rank(pl.tp_group) * c, c)
    if pl.fsdp_group is not None:
        n = C.group_size(pl.fsdp_group)
        flat = t.reshape(-1)
        c = -(-flat.numel() // n)
        flat = torch.nn.functional.pad(flat, (0, c * n - flat.numel()))
        t = flat[C.group_rank(pl.fsdp_group) * c:][:c]
    return t.clone()


def _shard_tp_(module, pname: str, dim: int, mesh: Mesh):
    p = getattr(module, pname)
    pl = _set_placement(p, tp_dim=dim, tp_full=p.shape[dim],
                        tp_group=mesh.group(TENSOR_AXIS))
    with torch.no_grad():
        p.data = local_tensor(p.data, pl)


def _shard_fsdp_unit_(module, mesh: Mesh):
    """Keep every parameter of `module` as its flat fsdp shard, and gather
    them for each call (inside an activation checkpoint, again for the
    recompute)."""
    group = mesh.group(FSDP_AXIS)
    params = dict(module.named_parameters())
    for p in params.values():
        pl = _set_placement(p, fsdp_group=group, numel=p.numel(),
                            shape=tuple(p.shape))
        with torch.no_grad():
            tp, pl.tp_group = pl.tp_group, None  # already TP-local
            p.data = local_tensor(p.data, pl)
            pl.tp_group = tp
    orig = type(module).forward
    active = []

    def forward(*args, **kwargs):
        if active:  # inside functional_call: the gathered weights are bound
            return orig(module, *args, **kwargs)
        full = {n: C.FsdpGather.apply(p, group, placement(p).numel,
                                      placement(p).shape)
                for n, p in module.named_parameters()}
        active.append(True)
        try:
            return torch.func.functional_call(module, full, args, kwargs)
        finally:
            active.pop()

    module.forward = forward


def _decoder(model):
    return getattr(model, "llm", model)


def check_shardable(model, mesh: Mesh) -> None:
    """Raise for what the port does not shard yet (slice 18): a pipe or
    expert axis > 1, MoE layers or the MPT decoder under any mesh of more
    than one rank, quantized layers under fsdp or tensor."""
    from ..nn.layers import QDense
    from ..nn.llama import LlamaForCausalLM

    for axis in (PIPE_AXIS, EXPERT_AXIS):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f"a '{axis}' mesh axis > 1 is {_NOT_PORTED}")
    if mesh.size == 1:
        return
    llm = _decoder(model)
    if getattr(model, "moe_layers", ()) or getattr(
            getattr(llm, "cfg", None), "moe_num_experts", 0):
        raise NotImplementedError(f"MoE layers under a mesh are {_NOT_PORTED}")
    if mesh.shape[TENSOR_AXIS] * mesh.shape[FSDP_AXIS] == 1:
        return
    if not isinstance(llm, LlamaForCausalLM):
        raise NotImplementedError(
            f"the MPT decoder under fsdp/tensor is {_NOT_PORTED}")
    if any(isinstance(m, QDense) and m.quantized for m in llm.modules()):
        raise NotImplementedError(
            f"quantized layers under fsdp/tensor are {_NOT_PORTED}")


def param_shardings(model, mesh: Mesh):
    """Shard the LLaMA decoder of `model` (a LisaModel or a
    LlamaForCausalLM) over `mesh` in place, as LOGICAL_RULES lay it out:
    tensor-parallel slices first, then fsdp's flat shards. The rest of the
    model stays replicated. Returns `model`."""
    from ..nn.lora import LoraDense

    check_shardable(model, mesh)
    t, f = mesh.shape[TENSOR_AXIS], mesh.shape[FSDP_AXIS]
    if t * f == 1:
        return model
    llm = _decoder(model)
    cfg = llm.cfg
    if t > 1:
        for what, size in (("num_heads", cfg.num_heads),
                           ("num_kv_heads", cfg.num_kv_heads),
                           ("intermediate_size", cfg.intermediate_size)):
            if size % t:
                raise ValueError(f"{what} {size} does not divide the "
                                 f"'tensor' axis of size {t}")
        group = mesh.group(TENSOR_AXIS)
        for name, p in list(llm.named_parameters()):
            axes = logical_axes(name)
            dims = [i for i, a in enumerate(axes or ())
                    if mesh_axis(a) == TENSOR_AXIS]
            if dims:
                owner, pname = name.rsplit(".", 1)
                _shard_tp_(llm.get_submodule(owner), pname, dims[0], mesh)
        rows = -(-cfg.vocab_size // t)
        llm.tp_group = group
        llm.embed_tokens.tp_group = group
        llm.embed_tokens.vocab_start = mesh.coord(TENSOR_AXIS) * rows
        for layer in llm.model.layers:
            attn = layer.self_attn
            attn.tp_group = group
            attn.num_heads = cfg.num_heads // t
            attn.num_kv_heads = cfg.num_kv_heads // t
            layer.mlp.tp_group = group
            for pname in ("q_proj", "k_proj", "v_proj", "o_proj"):
                proj = getattr(attn, pname)
                if isinstance(proj, LoraDense):
                    proj.tp_group = group
                    proj.tp_mode = "row" if pname == "o_proj" else "column"
                    if pname == "o_proj":
                        width = cfg.num_heads * cfg.head_dim // t
                        proj.in_cols = (mesh.coord(TENSOR_AXIS) * width,
                                        cfg.num_heads * cfg.head_dim)
    if f > 1:
        for unit in (llm.embed_tokens, *llm.model.layers, llm.model.norm,
                     llm.lm_head):
            _shard_fsdp_unit_(unit, mesh)
    return model


def replicas(p, mesh: Mesh) -> int:
    """How many ranks of the mesh hold the same block of parameter `p`."""
    pl = placement(p)
    return mesh.size // (pl.shards if pl is not None else 1)


def batch_sharding(mesh: Mesh) -> Tuple[str, ...]:
    """The axes a batch's leading dim shards over (JAX
    `NamedSharding(mesh, P((data, fsdp)))`)."""
    return BATCH_AXES


def replicated(mesh: Mesh) -> Tuple[str, ...]:
    return ()


def shard_batch_tree(mesh: Mesh, batch) -> Any:
    """This rank's part of every tensor in a batch tree: its (data, fsdp)
    block of the leading (batch) axis; tensors whose leading dim does not
    divide the batch shards (e.g. a unique-image table smaller than the
    conversation batch) are replicated.

    Replication is only a legitimate fallback for tensors SMALLER than the
    shard count (the unique-image table case). A leading dim >= n_shards
    that does not divide evenly means a mis-sized batch — a silent
    fully-replicated "sharded" run — so that is an error."""
    n_shards = mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]
    me = mesh.coord(BATCH_AXES)

    def place(x):
        ndim = getattr(x, "ndim", 0)
        if n_shards == 1 or ndim < 1:
            return x
        if x.shape[0] % n_shards == 0:
            c = x.shape[0] // n_shards
            return x[me * c:(me + 1) * c]
        if x.shape[0] >= n_shards:
            raise ValueError(
                f"batch leading dim {x.shape[0]} does not divide "
                f"{n_shards} batch shards (mesh data*fsdp); pad the "
                f"batch or adjust the mesh instead of silently "
                f"replicating")
        return x

    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch_tree(mesh, x) for x in batch))
    if isinstance(batch, dict):
        return {k: shard_batch_tree(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch_tree(mesh, x) for x in batch)
    return place(batch)


def local_train_batch(mesh: Mesh, batch):
    """A TrainBatch's part on this rank (`shard_batch_tree`) with its
    `image_index` pointing into the rank's own image rows when the image
    table was sharded too, and the rows it holds (`BatchRows`)."""
    local = shard_batch_tree(mesh, batch)
    b = int(batch.input_ids.shape[0])
    n = mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]
    sharded = n > 1 and local.input_ids.shape[0] != b
    if not sharded:
        return local, BatchRows(0, b)
    me = mesh.coord(BATCH_AXES)
    images = int(batch.images_sam.shape[0])
    if local.images_sam.shape[0] != images:
        first = me * (images // n)
        index = local.image_index.long() - first
        if bool(((index < 0) | (index >= images // n)).any()):
            raise ValueError(
                "conversation rows index images of another batch shard; "
                "keep the image table whole (smaller than data*fsdp) or "
                "give each shard its own images")
        local = local._replace(image_index=index.to(batch.image_index.dtype))
    c = b // n
    return local, BatchRows(me * c, b, True, mesh.group(BATCH_AXES))


def n_batch_shards(mesh: Mesh, rows: BatchRows) -> int:
    return mesh.axis_size(BATCH_AXES) if rows.sharded else 1
