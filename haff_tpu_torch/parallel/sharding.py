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
  * `expert` — stacked MoE expert weights, E / ep experts a rank (the
    router stays whole: its softmax needs every expert's logit);
  * `pipe`   — GPipe stages: each rank keeps its stage's consecutive
    layers only (parallel/pipeline.py runs them); a model built with
    `mesh=` (`cut_before_init_`) never holds the others, nor other
    ranks' experts;
  * `data`   — pure data parallelism; the batch shards over (data, fsdp).

Quantized (QLoRA) LLaMA layers split their int8 / packed-int4 weights and
scales as the float weights. The MPT decoder declares no partitioning in
JAX and stays replicated but for its pipeline stages. SAM, CLIP, the
projector and the [SEG] head stay replicated, as in JAX.
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

# Stacked MoE expert weights (nn/moe.py): (experts, embed, mlp) for
# gate/up, (experts, mlp, embed) for down, as JAX's logical axes.
MOE_AXES = (
    (r"moe\.(gate|up)_proj", ("experts", EMBED, MLP)),
    (r"moe\.down_proj", ("experts", MLP, EMBED)),
)


def logical_axes(name: str) -> Optional[Tuple]:
    """The logical axes of LLaMA parameter `name`, or None (replicated)."""
    for pattern, axes in PARAM_AXES + MOE_AXES:
        if re.search(r"(^|\.)" + pattern + "$", name):
            return axes
    return None


def mesh_axis(logical) -> Optional[Any]:
    return dict(LOGICAL_RULES).get(logical)


@dataclass
class Placement:
    """How a parameter's tensors on this rank relate to the full one:
    sliced along `tp_dim` into the tensor group's blocks (the full length
    `tp_full`, padded up to a multiple of the group's size) and along
    `ep_dim` into the expert group's blocks (stacked MoE experts), then,
    under fsdp, flattened, padded and cut into the fsdp group's shards of
    a `shape` tensor with `numel` elements. `stage` (a `PipeStage`) is
    set on the layers of one pipeline stage: no other stage of its group
    holds them."""

    tp_dim: Optional[int] = None
    tp_full: int = 0
    tp_group: Any = None
    ep_dim: Optional[int] = None
    ep_full: int = 0
    ep_group: Any = None
    fsdp_group: Any = None
    numel: int = 0
    shape: Tuple[int, ...] = ()
    stage: Any = None

    @property
    def pipe_group(self):
        return None if self.stage is None else self.stage.group

    @property
    def shards(self) -> int:
        """How many distinct blocks the full tensor is cut into."""
        return (C.group_size(self.tp_group) * C.group_size(self.ep_group)
                * C.group_size(self.fsdp_group))

    def _cuts(self):
        return [(d, n, g) for d, n, g in ((self.tp_dim, self.tp_full,
                                           self.tp_group),
                                          (self.ep_dim, self.ep_full,
                                           self.ep_group)) if g is not None]


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
    or an AdamW moment) gathered to the full layout of its pipeline stage.
    Every rank of the groups takes part."""
    if pl is None or t is None or t.ndim == 0:
        return t
    if pl.fsdp_group is not None:
        t = C.all_gather(t.reshape(-1), pl.fsdp_group, 0)[:pl.numel]
        t = t.view(pl.shape)
    for dim, full, group in pl._cuts():
        t = C.all_gather(t.contiguous(), group, dim).narrow(dim, 0, full)
    return t


def _cut(t, dim, full, group):
    n = C.group_size(group)
    c = -(-full // n)
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, c * n - full]
    return torch.nn.functional.pad(t, pad).narrow(
        dim, C.group_rank(group) * c, c)


def _flat_shard(t, group):
    n = C.group_size(group)
    flat = t.reshape(-1)
    c = -(-flat.numel() // n)
    flat = torch.nn.functional.pad(flat, (0, c * n - flat.numel()))
    return flat[C.group_rank(group) * c:][:c]


def local_tensor(full, pl: Optional[Placement]):
    """The inverse of `full_tensor`: this rank's block of a full tensor."""
    if pl is None or full is None or full.ndim == 0:
        return full
    t = full
    for dim, n, group in pl._cuts():
        t = _cut(t, dim, n, group)
    if pl.fsdp_group is not None:
        t = _flat_shard(t, pl.fsdp_group)
    return t.clone()


def _slice_(module, name: str, mesh: Mesh, dim: int, axis: str):
    """Keep this rank's block of `module.<name>` (a parameter or buffer)
    along `dim` over the `axis` group."""
    t = getattr(module, name)
    group = mesh.group(axis)
    if axis == TENSOR_AXIS:
        pl = _set_placement(t, tp_dim=dim, tp_full=t.shape[dim],
                            tp_group=group)
    else:
        pl = _set_placement(t, ep_dim=dim, ep_full=t.shape[dim],
                            ep_group=group)
    with torch.no_grad():
        t.data = _cut(t.data, dim, t.shape[dim], group).clone()
    return pl


def _shard_fsdp_unit_(module, mesh: Mesh):
    """Keep every parameter of `module` (and every quantized weight and
    scale buffer of its QDense layers) as its flat fsdp shard, and gather
    them for each call (inside an activation checkpoint, again for the
    recompute). Parameters gather through `FsdpGather` (their gradient is
    reduce-scattered), buffers by a plain all-gather."""
    group = mesh.group(FSDP_AXIS)
    params = dict(module.named_parameters())
    buffers = {n: b for n, b in module.named_buffers()
               if n.rsplit(".", 1)[-1] in ("weight", "scale")}
    for t in (*params.values(), *buffers.values()):
        _set_placement(t, fsdp_group=group, numel=t.numel(),
                       shape=tuple(t.shape))
        with torch.no_grad():
            t.data = _flat_shard(t.data, group).clone()
    orig = type(module).forward
    active = []

    def forward(*args, **kwargs):
        if active:  # inside functional_call: the gathered weights are bound
            return orig(module, *args, **kwargs)
        full = {n: C.FsdpGather.apply(p, group, placement(p).numel,
                                      placement(p).shape)
                for n, p in module.named_parameters()}
        for n, b in module.named_buffers():
            pl = placement(b)
            if pl is not None:
                full[n] = C.all_gather(b, group, 0)[:pl.numel].view(pl.shape)
        active.append(True)
        try:
            return torch.func.functional_call(module, full, args, kwargs)
        finally:
            active.pop()

    module.forward = forward


def _decoder(model):
    return getattr(model, "llm", model)


class OtherStage(torch.nn.Module):
    """The place of a decoder layer that another pipeline stage holds.
    `shadow` is that layer on the meta device, kept unregistered: its
    parameters' names and shapes, which the seeded init draws for
    (model/lisa.py `init_random_`) so that the kept layers get the values
    of a whole-model build."""

    def __init__(self, index: int, stage: int, shadow: torch.nn.Module):
        super().__init__()
        self.index, self.stage = index, stage
        self.__dict__["shadow"] = shadow

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            f"decoder layer {self.index} lives on pipeline stage "
            f"{self.stage}; a pipe-sharded decoder runs through "
            "parallel/pipeline.py")


@dataclass
class PipeStage:
    """A decoder's pipeline stage on this rank: layers [lo, hi) of
    `num_layers`, stage `stage` of `stages`, the pipe group and its global
    ranks in stage order, and the names (from the module that was
    sharded) of the parameters the other stages hold."""

    stage: int
    stages: int
    lo: int
    hi: int
    num_layers: int
    group: Any
    ranks: Tuple[int, ...]
    elsewhere: frozenset = frozenset()

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1


def _layers(llm):
    """The decoder's per-layer ModuleList: LLaMA `model.layers`, MPT
    `blocks`."""
    return llm.blocks if hasattr(llm, "blocks") else llm.model.layers


MOE_PIPE = ("MoE decoder layers + pipeline parallelism are not "
            "composed: the GPipe engine stacks per-layer params and "
            "moe_every != 1 makes layer trees heterogeneous; run MoE "
            "with dp/fsdp/ep/tensor instead")


def check_shardable(model, mesh: Mesh) -> None:
    """JAX's composition limits, checked here once for every path that
    cuts a model: a pipe axis > 1 takes neither MoE layers (the trainer's
    message) nor sequence-parallel attention (pipeline.py's), and its size
    must divide the layers."""
    if mesh.shape[PIPE_AXIS] <= 1:
        return
    from .pipeline import PIPE_SP, check_stages

    llm = _decoder(model)
    cfg = getattr(llm, "cfg", None)
    if getattr(cfg, "moe_num_experts", 0) > 0:
        raise NotImplementedError(MOE_PIPE)
    if getattr(cfg, "sequence_parallel", False):
        raise ValueError(PIPE_SP)
    check_stages(len(_layers(llm)), mesh.shape[PIPE_AXIS])


def _stage_bounds(n: int, mesh: Mesh):
    lps = n // mesh.shape[PIPE_AXIS]
    stage = mesh.coords[PIPE_AXIS]
    return lps, stage * lps, (stage + 1) * lps


def cut_before_init_(model, mesh: Mesh) -> None:
    """Cut a model whose weights do not exist yet (built on the meta
    device) to what this rank keeps of it, so that neither its build nor
    its init holds the rest: the decoder layers of other pipeline stages
    become `OtherStage` places, and each MoE MLP keeps its E / ep experts
    (`expert_start` on). `param_shardings` later completes the cut."""
    check_shardable(model, mesh)
    llm = _decoder(model)
    layers = _layers(llm)
    if mesh.shape[PIPE_AXIS] > 1:
        lps, lo, hi = _stage_bounds(len(layers), mesh)
        for i in range(len(layers)):
            if not lo <= i < hi:
                layers[i] = OtherStage(i, i // lps, layers[i])
    ep = mesh.shape[EXPERT_AXIS]
    if ep > 1:
        from ..nn.moe import MoEMLP

        for mod in llm.modules():
            if isinstance(mod, MoEMLP):
                E = _experts(mod, ep)
                for name in ("gate_proj", "up_proj", "down_proj"):
                    p = getattr(mod, name)
                    setattr(mod, name, torch.nn.Parameter(
                        p.new_empty((E // ep,) + tuple(p.shape[1:])),
                        requires_grad=p.requires_grad))
                mod.expert_start = mesh.coord(EXPERT_AXIS) * (E // ep)


def held_elsewhere(root) -> frozenset:
    """The names (from `root`) of the parameters that `OtherStage` places
    stand for: what other pipeline stages hold."""
    return frozenset(f"{n}.{p}" for n, m in root.named_modules()
                     if isinstance(m, OtherStage)
                     for p, _ in m.shadow.named_parameters())


def rank_state_dict(model, sd) -> dict:
    """A whole-model state dict cut to what `model` holds after
    `cut_before_init_`: without the other stages' layers, and each MoE
    MLP's experts from its `expert_start`."""
    from ..nn.moe import MoEMLP

    elsewhere = held_elsewhere(model)
    out = {k: v for k, v in sd.items() if k not in elsewhere}
    for n, mod in model.named_modules():
        if isinstance(mod, MoEMLP):
            for name in ("gate_proj", "up_proj", "down_proj"):
                k, count = f"{n}.{name}", getattr(mod, name).shape[0]
                if k in out:
                    out[k] = out[k].narrow(0, mod.expert_start, count)
    return out


def _shard_pipe_(root, llm, mesh: Mesh) -> None:
    """Keep only this rank's pipeline stage of the decoder's layers: the
    others become `OtherStage` places (their weights freed, unless
    `cut_before_init_` never made them), and the stage's parameters are
    marked stage-local."""
    layers = _layers(llm)
    n = len(layers)
    lps, lo, hi = _stage_bounds(n, mesh)
    group = mesh.group(PIPE_AXIS)
    for i in range(n):
        if lo <= i < hi or isinstance(layers[i], OtherStage):
            continue
        held = list(layers[i].parameters())
        layers[i] = OtherStage(i, i // lps, layers[i].to("meta"))
        for p in held:  # the references a trainable set may keep
            p._haff_other_stage = True  # dropped by init_train_state
            p.data = p.data.new_empty(0)
    llm.pipe = PipeStage(mesh.coords[PIPE_AXIS], mesh.shape[PIPE_AXIS], lo,
                         hi, n, group, tuple(mesh.group_ranks(PIPE_AXIS)),
                         held_elsewhere(root))
    for i in range(lo, hi):
        for p in layers[i].parameters():
            _set_placement(p, stage=llm.pipe)


def _shard_quantized_tp_(layer, mesh: Mesh, dim: int) -> None:
    """A quantized QDense's int8 or packed-int4 weight and its scales,
    column- (dim 0) or row-parallel (dim 1). Row-parallel int4 keeps each
    scale group whole; row-parallel int8 quantizes its activations with the
    amax over the tensor group (nn/quant.int8_matmul `amax_group`)."""
    t = mesh.shape[TENSOR_AXIS]
    int4 = layer.weight.dtype == torch.uint8
    if dim == 1 and int4:
        group = layer.in_features // layer.scale.shape[1]
        if (layer.in_features // t) % group:
            raise ValueError(
                f"row-parallel int4 weight: K / tensor = "
                f"{layer.in_features} / {t} is not a multiple of the "
                f"quantization group {group}")
    _slice_(layer, "weight", mesh, dim, TENSOR_AXIS)
    if dim == 0 or int4:
        _slice_(layer, "scale", mesh, dim, TENSOR_AXIS)
    if dim == 1 and not int4:
        layer.amax_group = mesh.group(TENSOR_AXIS)


def _shard_tensor_(llm, mesh: Mesh) -> None:
    from ..nn.layers import QDense
    from ..nn.lora import LoraDense

    cfg = llm.cfg
    t = mesh.shape[TENSOR_AXIS]
    for what, size in (("num_heads", cfg.num_heads),
                       ("num_kv_heads", cfg.num_kv_heads),
                       ("intermediate_size", cfg.intermediate_size)):
        if size % t:
            raise ValueError(f"{what} {size} does not divide the "
                             f"'tensor' axis of size {t}")
    group = mesh.group(TENSOR_AXIS)
    named = list(llm.named_parameters()) + [
        (n, b) for n, b in llm.named_buffers() if n.endswith(".weight")]
    for name, p in named:
        axes = logical_axes(name)
        dims = [i for i, a in enumerate(axes or ())
                if mesh_axis(a) == TENSOR_AXIS]
        if not dims or "experts" in axes:  # shard_moe_ cuts the experts
            continue
        owner, pname = name.rsplit(".", 1)
        mod = llm.get_submodule(owner)
        if isinstance(mod, QDense) and mod.quantized:
            _shard_quantized_tp_(mod, mesh, dims[0])
        else:
            _slice_(mod, pname, mesh, dims[0], TENSOR_AXIS)
        if isinstance(mod, QDense):
            if dims[0] == 0:
                mod.out_features = mod.weight.shape[0]
            else:
                mod.in_features //= t
    rows = -(-cfg.vocab_size // t)
    llm.tp_group = group
    llm.embed_tokens.tp_group = group
    llm.embed_tokens.vocab_start = mesh.coord(TENSOR_AXIS) * rows
    for layer in llm.model.layers:
        if isinstance(layer, OtherStage):
            continue
        attn = layer.self_attn
        attn.tp_group = group
        attn.num_heads = cfg.num_heads // t
        attn.num_kv_heads = cfg.num_kv_heads // t
        if not layer.is_moe:
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


def _experts(mod, ep: int) -> int:
    E = mod.cfg.moe_num_experts
    if E % ep:
        raise ValueError(f"moe_num_experts {E} does not divide the "
                         f"'expert' axis of size {ep}")
    return E


def shard_moe_(mod, mesh: Mesh) -> None:
    """An MoE MLP's stacked experts (nn/moe.py) over the mesh: E / ep
    experts a rank (dim 0) and each expert's mlp width over the tensor
    axis (gate/up columns, down rows), as JAX's (experts, embed, mlp)
    axes. The router stays whole (its softmax needs every logit)."""
    ep, t = mesh.shape[EXPERT_AXIS], mesh.shape[TENSOR_AXIS]
    E = _experts(mod, ep)
    for name in ("gate_proj", "up_proj", "down_proj"):
        axes = logical_axes("moe." + name)
        if t > 1:
            _slice_(mod, name, mesh, axes.index(MLP), TENSOR_AXIS)
        if ep > 1 and getattr(mod, name).shape[0] == E:
            _slice_(mod, name, mesh, 0, EXPERT_AXIS)
        elif ep > 1:  # cut before its weights existed
            _set_placement(getattr(mod, name), ep_dim=0, ep_full=E,
                           ep_group=mesh.group(EXPERT_AXIS))
    mod.tp_group = mesh.group(TENSOR_AXIS)
    mod.ep_group = mesh.group(EXPERT_AXIS)
    mod.expert_start = mesh.coord(EXPERT_AXIS) * (E // ep)


def param_shardings(model, mesh: Mesh):
    """Shard the decoder of `model` (a LisaModel, a LlamaForCausalLM or an
    MptForCausalLM) over `mesh` in place, as LOGICAL_RULES lay it out:
    pipeline stages first (a pipe axis > 1 keeps this rank's layers only),
    then tensor-parallel slices, expert slices, and fsdp's flat shards.
    Quantized LLaMA layers split their int8 / packed-int4 weights with
    their scales. The MPT decoder declares no partitioning in JAX, so only
    its pipeline stages are cut: its weights stay replicated over the
    other axes. The rest of the model stays replicated. Returns `model`."""
    from ..nn.llama import LlamaForCausalLM

    check_shardable(model, mesh)
    llm = _decoder(model)
    if mesh.shape[PIPE_AXIS] > 1:
        _shard_pipe_(model, llm, mesh)
    if not isinstance(llm, LlamaForCausalLM):
        return model
    if mesh.shape[TENSOR_AXIS] > 1:
        _shard_tensor_(llm, mesh)
    from ..nn.moe import MoEMLP

    for mod in llm.modules():
        if isinstance(mod, MoEMLP):
            shard_moe_(mod, mesh)
    if mesh.shape[FSDP_AXIS] > 1:
        for unit in (llm.embed_tokens, *llm.model.layers, llm.model.norm,
                     llm.lm_head):
            if not isinstance(unit, OtherStage):
                _shard_fsdp_unit_(unit, mesh)
    return model


def replicas(p, mesh: Mesh) -> int:
    """How many ranks of the mesh hold the same block of parameter `p`."""
    pl = placement(p)
    if pl is None:
        return mesh.size
    stages = mesh.shape[PIPE_AXIS] if pl.pipe_group is not None else 1
    return mesh.size // (pl.shards * stages)


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
