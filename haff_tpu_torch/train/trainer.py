"""Training step (port of haff_tpu/train/trainer.py): the reference's
trainable set, WarmupDecay schedule, global-norm clip + AdamW, gradient
accumulation, one train step.

* The trainable set is the reference's (train_ds.py:192-244): LoRA a/b on
  q/v, embed_tokens, lm_head, both mask decoders and the [SEG] projection
  (and, with `extra=("moe",)`, the MoE layers' experts and routers).
  The port's parameter names mirror the flax scopes, so `partition_params`
  picks it by name and turns `requires_grad` on for it and off for every
  other parameter. It is held in float32 with its AdamW moments (flax
  `param_dtype`) and cast to the model's dtype at use (flax `dtype`); the
  frozen weights stay in the model's dtype, outside autograd.
* With MoE decoder layers the loss gains the Switch load-balance term,
  moe_aux_weight * (sum over the MoE layers) / (their number), as JAX's
  `_forward` adds it, in the train step and the eval step alike.
* The optimizer is optax's `chain(clip_by_global_norm, adamw(schedule))`,
  wrapped in `MultiSteps` for gradient accumulation, written out over
  `torch.optim.AdamW`; parameters are updated in place.
* Under a mesh (core/mesh.py; the model sharded by parallel/sharding.py
  `param_shardings`) a step takes the GLOBAL batch, runs its (data, fsdp)
  rows, and computes its share of the globally normalised loss. Each
  gradient is summed over the ranks that hold the same parameter block
  and divided by the number of them that computed the same rows (a sum
  over the batch shards, an average over replicas), so every replica
  holds the same gradient and takes the same optimizer step; `grad_norm`
  is the norm of the whole, unsharded gradient. With a `pipe` axis > 1
  the decoder runs as a GPipe pipeline (parallel/pipeline.py, JAX's
  `_forward` routing): its stage-local layers keep their gradients to
  their stage, and every pipe rank computes the same rows, so the pipe
  axis is a replica axis for every other parameter.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch import nn

from ..core.config import TrainConfig
from ..core.mesh import (AXES, BATCH_AXES, EXPERT_AXIS, FSDP_AXIS,
                         PIPE_AXIS, TENSOR_AXIS, use_batch_rows, use_mesh)
from ..model.lisa import LisaModel, LisaOutputs, TrainBatch
from ..nn.lora import fold_in

TRAINABLE_KEYS = ("lora_a", "lora_b", "embed_tokens", "lm_head",
                  "mask_decoder_left", "mask_decoder_right", "text_fc1",
                  "text_fc2")


def trainable_mask_path(path: Tuple[str, ...],
                        exclude: Tuple[str, ...] = (),
                        extra: Tuple[str, ...] = ()) -> bool:
    """Reference freezing semantics on one parameter path. `exclude`
    removes keys from the trainable set (the mask decoders, say); `extra`
    adds keys ("image_encoder" to train the SAM encoder)."""
    keys = tuple(k for k in TRAINABLE_KEYS if k not in exclude) + tuple(extra)
    return any(k in path for k in keys)


def partition_params(model: nn.Module, exclude: Tuple[str, ...] = (),
                     extra: Tuple[str, ...] = ()
                     ) -> Tuple[Dict[str, nn.Parameter],
                                Dict[str, nn.Parameter]]:
    """Mark the trainable set and freeze the rest; returns (trainable,
    frozen) name -> parameter.

    This changes `model` in place: requires_grad is set on every
    parameter, and in a model whose dtype is not float32 the trainable
    parameters are converted to float32 and their modules' `compute_dtype`
    is set to the model's dtype, so they are cast back to it at use.

    The SAM image encoder, and the CLIP tower with its projector, run
    with autograd exactly when one of their parameters is trainable
    (`extra=("image_encoder",)`, `("vision_tower",)`, `("mm_projector",)`)."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = trainable_mask_path(tuple(name.split(".")), exclude, extra)
        p.requires_grad_(keep)
        (trainable if keep else frozen)[name] = p
    compute = getattr(model, "dtype", torch.float32)
    for mod in model.modules():
        own = [p for p in mod.parameters(recurse=False) if p.requires_grad]
        if own and compute != torch.float32:
            for p in own:
                p.data = p.data.float()
            mod.compute_dtype = compute
    return trainable, frozen


def count_params(params: Dict[str, torch.Tensor]) -> int:
    """Number of elements in a name -> tensor dict."""
    return sum(int(p.numel()) for p in params.values())


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """WarmupDecayLR: 0 -> lr over warmup_steps, then linear -> 0 at
    total_steps (optax join_schedules of two linear schedules)."""
    warm = cfg.warmup_steps
    decay = max(cfg.total_steps - warm, 1)

    def schedule(count: int) -> float:
        if count < warm:
            return cfg.lr * count / warm
        return cfg.lr * (1.0 - min(max((count - warm) / decay, 0.0), 1.0))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all elements, float32."""
    return torch.stack([t.float().norm() for t in tensors]).norm()


class Optimizer:
    """optax `chain(clip_by_global_norm(max), adamw(schedule, b1, b2,
    eps=1e-8, weight_decay))`, inside `MultiSteps(k)` when k > 1, over
    float32 parameters updated in place.

    * clip: g * max / ||g|| when ||g|| >= max (optax's formula; not
      `clip_grad_norm_`, whose max / (||g|| + 1e-6) differs);
    * the schedule is evaluated at the count of updates already applied,
      so the first update uses schedule(0) (0 with a warmup);
    * MultiSteps: the running mean acc + (g - acc) / (n + 1) of k
      micro-step gradients, applied once every k calls."""

    def __init__(self, cfg: TrainConfig, params: Iterable[torch.Tensor]):
        self.params = list(params)
        # The global norm of a list of gradients (of self.params); a mesh
        # step sets the sharded one.
        self.norm_fn = global_norm
        self.schedule = make_schedule(cfg)
        self.max_norm = cfg.grad_clip_norm
        self.k = cfg.grad_accumulation_steps
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.count = 0        # updates applied (the schedule's count)
        self.mini_step = 0
        self.acc = None

    def update(self, grads, norm=None) -> bool:
        """Take one micro-step's gradients (one per parameter, None for
        none) and, if the caller has it, their global norm (used when k is
        1). Returns whether an update was applied."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
            norm = None
        if norm is None:
            norm = self.norm_fn(grads)
        clip = norm >= self.max_norm
        div = torch.where(clip, norm, torch.ones_like(norm))
        mul = torch.where(clip, torch.full_like(norm, self.max_norm),
                          torch.ones_like(norm))
        for p, g in zip(self.params, grads):
            p.grad = g / div * mul
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor]
                   ) -> Optimizer:
    return Optimizer(cfg, params)


@dataclass
class TrainState:
    step: int
    trainable: Dict[str, nn.Parameter]
    optimizer: Optimizer


def init_train_state(cfg: TrainConfig,
                     trainable: Dict[str, nn.Parameter]) -> TrainState:
    """The state of `trainable` (name -> parameter; the parameters of
    layers another pipeline stage holds are left out)."""
    trainable = {n: p for n, p in trainable.items()
                 if not getattr(p, "_haff_other_stage", False)}
    return TrainState(step=0, trainable=trainable,
                      optimizer=make_optimizer(cfg, trainable.values()))


def _check_supported(model: LisaModel, mesh) -> None:
    """A pipe mesh over a decoder that `param_shardings` did not cut into
    its stages (which is where JAX's composition limits are checked)."""
    if mesh is None or mesh.shape.get(PIPE_AXIS, 1) <= 1:
        return
    if getattr(model.llm, "pipe", None) is None:
        raise ValueError(
            "pipeline-parallel training (a 'pipe' mesh axis > 1) needs the "
            "decoder cut into its stages: parallel.sharding."
            "param_shardings(model, mesh)")


def microbatches(cfg, mesh, batch: int) -> int:
    """The step's GPipe microbatches: `cfg.pp_microbatches`, or JAX's
    `auto_microbatches` of the global batch; each batch shard's rows must
    divide into them."""
    from ..parallel.pipeline import auto_microbatches

    shards = mesh.axis_size(BATCH_AXES)
    nm = getattr(cfg, "pp_microbatches", 0) or auto_microbatches(
        batch, mesh.shape[PIPE_AXIS], shards)
    if (batch // shards) % nm:
        raise ValueError(
            f"a batch shard's {batch // shards} rows do not divide into "
            f"{nm} microbatches (batch {batch} over {shards} data x fsdp "
            "shards); pick --pp_microbatches dividing it")
    return nm


def _forward(model: LisaModel, cfg, mesh, batch, local, seed, remat):
    """model(local), routed through the pipeline engine when the mesh has
    a `pipe` axis > 1 (JAX `_forward`)."""
    if mesh is None or mesh.shape.get(PIPE_AXIS, 1) <= 1:
        return model(local, dropout_seed=seed, remat=remat)
    from ..parallel.pipeline import pipelined_lisa_forward

    nm = microbatches(cfg, mesh, int(batch.input_ids.shape[0]))
    return pipelined_lisa_forward(model, local, num_microbatches=nm,
                                  dropout_seed=seed, remat=remat)


class MeshSync:
    """The collectives a step runs under `mesh` for parameters `params`:
    `grads` completes each gradient (see the module docstring), `norm` is
    the global norm of completed gradients, `metrics` completes per-rank
    loss shares. One rank (mesh None or of size 1): all identities, and
    `norm` is `global_norm`."""

    def __init__(self, mesh, params, rows=None):
        from ..parallel.sharding import placement

        self.mesh, self.rows = mesh, rows
        self.params = list(params)
        self.places = [placement(p) for p in self.params]

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _distinct_rows(self) -> int:
        from ..parallel.sharding import n_batch_shards

        return n_batch_shards(self.mesh, self.rows)

    def grads(self, grads):
        """Sum each gradient over the ranks holding the same block (for an
        fsdp-sharded one the sum over fsdp already ran in its gather's
        backward), then divide by how many of the summed ranks computed the
        same batch rows. One flat buffer per group."""
        from ..parallel.collectives import all_reduce

        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if not self.active:
            return grads
        buckets = {}
        for i, pl in enumerate(self.places):
            own = set()  # the axes the parameter is cut over
            if pl is not None:
                own = {a for a, g in ((TENSOR_AXIS, pl.tp_group),
                                      (EXPERT_AXIS, pl.ep_group),
                                      (PIPE_AXIS, pl.pipe_group))
                       if g is not None}
            summed = tuple(a for a in AXES if a not in own)
            fsdp = pl is not None and pl.fsdp_group is not None
            group = tuple(a for a in summed if not (fsdp and a == FSDP_AXIS))
            buckets.setdefault((summed, group), []).append(i)
        out = list(grads)
        for (summed, group), idx in buckets.items():
            reps = self.mesh.axis_size(summed) // self._distinct_rows()
            flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
            flat = all_reduce(flat, self.mesh.group(group)) / reps
            off = 0
            for i in idx:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view_as(grads[i]).to(grads[i].dtype)
                off += n
        return out

    def norm(self, grads):
        """optax.global_norm of the whole gradient: each rank's sum of
        squares weighted by 1 / (ranks holding the same block), summed over
        the mesh."""
        from ..parallel.collectives import all_reduce
        from ..parallel.sharding import replicas

        if not self.active:
            return global_norm([g for g in grads if g is not None])
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for p, g in zip(self.params, grads):
            if g is not None:
                sq = sq + g.float().square().sum() / replicas(p, self.mesh)
        return all_reduce(sq, self.mesh.group(AXES)).sqrt()

    def metrics(self, values: torch.Tensor) -> torch.Tensor:
        """Global losses from this rank's shares: summed over the mesh,
        divided by the ranks that computed the same rows."""
        from ..parallel.collectives import all_reduce

        if not self.active:
            return values
        reps = self.mesh.size // self._distinct_rows()
        return all_reduce(values.float(), self.mesh.group(AXES)) / reps


def _mesh_context(mesh, batch):
    """(local batch, its BatchRows or None, context manager) for a step
    under `mesh`: the rank's rows of the global batch, with the mesh and
    the rows ambient (the remat recompute in the backward reads them too)."""
    if mesh is None or mesh.size == 1:
        return batch, None, contextlib.nullcontext()
    from ..parallel.sharding import local_train_batch

    local, rows = local_train_batch(mesh, batch)
    stack = contextlib.ExitStack()
    stack.enter_context(use_mesh(mesh))
    stack.enter_context(use_batch_rows(rows))
    return local, rows, stack


_LOSS_NAMES = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
               "taxonomy_ce_loss")


def with_moe_aux(model: LisaModel, out: LisaOutputs) -> LisaOutputs:
    """`out` with the weighted MoE load-balance term added to its loss
    (JAX `_forward`: moe_aux_weight * aux / n_moe); as it is without MoE
    layers."""
    if out.moe_aux is None:
        return out
    weight = model.cfg.llama.moe_aux_weight
    return out._replace(
        loss=out.loss + weight * out.moe_aux / len(model.moe_layers))


def make_train_step(model: LisaModel, cfg: TrainConfig, mesh=None
                    ) -> Callable:
    """Returns step(state, batch, seed) -> (state, metrics): forward with
    LoRA dropout seeded fold_in(seed, state.step) and, with cfg.remat,
    decoder blocks recomputed in the backward; backward into the trainable
    set; one optimizer micro-step. `state` is updated in place. The
    metrics (device tensors) are the JAX step's: loss, ce_loss,
    mask_bce_loss, mask_dice_loss, taxonomy_ce_loss and grad_norm (of this
    micro-step's gradients).

    `mesh` (core/mesh.py, the model sharded over it): `batch` is the global
    batch; the metrics are the global ones, equal on every rank."""
    _check_supported(model, mesh)

    def step(state: TrainState, batch: TrainBatch, seed: int):
        params = list(state.trainable.values())
        for p in params:
            p.grad = None
        local, rows, ctx = _mesh_context(mesh, batch)
        sync = MeshSync(mesh, params, rows)
        with ctx:
            out = with_moe_aux(model, _forward(
                model, cfg, mesh, batch, local, fold_in(seed, state.step),
                cfg.remat))
            out.loss.backward()
        if sync.active:
            grads = sync.grads([p.grad for p in params])
            state.optimizer.norm_fn = sync.norm
        else:
            grads = [p.grad for p in params]
        grad_norm = sync.norm(grads)
        state.optimizer.update(grads, grad_norm)
        state.step += 1
        losses = sync.metrics(torch.stack(
            [getattr(out, k).detach().float() for k in _LOSS_NAMES]))
        metrics = dict(zip(_LOSS_NAMES, losses.unbind()))
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return step


def make_eval_step(model: LisaModel, cfg: TrainConfig = None,
                   mesh=None) -> Callable:
    """Validation forward without gradients and without dropout: returns
    the batch's LisaOutputs (masks, taxonomy, losses). Under `mesh` the
    batch is the global one, and so are the outputs: the global losses,
    and the predictions of every row gathered from the batch shards."""
    _check_supported(model, mesh)

    @torch.no_grad()
    def step(batch: TrainBatch) -> LisaOutputs:
        local, rows, ctx = _mesh_context(mesh, batch)
        with ctx:
            out = with_moe_aux(model, _forward(model, cfg, mesh, batch, local,
                                               None, False))
        if rows is None or not rows.sharded:
            return out
        from ..parallel.collectives import all_gather

        sync = MeshSync(mesh, (), rows)
        losses = sync.metrics(torch.stack(
            [getattr(out, k).float() for k in _LOSS_NAMES]))
        gathered = {k: all_gather(getattr(out, k).contiguous(), rows.group, 0)
                    for k in ("pred_masks_left", "pred_masks_right",
                              "pred_taxonomies")}
        return out._replace(**dict(zip(_LOSS_NAMES, losses.unbind())),
                            **gathered)

    return step
