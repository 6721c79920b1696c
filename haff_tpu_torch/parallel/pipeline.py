"""Pipeline parallelism — GPipe over the `pipe` mesh axis (port of
haff_tpu/parallel/pipeline.py).

The decoder's layers are cut into `pipe` stages of consecutive layers;
each pipe rank builds and holds its own stage only (parallel/sharding.py
`cut_before_init_`, `param_shardings`), which is what lets a 7b decoder
fit beside three others on one card. A batch is split into microbatches
that stream stage to stage.

Where JAX runs one `lax.scan` of `microbatches + stages - 1` ticks inside
a `shard_map` and lets autodiff transpose it, the port runs the same
ticks eagerly in every rank and writes the transposes out:

  * forward: at tick t stage s runs microbatch t - s through its layers;
    after each tick every rank of the pipe group passes its microbatch
    (the activations and the `carried` extras, positions and segment ids,
    that travel with it) one stage on through `collectives.ppermute_tensors`.
    A stage with no microbatch at a tick sends zeros and computes nothing
    (JAX computes its warm-up and drain bubbles on zeros; the numbers are
    the same, and each stage launches its kernels exactly microbatches x
    layers times);
  * the last stage's result is sent to every pipe rank (JAX's `psum` of
    the masked result), so every rank computes the same loss. Its
    transpose takes the last stage's own cotangent, not the sum over the
    pipe ranks (each rank's loss is the whole loss, not a share of it);
  * backward: the ticks in reverse, each stage recomputing its layers on
    the saved microbatch input (remat, as `jax.checkpoint(...,
    nothing_saveable)`: nothing of the forward is kept but the stage's
    inputs), backpropagating the cotangent the next stage sent, and
    passing its input's cotangent one stage back; without remat the
    forward's graphs are kept instead. The stage's parameters receive
    their gradients here, stage-local;
  * the input's cotangent, which stage 0 ends with, is sent to every pipe
    rank (the mirror of the broadcast), so the replicated parameters
    before the pipeline (the embedding, the projector) get the same
    gradient on every pipe rank, and those after it (the final norm,
    lm_head, the [SEG] head and mask decoders) do too: the trainer then
    treats the pipe axis as a replica axis for them.

LoRA dropout inside a stage draws its masks over the global batch shape
(nn/lora.py), with the microbatch's first row as its offset, so a
pipelined run keeps the one-process masks. (JAX's pipeline folds the
stage and tick into its keys instead.)

Composition limits (JAX's, checked where a model is cut:
parallel/sharding.py `check_shardable`): no sequence-parallel ring
attention and no MoE layers under a pipe axis.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

from ..core.mesh import BatchRows, current_batch_rows, use_batch_rows
from . import collectives as C

PIPE_SP = ("pipeline parallelism cannot be combined with "
           "sequence_parallel ring attention (both are manual around "
           "the attention kernel); use pp x tp x dp instead")


def check_stages(num_layers: int, stages: int) -> None:
    """JAX's refusal of a pipe axis that does not divide the layers."""
    if num_layers % stages != 0:
        raise ValueError(
            f"num_layers {num_layers} not divisible by pipe={stages}")


def _stem(prefix: str) -> str:
    """JAX's per-layer scope prefix ("layers_", "blocks_") as the torch
    name stem ("layers.", "blocks.")."""
    return prefix[:-1] + "." if prefix.endswith("_") else prefix


def stack_layer_params(params: Mapping[str, torch.Tensor], num_layers: int,
                       prefix: str = "layers_") -> dict:
    """`{"layers.0.<rest>": t, ..., "layers.{n-1}.<rest>": t}` (a state
    dict's per-layer names; other names are ignored) -> `{"<rest>":
    stacked}` with every tensor stacked on a new leading (num_layers,)
    dim. `prefix` is JAX's per-layer naming ("layers_" LLaMA, "blocks_"
    MPT); every layer must hold the same names and shapes."""
    stem = _stem(prefix)
    layers = []
    for i in range(num_layers):
        head = f"{stem}{i}."
        layer = {k[len(head):]: v for k, v in params.items()
                 if k.startswith(head)}
        if not layer:
            raise KeyError(f"{prefix}{i}")
        layers.append(layer)
    names = list(layers[0])
    for i, layer in enumerate(layers):
        if list(layer) != names:
            raise ValueError(f"{prefix}{i} holds {sorted(layer)}, "
                             f"{prefix}0 {sorted(names)}")
    return {n: torch.stack([layer[n] for layer in layers]) for n in names}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor],
                         num_layers: int, prefix: str = "layers_") -> dict:
    """Inverse of stack_layer_params."""
    stem = _stem(prefix)
    return {f"{stem}{i}.{n}": t[i] for i in range(num_layers)
            for n, t in stacked.items()}


def auto_microbatches(batch: int, stages: int, shards: int = 1) -> int:
    """Largest divisor of `batch` at most 2*stages — keeps the GPipe
    bubble (stages-1)/(nm+stages-1) around a third or better when the
    batch allows, degrading gracefully for small batches. `shards` is
    the data*fsdp batch-shard count: microbatch sizes that still divide
    it are preferred, so every tick keeps the data axis fully busy."""
    target = min(batch, 2 * stages)
    fallback = 1
    for nm in range(target, 0, -1):
        if batch % nm:
            continue
        if (batch // nm) % shards == 0:
            return nm
        if fallback == 1:
            fallback = nm  # largest plain divisor, if none fits shards
    return fallback


class _Schedule:
    """The GPipe ticks of one stage: `block_fn(i, x, *extras) -> x` over
    this stage's layer indices, on microbatches of `carried`."""

    def __init__(self, block_fn, stage, carried, num_microbatches, remat):
        self.block_fn, self.pipe = block_fn, stage
        self.nm, self.remat = num_microbatches, remat
        b = int(carried[0].shape[0])
        self.mb = b // num_microbatches
        rows = current_batch_rows()
        # Dropout draws over the global batch: microbatch m's first row.
        if rows is not None and rows.sharded:
            self.base, self.total, self.group = rows.offset, rows.total, \
                rows.group
        else:
            self.base, self.total, self.group = 0, b, None
        self.template = [torch.zeros((self.mb,) + tuple(c.shape[1:]),
                                     dtype=c.dtype, device=c.device)
                         for c in carried]

    def ticks(self) -> int:
        return self.nm + self.pipe.stages - 1

    def run_stage(self, state, m):
        rows = BatchRows(self.base + m * self.mb, self.total, True,
                         self.group)
        x, extras = state[0], state[1:]
        with use_batch_rows(rows):
            for i in range(self.pipe.lo, self.pipe.hi):
                x = self.block_fn(i, x, *extras)
        return x

    def _pass(self, payload, shift):
        p = self.pipe
        return C.ppermute_tensors(payload, p.group, p.ranks, shift)

    def forward(self, carried, keep_graph: bool):
        """Returns the stage's saved inputs, the kept graphs (input leaf,
        output) when `keep_graph`, and the whole batch's output on every
        pipe rank."""
        p, s = self.pipe, self.pipe.stage
        micro = [tuple(c[m * self.mb:(m + 1) * self.mb] for c in carried)
                 for m in range(self.nm)]
        inputs, graphs, outs = [None] * self.nm, [None] * self.nm, []
        recv = None
        for t in range(self.ticks()):
            m = t - s
            sent = self.template
            if 0 <= m < self.nm:
                state = micro[m] if p.first else tuple(recv)
                inputs[m] = state
                if keep_graph:
                    with torch.enable_grad():
                        leaf = state[0].detach().requires_grad_(True)
                        y = self.run_stage((leaf,) + tuple(state[1:]), m)
                    graphs[m] = (leaf, y)
                    y = y.detach()
                else:
                    y = self.run_stage(state, m)
                if p.last:
                    outs.append(y)
                sent = [y, *state[1:]]
            if t < self.ticks() - 1:
                recv = self._pass(sent, 1)
        out = (torch.cat(outs) if p.last else torch.zeros(
            (self.nm * self.mb,) + tuple(carried[0].shape[1:]),
            dtype=carried[0].dtype, device=carried[0].device))
        return inputs, graphs, C.broadcast_from(out, p.group, p.ranks[-1])

    def backward(self, grad_out, inputs, graphs):
        """The reverse ticks; returns the input's cotangent on every pipe
        rank. The stage's parameters accumulate their gradients."""
        p, s = self.pipe, self.pipe.stage
        dxs, recv = [], None
        zeros = self.template[0]
        for u in range(self.ticks()):
            m = u - (p.stages - 1 - s)
            sent = zeros
            if 0 <= m < self.nm:
                g = (grad_out[m * self.mb:(m + 1) * self.mb] if p.last
                     else recv)
                if graphs[m] is not None:
                    leaf, y = graphs[m]
                    graphs[m] = None
                else:
                    state = inputs[m]
                    with torch.enable_grad():
                        leaf = state[0].detach().requires_grad_(True)
                        y = self.run_stage((leaf,) + tuple(state[1:]), m)
                torch.autograd.backward(y, g.to(y.dtype))
                sent = leaf.grad.to(zeros.dtype)
                if p.first:
                    dxs.append(sent)
            if u < self.ticks() - 1:
                recv = self._pass([sent], -1)[0]
        dx = (torch.cat(dxs) if p.first else
              torch.zeros((self.nm * self.mb,) + tuple(zeros.shape[1:]),
                          dtype=zeros.dtype, device=zeros.device))
        return C.broadcast_from(dx, p.group, p.ranks[0])


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, anchor, *carried):
        inputs, graphs, out = sched.forward(carried,
                                            keep_graph=not sched.remat)
        ctx.sched, ctx.inputs, ctx.graphs = sched, inputs, graphs
        ctx.n_extra = len(carried) - 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        dx = ctx.sched.backward(grad_out.contiguous(), ctx.inputs,
                                ctx.graphs)
        ctx.inputs = ctx.graphs = None
        return (None, None, dx) + (None,) * ctx.n_extra


def pipeline_blocks(block_fn: Callable, stage, carried: Sequence[torch.Tensor],
                    *, num_microbatches: int, remat: bool = True,
                    params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run a stack of identical blocks as a GPipe pipeline.

    block_fn(i, x, *extras) -> new x runs decoder layer i. `stage` is the
    decoder's `PipeStage` (parallel/sharding.py): this rank runs layers
    [stage.lo, stage.hi). `carried` is `(x, *extras)`: every element has a
    leading batch dim that is split into `num_microbatches`; only `x` is
    transformed, the extras (positions, segment ids, ...) travel with
    their microbatch. Returns the transformed x, batch-ordered, on every
    pipe rank. Differentiable in x and in `params` (the stage's
    parameters that require grad, whose gradients accumulate in the
    backward) when grad mode is on; `remat` recomputes the stage's layers
    in the backward."""
    check_stages(stage.num_layers, stage.stages)
    batch = int(carried[0].shape[0])
    if batch % num_microbatches != 0:
        raise ValueError(
            f"batch {batch} not divisible by "
            f"num_microbatches={num_microbatches}")
    sched = _Schedule(block_fn, stage, carried, num_microbatches, remat)
    grad = torch.is_grad_enabled() and (
        carried[0].requires_grad or any(p.requires_grad for p in params))
    if not grad:
        with torch.no_grad():
            return sched.forward(tuple(carried), keep_graph=False)[2]
    # The anchor makes the backward run where only the stage's parameters
    # need gradients; every pipe rank agrees on it (one model).
    anchor = torch.zeros((), device=carried[0].device, requires_grad=True)
    return _Pipeline.apply(sched, anchor, *carried)


# ---------------------------------------------------------------------------
# LLaMA / MPT / LISA composition
# ---------------------------------------------------------------------------


def _trainable(layers, stage):
    return [p for i in range(stage.lo, stage.hi)
            for p in layers[i].parameters() if p.requires_grad]


def pipelined_llm_forward(llm, inputs_embeds, positions, segment_ids=None, *,
                          num_microbatches: int, dropout_seed=None,
                          remat: bool = True):
    """LlamaForCausalLM.forward semantics (logits, hidden) with the decoder
    blocks run as a pipeline over the pipe-sharded `llm`. No KV cache:
    training and the validation forward (`pipelined_decode` serves the
    cached decode)."""
    from ..nn.llama import rope_table
    from ..nn.lora import fold_in

    cfg = llm.cfg
    stage = llm.pipe
    layers = llm.model.layers
    x = inputs_embeds.to(llm.model.norm.weight.dtype)
    table = rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                       device=x.device)
    positions = positions.long()
    if segment_ids is None:
        segment_ids = torch.ones(positions.shape, dtype=torch.int32,
                                 device=x.device)

    def block_fn(i, x, rope, seg):
        seed = None if dropout_seed is None else fold_in(dropout_seed, i)
        return layers[i](x, rope, table, seg, None, None, None, seed)[0]

    x = pipeline_blocks(
        block_fn, stage,
        (x, positions.clamp(max=cfg.max_seq_len - 1), segment_ids),
        num_microbatches=num_microbatches, remat=remat,
        params=_trainable(layers, stage))
    hidden = llm.model.norm(x)
    return llm.logits(hidden), hidden


def pipelined_mpt_forward(mpt, inputs_embeds, segment_ids=None, *,
                          num_microbatches: int, remat: bool = True):
    """MptForCausalLM.forward semantics (logits, hidden) with the blocks
    pipelined (ALiBi as the flash kernel's bias in each stage)."""
    stage = mpt.pipe
    dtype = mpt.norm_f.weight.dtype
    x = inputs_embeds.to(dtype)
    slopes = mpt.slopes(x.device)
    if segment_ids is None:
        segment_ids = torch.ones(x.shape[:2], dtype=torch.int32,
                                 device=x.device)

    def block_fn(i, x, seg):
        return mpt.blocks[i](x, slopes, seg)[0]

    x = pipeline_blocks(block_fn, stage, (x, segment_ids),
                        num_microbatches=num_microbatches, remat=remat,
                        params=_trainable(mpt.blocks, stage))
    hidden = mpt.norm_f(x).to(dtype)
    return F.linear(hidden, mpt.wte.weight.to(dtype)), hidden


def pipelined_lisa_forward(model, batch, *, num_microbatches: int,
                           dropout_seed=None, remat: bool = False):
    """LisaModel.forward with the decoder pipelined (splice_inputs ->
    pipelined blocks -> finish_outputs); returns LisaOutputs. Both decoder
    families route through the engine."""
    sam_emb, sp = model.splice_inputs(batch, remat)
    if model.cfg.decoder == "mpt":
        logits, hidden = pipelined_mpt_forward(
            model.llm, sp.embeds, sp.segment_ids,
            num_microbatches=num_microbatches, remat=remat)
    else:
        logits, hidden = pipelined_llm_forward(
            model.llm, sp.embeds, sp.positions, sp.segment_ids,
            num_microbatches=num_microbatches, dropout_seed=dropout_seed,
            remat=remat)
    return model.finish_outputs(batch, sam_emb, sp, logits, hidden)


def pipelined_decode(llm, inputs_embeds, positions, segment_ids=None,
                     kv_caches=None, cache_index=None,
                     cache_kv_segment_ids=None):
    """The decoder's cached call (prefill or one decode step; the
    `llm_fn` of infer/generate.py) over a pipe-sharded `llm`: the hidden
    state passes stage to stage, each stage writing and reading the KV
    caches of its own layers (`kv_caches[i]` for i in the stage; the
    others may be None), and the last stage's result goes to every pipe
    rank, so every rank computes the same logits and picks the same
    token. Returns (logits, hidden, kv_caches)."""
    stage = llm.pipe
    dtype = (llm.norm_f if hasattr(llm, "blocks") else llm.model.norm
             ).weight.dtype
    x = inputs_embeds.to(dtype)
    if hasattr(llm, "blocks"):
        slopes = llm.slopes(x.device)

        def block_fn(i, x):
            y, kv_caches[i] = llm.blocks[i](
                x, slopes, segment_ids, kv_caches[i], cache_index,
                cache_kv_segment_ids)
            return y
    else:
        from ..nn.llama import rope_table

        cfg = llm.cfg
        table = rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                           device=x.device)
        positions = positions.long()
        rope = positions.clamp(max=cfg.max_seq_len - 1)

        def block_fn(i, x):
            y, kv_caches[i], _ = llm.model.layers[i](
                x, rope, table, segment_ids, kv_caches[i], cache_index,
                cache_kv_segment_ids, None, positions)
            return y

    x = pipeline_blocks(block_fn, stage, (x,), num_microbatches=1,
                        remat=False)
    if hasattr(llm, "blocks"):
        hidden = llm.norm_f(x).to(dtype)
        return F.linear(hidden, llm.wte.weight.to(dtype)), hidden, kv_caches
    hidden = llm.model.norm(x)
    return llm.logits(hidden), hidden, kv_caches

