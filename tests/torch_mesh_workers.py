"""Rank processes for the port's mesh tests (tests/test_torch_mesh.py,
test_torch_ring_attention.py, test_torch_sharded_llama.py,
test_torch_sharded_train.py, test_torch_train_cli_mesh.py, and the
pipeline / expert / QLoRA / validation tests of test_torch_gpipe*.py,
test_torch_moe_mesh.py, test_torch_qlora_mesh.py and
test_torch_mesh_validate.py).

`run_ranks(case, payload, world, workdir)` (or `Ranks(...)`, joined
later, so the parent can compute its references meanwhile) starts `world`
processes of this file, each joining a gloo process group over a `file://` store in
`workdir` (60 s timeout on every collective), runs `CASES[case](payload,
rank, world)` and returns every rank's result. A rank process imports only
torch, numpy and haff_tpu_torch (never this directory's conftest, which
imports JAX), and runs on one CPU thread. The parent waits with a
deadline, then kills the ranks and fails.

Run directly: python tests/torch_mesh_workers.py CASE RANK WORLD WORKDIR
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    """`world` rank processes of `case` started on `payload`; `join()`
    waits for them (at most `timeout` s from the start) and returns their
    results in rank order, or kills them and fails."""

    def __init__(self, case, payload, world, workdir, timeout=150):
        self.case, self.world, self.workdir = case, world, str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        torch.save(payload, os.path.join(self.workdir, "payload.pt"))
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                  "LOCAL_RANK"):
            env.pop(k, None)
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(os.path.join(self.workdir, f"rank{r}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(r),
                 str(world), self.workdir], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def join(self):
        procs, case = self.procs, self.case
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > self.deadline:
                    raise AssertionError(
                        f"{case}: ranks still running after {self.timeout} "
                        f"s; killed\n" + _tails(self.workdir, self.world))
                if any(p.poll() not in (None, 0) for p in procs):
                    time.sleep(2)  # let the others report, then stop them
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in self.logs:
                log.close()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"{case}: rank exit codes "
                                 f"{[p.returncode for p in procs]}\n"
                                 + _tails(self.workdir, self.world))
        return [torch.load(os.path.join(self.workdir, f"out{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def run_ranks(case, payload, world, workdir, timeout=150):
    """Run `case` in `world` gloo ranks; returns their results, rank order."""
    return Ranks(case, payload, world, workdir, timeout).join()


def _tails(workdir, world):
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            out.append(f"--- rank {r}\n" + f.read()[-3000:])
    return "\n".join(out)


# ----------------------------------------------------------- the cases


def _mesh(**kw):
    from haff_tpu_torch.core.config import MeshConfig
    from haff_tpu_torch.core.mesh import build_mesh

    return build_mesh(MeshConfig(**kw))


def case_mesh(payload, rank, world):
    """build_mesh's coordinates and groups, shard_batch_tree's blocks, the
    collectives' transposes, broadcast_from in float32, bf16 and fp16, and
    maybe_initialize_distributed as a no-op."""
    from haff_tpu_torch.core import mesh as M
    from haff_tpu_torch.parallel import collectives as C
    from haff_tpu_torch.parallel.sharding import shard_batch_tree

    out = {}
    M.maybe_initialize_distributed("cpu")  # a group exists: no-op
    out["still_gloo"] = torch.distributed.get_backend()
    mesh = _mesh(data=-1, fsdp=2)
    out["shape"] = dict(mesh.shape)
    out["coords"] = dict(mesh.coords)
    out["batch_ranks"] = mesh.group_ranks(M.BATCH_AXES)
    x = torch.arange(8.0).reshape(4, 2)
    table = torch.arange(3.0)
    tree = {"x": x, "table": table, "scalar": torch.tensor(1.0)}
    out["local"] = shard_batch_tree(mesh, tree)
    try:
        shard_batch_tree(mesh, {"bad": torch.zeros(6)})
    except ValueError as e:
        out["error"] = str(e)
    # transposes: a replicated input through each Function, loss summed
    grp = mesh.group(M.BATCH_AXES)
    t = torch.arange(8.0, requires_grad=True)
    y = C.gather_from_shard(C.slice_to_shard(t, grp, 0), grp, 0)
    (y * torch.arange(8.0)).sum().backward()
    out["slice_gather_grad"] = t.grad.clone()
    t.grad = None
    C.reduce_from_tp(t, grp).sum().backward()      # partials -> replicated
    out["reduce_grad"] = t.grad.clone()
    t.grad = None
    (C.copy_to_tp(t, grp) * (rank + 1)).sum().backward()  # -> partials
    out["copy_grad"] = t.grad.clone()
    t = torch.full((3,), float(rank), requires_grad=True)
    C.ppermute(t, grp, mesh.group_ranks(M.BATCH_AXES)).sum().backward()
    out["ppermute"] = C.ppermute(t.detach(), grp,
                                 mesh.group_ranks(M.BATCH_AXES))
    out["ppermute_grad"] = t.grad.clone()
    # broadcast_from: rank 2's bytes in every dtype the pipeline sends
    out["broadcast"] = {
        str(dt): C.broadcast_from(torch.arange(5.0).to(dt) / 3 + rank, grp,
                                  2) for dt in (torch.float32,
                                                torch.bfloat16,
                                                torch.float16)}
    return out


def case_ring(payload, rank, world):
    """sequence_sharded_attention on each case's mesh: out and grads of
    sum(out * g) for q, k, v, and the chunk relations this rank ran."""
    from haff_tpu_torch.parallel import ring_attention as R

    meshes = {m: _mesh(**dict(m)) for m in payload["meshes"]}
    results = []
    for c in payload["cases"]:
        mesh = meshes[c["mesh"]]
        R.RELATIONS.clear()
        q, k, v = (c[n].clone().requires_grad_(True) for n in "qkv")
        out = R.sequence_sharded_attention(
            mesh, "sp", q, k, v, q_segment_ids=c.get("seg"),
            causal=c["causal"], batch_axes=c.get("batch_axes"),
            heads_axis=c.get("heads_axis"))
        w = c.get("weight")
        loss = (out * c["g"] * (1.0 if w is None else w)).sum()
        loss.backward()
        results.append(dict(out=out.detach(), dq=q.grad, dk=k.grad,
                            dv=v.grad, relations=dict(R.RELATIONS)))
    return results


def case_ring_cuda(payload, rank, world):
    """The ring on cuda:0 shared by the ranks (sp = world), causal, bf16:
    gathered out and grads of sum(out * g * valid), this rank's launches."""
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.parallel.ring_attention import \
        sequence_sharded_attention

    torch.cuda.set_device(0)
    mesh = _mesh(data=1, sp=world)
    q, k, v = (payload[n].cuda().requires_grad_(True) for n in "qkv")
    seg = payload["seg"].cuda()
    valid = (seg != 0)[:, :, None, None]
    _build.LAUNCHES.clear()
    out = sequence_sharded_attention(mesh, "sp", q, k, v, q_segment_ids=seg,
                                     causal=True)
    (out.float() * payload["g"].cuda().float() * valid).sum().backward()
    torch.cuda.synchronize()
    return dict(out=out.detach().cpu(), dq=q.grad.cpu(), dk=k.grad.cpu(),
                dv=v.grad.cpu(), device=str(out.device),
                launches={k: n for k, n in _build.LAUNCHES.items() if n})


def case_llama(payload, rank, world):
    """LlamaForCausalLM (sequence_parallel) sharded over each mesh: full
    logits, and the gradients of sum(logits * g) for the embeddings and,
    gathered to the full layout, every parameter."""
    import dataclasses

    from haff_tpu_torch.core.config import LlamaConfig
    from haff_tpu_torch.core.mesh import use_mesh
    from haff_tpu_torch.nn.llama import LlamaForCausalLM
    from haff_tpu_torch.parallel.sharding import (full_tensor,
                                                  param_shardings, placement)

    cfg = dataclasses.replace(LlamaConfig(**payload["cfg"]),
                              sequence_parallel=True)
    results = []
    for m in payload["meshes"]:
        mesh = _mesh(**dict(m))
        model = LlamaForCausalLM(cfg)
        model.load_state_dict(payload["sd"])
        param_shardings(model, mesh)
        emb = payload["embeds"].clone().requires_grad_(True)
        with use_mesh(mesh):
            logits, hidden, _ = model(emb, payload["pos"], payload["seg"],
                                      remat=payload.get("remat", False))
            (logits * payload["g"]).sum().backward()
        grads = {n: full_tensor(p.grad, placement(p))
                 for n, p in model.named_parameters()}
        results.append(dict(logits=logits.detach(), hidden=hidden.detach(),
                            d_embeds=emb.grad, grads=grads))
    return results


def _lisa(payload, run):
    """The run's LisaModel (its "llama" fields, "decoder", "sd" or the
    payload's weights), its trainable set (with "extra"), its frozen
    LLaMA projections quantized with "bits" (group 16)."""
    import dataclasses

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.nn.quant import default_llm_predicate, quantize_model_
    from haff_tpu_torch.train import trainer as T
    from haff_tpu_torch.train.cli import frozen_predicate

    base = ModelConfig.preset(payload["preset"])
    cfg = base.replace(decoder=run.get("decoder", "llama"),
                       llama=dataclasses.replace(base.llama, **run["llama"]))
    model = LisaModel(cfg, torch.float32, device="cpu")
    model.load_state_dict(run.get("sd", payload.get("sd")))
    trainable, frozen = T.partition_params(model,
                                           extra=tuple(run.get("extra", ())))
    if run.get("bits"):
        quantize_model_(model, frozen_predicate(set(frozen),
                                                default_llm_predicate),
                        bits=run["bits"], group=16)
    return cfg, model, trainable


def case_train(payload, rank, world):
    """Train steps of the tiny LisaModel (its LlamaConfig fields replaced
    by each run's "llama") sharded over the meshes of the run's "plan" from
    the same weights and global batches: each step's metrics and completed
    gradients (full layout), then the full trainable tensors and the eval
    step's outputs on the first batch. A plan of several meshes
    checkpoints after each part and resumes from it under the next mesh."""
    from haff_tpu_torch.core.config import TrainConfig
    from haff_tpu_torch.model.lisa import TrainBatch
    from haff_tpu_torch.parallel.sharding import (full_tensor,
                                                  param_shardings, placement)
    from haff_tpu_torch.train import checkpoints as CK
    from haff_tpu_torch.train import trainer as T

    batches = [TrainBatch(*b).to("cpu") for b in payload["batches"]]
    results = []
    for run in payload["runs"]:
        metrics, ckpt = [], None
        for part, (mesh_kw, steps) in enumerate(run["plan"]):
            mesh = _mesh(**dict(mesh_kw))
            cfg, model, trainable = _lisa(payload, run)
            param_shardings(model, mesh)
            tcfg = TrainConfig(model=cfg, **payload["tcfg"])
            state = T.init_train_state(tcfg, trainable)
            if ckpt is not None:
                state, _ = CK.restore_checkpoint(ckpt, state)
            step = T.make_train_step(model, tcfg, mesh)
            update, grads = state.optimizer.update, []

            def record(g, norm=None, update=update):
                grads.append({n: full_tensor(t, placement(p)) for (n, p), t
                              in zip(state.trainable.items(), g)})
                return update(g, norm)

            state.optimizer.update = record
            for i in steps:
                state, m = step(state, batches[i], payload["seed"])
                metrics.append({k: float(v) for k, v in m.items()})
            all_grads = all_grads + grads if part else grads
            if part + 1 < len(run["plan"]):
                ckpt = os.path.join(payload["workdir"], f"ckpt{len(results)}")
                CK.save_checkpoint(ckpt, int(state.step), state)
        full = {n: full_tensor(p.detach(), placement(p))
                for n, p in state.trainable.items()}
        ev = T.make_eval_step(model, tcfg, mesh)(batches[0])
        evaluated = {k: getattr(ev, k).detach() for k in (
            "loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
            "taxonomy_ce_loss", "pred_masks_left", "pred_masks_right",
            "pred_taxonomies")}
        results.append(dict(metrics=metrics, trainable=full,
                            grads=all_grads, eval=evaluated,
                            ckpt=ckpt))
    return results


def case_cli(payload, rank, world):
    """haff_tpu_torch.train.cli.main in every rank: each run's per-step
    metrics, start step, checkpoints and its parameters' devices; then the
    SystemExit message of each argv in "exits"."""
    from haff_tpu_torch.train import cli

    out = []
    for argv in payload["argvs"]:
        run = cli.main(argv)
        out.append(dict(steps=run.steps, start_step=run.start_step,
                        checkpoints=run.checkpoints,
                        validations=run.validations,
                        devices=sorted({str(p.device) for p in
                                        run.model.parameters()})))
    exits = []
    for argv in payload.get("exits", ()):
        try:
            cli.main(argv)
            exits.append(None)
        except SystemExit as e:
            exits.append(str(e))
    return dict(runs=out, exits=exits)


def case_gpipe(payload, rank, world):
    """A decoder (payload "kind": "llama" or "mpt", its config fields and
    state dict) pipelined over each mesh: logits and hidden of
    pipelined_llm_forward / pipelined_mpt_forward on the global
    embeddings, and (with "grad") the gradients of mean(logits^2) in the
    full layout of this rank's pipeline stage, and of the embeddings."""
    from haff_tpu_torch.core.config import LlamaConfig
    from haff_tpu_torch.core.mesh import use_mesh
    from haff_tpu_torch.nn.llama import LlamaForCausalLM
    from haff_tpu_torch.nn.mpt import MptConfig, MptForCausalLM
    from haff_tpu_torch.parallel import pipeline as P
    from haff_tpu_torch.parallel.sharding import (full_tensor,
                                                  param_shardings, placement)

    from haff_tpu_torch.kernels import _build

    device = payload.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
    results = []
    for m in payload["meshes"]:
        mesh = _mesh(**dict(m))
        if payload["kind"] == "mpt":
            model = MptForCausalLM(MptConfig(**payload["cfg"]))
        else:
            model = LlamaForCausalLM(LlamaConfig(**payload["cfg"]))
        model.load_state_dict(payload["sd"])
        model.to(device)
        param_shardings(model, mesh)
        emb = payload["embeds"].to(device).clone().requires_grad_(
            payload["grad"])
        seg = payload["seg"].to(device)
        nm = payload["microbatches"]
        _build.LAUNCHES.clear()
        with use_mesh(mesh):
            if payload["kind"] == "mpt":
                logits, hidden = P.pipelined_mpt_forward(
                    model, emb, seg, num_microbatches=nm)
            else:
                logits, hidden = P.pipelined_llm_forward(
                    model, emb, payload["pos"].to(device), seg,
                    num_microbatches=nm)
            res = dict(logits=logits.detach().cpu(),
                       hidden=hidden.detach().cpu(),
                       stage=(model.pipe.lo, model.pipe.hi),
                       device=str(logits.device))
            if payload["grad"]:
                logits.float().square().mean().backward()
                res["d_embeds"] = emb.grad.cpu()
                res["grads"] = {n: None if p.grad is None else
                                full_tensor(p.grad, placement(p)).cpu()
                                for n, p in model.named_parameters()
                                if p.numel()}
        res["launches"] = {k: n for k, n in _build.LAUNCHES.items() if n}
        results.append(res)
    return results


def case_moe(payload, rank, world):
    """An MoEMLP (payload "cfg" fields, "sd") sharded over each mesh with
    shard_moe_, on this rank's (data, fsdp) rows of the global x (and
    token mask) with the rows ambient: the global y (rows gathered), the
    aux shares summed over the batch shards, and the gradients of
    sum(y^2) + aux summed over the batch shards, in the full layout."""
    from haff_tpu_torch.core.config import LlamaConfig
    from haff_tpu_torch.core.mesh import BATCH_AXES, BatchRows, use_batch_rows
    from haff_tpu_torch.nn.moe import MoEMLP
    from haff_tpu_torch.parallel import collectives as C
    from haff_tpu_torch.parallel.sharding import (full_tensor, placement,
                                                  shard_moe_)

    cfg = LlamaConfig(**payload["cfg"])
    results = []
    for m in payload["meshes"]:
        mesh = _mesh(**dict(m))
        mod = MoEMLP(cfg)
        mod.load_state_dict(payload["sd"])
        shard_moe_(mod, mesh)
        group = mesh.group(BATCH_AXES)
        x, mask = payload["x"], payload.get("mask")
        n = mesh.axis_size(BATCH_AXES)
        c = x.shape[0] // n
        me = mesh.coord(BATCH_AXES)
        xl = x[me * c:(me + 1) * c].clone().requires_grad_(True)
        ml = None if mask is None else mask[me * c:(me + 1) * c]
        with use_batch_rows(BatchRows(me * c, x.shape[0], n > 1, group)):
            y, aux = mod(xl, ml)
        (y.square().sum() + aux).backward()
        grads = {name: full_tensor(C.all_reduce(p.grad, group), placement(p))
                 for name, p in mod.named_parameters()}
        results.append(dict(
            y=C.all_gather(y.detach(), group, 0),
            aux=C.all_reduce(aux.detach(), group),
            dx=C.all_gather(xl.grad, group, 0), grads=grads))
    return results


def case_amax(payload, rank, world):
    """The row-parallel W8A8 product over a tensor group of `world` ranks
    (on payload "device", cuda:0 shared by the ranks or the CPU): each
    rank's K slice of x and of the int8 weight, quantized with the global
    amax and summed (reduce_from_tp), and quantized with its own slice's
    amax; with the all-reduces and the kernel launches counted."""
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.parallel import collectives as C

    device = payload.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = _mesh(data=1, tensor=world)
    group = mesh.group("tensor")
    x, q, scale = (payload[k].to(device) for k in ("x", "q", "scale"))
    _build.LAUNCHES.clear()
    k = x.shape[-1] // world
    xs, qs = x[:, rank * k:(rank + 1) * k], q[:, rank * k:(rank + 1) * k]
    before = quant.GLOBAL_AMAX["all_reduces"]
    y = C.reduce_from_tp(quant.int8_matmul(xs, qs, scale, amax_group=group),
                         group)
    local = C.reduce_from_tp(quant.int8_matmul(xs, qs, scale), group)
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    xq = quant.quantize_activation_rows(xs, group)
    return dict(global_=y.cpu(), local=local.cpu(), xq=xq.values.cpu(),
                sx=xq.scales.cpu(),
                own=quant.quantize_activation(xs).values.cpu(),
                reduces=quant.GLOBAL_AMAX["all_reduces"] - before,
                launches=launches)


def case_mesh_eval(payload, rank, world):
    """A tiny LisaModel ("llama" fields, "decoder", "bits", "sd") sharded
    over each mesh: mesh_evaluate_fn on the payload's evaluate inputs
    (tokens, lengths, masks, taxonomy; none without "inputs"), then
    validate_on_benchmark over
    the benchmark folder through make_mesh_evaluate (IoU, IoCM, frames)."""
    from haff_tpu_torch.data.aff_dataset import AffDatasetVal
    from haff_tpu_torch.data.tokenizer import load_tokenizer
    from haff_tpu_torch.infer.evaluate import (make_mesh_evaluate,
                                               mesh_evaluate_fn,
                                               validate_on_benchmark)
    from haff_tpu_torch.parallel.sharding import param_shardings

    results = []
    for run in payload["runs"]:
        mesh = _mesh(**dict(run["mesh"]))
        _, model, _ = _lisa(payload, run)
        param_shardings(model, mesh)
        res = {}
        if payload.get("inputs") is not None:
            out = mesh_evaluate_fn(model, mesh, *payload["inputs"],
                                   max_new_tokens=payload["new_tokens"],
                                   eos_id=payload["eos"])
            res = {k: getattr(out, k) for k in (
                "output_ids", "gen_lengths", "pred_masks_left",
                "pred_masks_right", "taxonomies")}
        tok = load_tokenizer(None, model_max_length=448)
        ev = make_mesh_evaluate(model, mesh, payload["new_tokens"],
                                tok.eos_token_id)
        res["validate"] = validate_on_benchmark(
            model, tok, AffDatasetVal(payload["bench"]), evaluate=ev,
            model_max_length=448, max_new_tokens=payload["new_tokens"])
        results.append(res)
    return results


CASES = {n[5:]: f for n, f in globals().items() if n.startswith("case_")}


def main():
    case, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        payload = torch.load(os.path.join(workdir, "payload.pt"),
                             weights_only=False)
        payload.setdefault("workdir", workdir)
        result = CASES[case](payload, rank, world)
        torch.save(result, os.path.join(workdir, f"out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
