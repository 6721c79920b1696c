"""Training checkpoints with auto-resume (port of
haff_tpu/train/checkpoints.py; torch files in place of orbax).

Capability parity with reference train_ds.py:396-412 (auto-resume from
log_dir/ckpt_model, epoch recovered from the step counter) and
train_ds.py:470-486 (save-on-best-IoU, replacing the previous checkpoint).

Layout: one directory per step under the checkpoint root,

    ckpt_model/<step>/state.pt      step, the trainable tensors (float32,
                                    on the host) and the optimizer state
    ckpt_model/<step>/metrics.json  the metrics saved with it ({} if none)
    ckpt_model/<step>/model.json    how the model was built (optional; the
                                    train CLI's recipe, which a Predictor
                                    reads to load the checkpoint)

A step is written into a temporary directory beside it and renamed into
place, so a reader never sees half a checkpoint; after each save only the
newest `max_to_keep` steps remain. `restore_checkpoint` loads in place:
the parameters keep their storage, which a captured CUDA graph reads.

Under a mesh (parameters sharded by parallel/sharding.py) the files hold
the full layout: every rank takes part in gathering the trainable tensors
and the optimizer state, rank 0 writes them, with a barrier before (no
rank still reads a step that rotation would delete) and after (the step is
on disk for every rank). Under a pipe axis the stages' layers are
gathered too, into the one-process order of the trainable set (AdamW's
moments follow it). Loading cuts each tensor to the rank's block of
whatever mesh the run has (a pipeline stage takes its own layers), so a
checkpoint saved under one mesh resumes under another.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

STATE = "state.pt"
METRICS = "metrics.json"
MODEL = "model.json"


def _host(obj):
    """A copy of `obj` with every tensor copied to host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _is_writer() -> bool:
    d = _dist()
    return d is None or d.get_rank() == 0


def _barrier() -> None:
    d = _dist()
    if d is not None and d.get_world_size() > 1:
        d.barrier()


def _pipe_stage(state):
    """The pipeline stage (`PipeStage`) of the state's stage-local
    parameters, from their placement, or None."""
    from ..parallel.sharding import placement

    for p in state.trainable.values():
        pl = placement(p)
        if pl is not None and pl.stage is not None:
            return pl.stage
    return None


def snapshot(state) -> Dict[str, Any]:
    """A `TrainState` as a dict of host tensors in the full layout: the
    step, the trainable tensors by name and the optimizer's state (AdamW's
    moments, the schedule's count and the gradient-accumulation buffer).
    Under a mesh every rank must call it (it gathers the shards, and the
    pipeline stages' layers)."""
    from ..parallel.sharding import full_tensor, placement

    opt = state.optimizer
    adamw = opt.adamw.state_dict()
    entries = {}
    for i, (n, p) in enumerate(state.trainable.items()):
        pl = placement(p)
        moments = adamw["state"].get(i)
        entries[n] = _host({
            "stage_local": pl is not None and pl.pipe_group is not None,
            "t": full_tensor(p.detach(), pl),
            "m": None if moments is None else {
                k: full_tensor(v, pl) if torch.is_tensor(v) and v.ndim else v
                for k, v in moments.items()},
            "acc": None if opt.acc is None else full_tensor(opt.acc[i], pl)})
    order = list(entries)
    stage = _pipe_stage(state)
    if stage is not None:
        # Only the stage-local layers move: the rest is the same on every
        # pipe rank.
        import torch.distributed as dist

        mine = [n for n in order if entries[n]["stage_local"]]
        stages = [None] * dist.get_world_size(stage.group)
        dist.all_gather_object(stages, {n: entries[n] for n in mine},
                               group=stage.group)
        at = order.index(mine[0]) if mine else len(order)
        order = [n for n in order if not entries[n]["stage_local"]]
        order[at:at] = [n for st in stages for n in st]
        for st in stages:
            entries.update(st)
    return {
        "step": int(state.step),
        "trainable": {n: entries[n]["t"] for n in order},
        "optimizer": {
            "adamw": {"state": {i: entries[n]["m"]
                                for i, n in enumerate(order)
                                if entries[n]["m"] is not None},
                      "param_groups": [dict(g, params=list(range(len(order))))
                                       for g in adamw["param_groups"]]},
            "count": opt.count, "mini_step": opt.mini_step,
            "acc": (None if opt.acc is None else
                    [entries[n]["acc"] for n in order])},
    }


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(ckpt_dir, n, STATE)))


def _write(ckpt_dir: str, step: int, snap: Dict[str, Any],
           metrics: Optional[dict], max_to_keep: int,
           model_meta: Optional[dict]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(snap, os.path.join(tmp, STATE))
    with open(os.path.join(tmp, METRICS), "w") as f:
        json.dump(metrics or {}, f)
    if model_meta is not None:
        with open(os.path.join(tmp, MODEL), "w") as f:
            json.dump(model_meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    metrics: Optional[dict] = None, max_to_keep: int = 1,
                    model_meta: Optional[dict] = None) -> None:
    """Write `state` as step `step` of `ckpt_dir` and return when it is on
    disk; keep the newest `max_to_keep` steps. Under a mesh every rank
    calls it and rank 0 writes."""
    _barrier()
    snap = snapshot(state)
    if _is_writer():
        _write(ckpt_dir, step, snap, metrics, max_to_keep, model_meta)
    _barrier()


class CheckpointWriter:
    """Checkpoints written in the background for the training loop: `save`
    copies the state to host memory and returns; a thread writes it while
    training goes on (one write at a time, in order). `finish` waits for
    the writes and raises the first error one of them hit. Call it before
    exiting or before handing the directory to a synchronous writer (the
    preemption path). Under a mesh every rank calls `save` and `finish`;
    rank 0 writes."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 1,
                 model_meta: Optional[dict] = None):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        self.model_meta = model_meta
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def _run(self, *args):
        try:
            _write(*args)
        except BaseException as e:  # surfaced by finish()
            self._err = e

    def save(self, step: int, state: Any,
             metrics: Optional[dict] = None) -> None:
        _barrier()
        snap = snapshot(state)
        self._join()
        if not _is_writer():
            return
        self._thread = threading.Thread(
            target=self._run, args=(self.ckpt_dir, step, snap, metrics,
                                    self.max_to_keep, self.model_meta),
            daemon=True)
        self._thread.start()

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def finish(self) -> None:
        self._join()
        _barrier()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def step_dir(ckpt: str) -> Optional[str]:
    """The directory of one step: `ckpt` itself if it holds a state.pt,
    else the newest step under the checkpoint root `ckpt`; None if there
    is none."""
    if os.path.isfile(os.path.join(ckpt, STATE)):
        return ckpt
    step = latest_step(ckpt)
    return None if step is None else os.path.join(ckpt, str(step))


def read_json(path: str) -> Optional[dict]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


@torch.no_grad()
def load_trainable_(trainable: Dict[str, torch.Tensor],
                    saved: Dict[str, torch.Tensor]) -> None:
    """Copy saved tensors into the parameters of the same names, in place;
    the two name sets must be equal."""
    if set(trainable) != set(saved):
        missing = sorted(set(trainable) - set(saved))
        extra = sorted(set(saved) - set(trainable))
        raise ValueError(f"checkpoint does not match the trainable set: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    for name, p in trainable.items():
        src = saved[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                             f"parameter {tuple(p.shape)}")
        p.copy_(src)


def restore_checkpoint(ckpt_dir: str, state: Any) -> Tuple[Any, Optional[int]]:
    """Auto-resume: load the newest step of `ckpt_dir` (or the step
    directory `ckpt_dir`) into `state` in place: the trainable tensors are
    copied into their parameters and the optimizer's state is loaded, each
    cut to this rank's block under a mesh. Returns (state, step), or
    (state, None) when there is no checkpoint."""
    from ..parallel.sharding import local_tensor, placement

    d = step_dir(ckpt_dir) if os.path.isdir(ckpt_dir) else None
    if d is None:
        return state, None
    snap = torch.load(os.path.join(d, STATE), map_location="cpu",
                      weights_only=True)
    order = list(snap["trainable"])
    # A pipeline stage takes its own layers; the other stages' stay.
    stage = _pipe_stage(state)
    elsewhere = frozenset() if stage is None else stage.elsewhere
    load_trainable_(state.trainable, {
        n: local_tensor(t, placement(state.trainable[n]))
        if n in state.trainable else t for n, t in snap["trainable"].items()
        if n not in elsewhere})
    opt, saved = state.optimizer, snap["optimizer"]
    params = list(state.trainable.items())
    at = {n: i for i, n in enumerate(order)}
    moments = {}
    for j, (n, p) in enumerate(params):
        m = saved["adamw"]["state"].get(at[n])
        if m is not None:
            moments[j] = {k: local_tensor(v, placement(p))
                          if torch.is_tensor(v) and v.ndim else v
                          for k, v in m.items()}
    opt.adamw.load_state_dict({
        "state": moments,
        "param_groups": [dict(g, params=list(range(len(params))))
                         for g in saved["adamw"]["param_groups"]]})
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    opt.acc = (None if saved["acc"] is None else
               [local_tensor(saved["acc"][at[n]], placement(p)).to(p.device)
                for n, p in params])
    state.step = snap["step"]
    return state, state.step


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Initial weights (`--pretrained_params`): the flat `.npz` that
    haff_tpu/tools/export_params.py writes, loaded through tools/bridge.py
    into `model` (strict). An orbax directory is not read by the port."""
    if os.path.isdir(path) or not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: orbax checkpoints are not read by the port; export the "
            "parameters to an .npz with haff_tpu/tools/export_params.py")
    from ..tools.bridge import load_jax_params

    return load_jax_params(model, path)


def load_trained_model(ckpt: str, cfg, precision: str, device):
    """A model for serving from a checkpoint the train CLI wrote (its root
    `ckpt_model/` or one step's directory): the model rebuilt as the run
    built it (its `model.json`: preset, LoRA settings, vocabulary, seed,
    initial weights; a seeded init draws on the device's generator, so
    rebuild on the device type the run trained on), then the newest
    step's trained tensors copied in. `cfg` is the caller's preset
    config; its decoder and its LLaMA LoRA and vocabulary fields are taken
    from the run."""
    import dataclasses

    d = step_dir(ckpt)
    if d is None:
        raise NotImplementedError(
            f"{ckpt}: no checkpoint of the port's train CLI (a step "
            f"directory with {STATE}); orbax checkpoints are not read by the "
            "port: export the parameters to an .npz with "
            "haff_tpu/tools/export_params.py")
    meta = read_json(os.path.join(d, MODEL))
    if meta is None:
        raise ValueError(f"{d}: no {MODEL}; the checkpoint does not say how "
                         "its model was built")
    llama = dict(meta["llama"], lora_targets=tuple(meta["llama"]["lora_targets"]))
    cfg = cfg.replace(decoder=meta.get("decoder", cfg.decoder),
                      llama=dataclasses.replace(cfg.llama, **llama))
    from .cli import build_model

    model = build_model(cfg, precision, device, meta["seed"],
                        meta["pretrained_params"], meta["vision_pretrained"],
                        meta["reset_mask_decoder"])
    snap = torch.load(os.path.join(d, STATE), map_location="cpu",
                      weights_only=True)
    own = model.state_dict()
    with torch.no_grad():
        for name, t in snap["trainable"].items():
            own[name].copy_(t)
    return model
