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


def snapshot(state) -> Dict[str, Any]:
    """A `TrainState` as a dict of host tensors: the step, the trainable
    tensors by name and the optimizer's state (AdamW's moments, the
    schedule's count and the gradient-accumulation buffer)."""
    opt = state.optimizer
    return _host({
        "step": int(state.step),
        "trainable": dict(state.trainable),
        "optimizer": {"adamw": opt.adamw.state_dict(), "count": opt.count,
                      "mini_step": opt.mini_step, "acc": opt.acc},
    })


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
    disk; keep the newest `max_to_keep` steps."""
    _write(ckpt_dir, step, snapshot(state), metrics, max_to_keep, model_meta)


class CheckpointWriter:
    """Checkpoints written in the background for the training loop: `save`
    copies the state to host memory and returns; a thread writes it while
    training goes on (one write at a time, in order). `finish` waits for
    the writes and raises the first error one of them hit. Call it before
    exiting or before handing the directory to a synchronous writer (the
    preemption path)."""

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
        snap = snapshot(state)
        self._join()
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
    copied into their parameters and the optimizer's state is loaded.
    Returns (state, step), or (state, None) when there is no checkpoint."""
    d = step_dir(ckpt_dir) if os.path.isdir(ckpt_dir) else None
    if d is None:
        return state, None
    snap = torch.load(os.path.join(d, STATE), map_location="cpu",
                      weights_only=True)
    load_trainable_(state.trainable, snap["trainable"])
    opt, saved = state.optimizer, snap["optimizer"]
    opt.adamw.load_state_dict(saved["adamw"])
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    opt.acc = (None if saved["acc"] is None else
               [a.to(p.device) for a, p in zip(saved["acc"], opt.params)])
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
    config; its LLaMA LoRA and vocabulary fields are taken from the run."""
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
    cfg = cfg.replace(llama=dataclasses.replace(cfg.llama, **llama))
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
