"""Training observability: meters + TensorBoard writer (port of
haff_tpu/train/metrics.py).

Capability parity with reference utils/utils.py:7-163 (AverageMeter with
cross-rank aggregation, ProgressMeter) and the train_ds.py wandb/
TensorBoard scalar surface (train_ds.py:444-450, 580-620). Aggregation
across ranks is a `torch.distributed` all-reduce when a process group is
initialized, and a no-op otherwise. tensorboardX and wandb are optional:
a logger whose package is missing logs nothing to it."""

from __future__ import annotations

from typing import Dict, Optional


class AverageMeter:
    """Running average (reference utils.py:28-94)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def all_reduce(self):
        """Cross-rank SUM aggregation (reference utils.py:73-94
        dist.all_reduce); a no-op unless torch.distributed is initialized."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        vec = torch.tensor([self.sum, float(self.count)], dtype=torch.float64,
                           device=dev)
        dist.all_reduce(vec, op=dist.ReduceOp.SUM)
        self.sum = float(vec[0])
        self.count = int(vec[1])

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
                ).format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + f"[{batch}/{self.num_batches}]"]
        entries += [f"{m.name} {m.val:.4f} ({m.avg:.4f})"
                    for m in self.meters]
        print("  ".join(entries), flush=True)


class MetricsLogger:
    """TensorBoard (tensorboardX) + optional wandb scalar logger."""

    def __init__(self, log_dir: Optional[str] = None,
                 use_wandb: bool = False, wandb_project: str = "haff_tpu",
                 exp_name: str = "run"):
        self.tb = None
        self.wandb = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except Exception:
                pass
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=exp_name)
                self.wandb = wandb
            except Exception:
                pass

    def log(self, scalars: Dict[str, float], step: int):
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)
        if self.wandb:
            self.wandb.log(scalars, step=step)

    def close(self):
        if self.tb:
            self.tb.close()
