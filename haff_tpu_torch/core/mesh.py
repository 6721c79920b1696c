"""Device mesh over torch.distributed ranks (port of haff_tpu/core/mesh.py).

The JAX package lays its devices out on a `jax.sharding.Mesh` with six
axes; here the devices are the ranks of the default process group, laid
out row-major (numpy `reshape`, as JAX's `build_mesh` lays out
`jax.devices()`) over the same axes

    data   — batch / gradient sharding (ZeRO analog)
    pipe   — pipeline parallelism over decoder layers (GPipe)
    fsdp   — parameter sharding (fully-sharded data parallel)
    expert — MoE expert parallelism
    sp     — sequence parallelism (ring attention)
    tensor — tensor parallelism over attention heads / MLP columns

`build_mesh` builds a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names=AXES` over them, plus the process groups of the axis sets
the port reduces over (parallel/sharding.py, train/trainer.py). Every rank
creates every group, in one order, as torch requires. A one-rank mesh has
no groups: its collectives are the identity.

GSPMD derives the collectives from shardings; the port calls them itself
(parallel/collectives.py).
"""

from __future__ import annotations

import itertools
import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import MeshConfig

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
FSDP_AXIS = "fsdp"
EXPERT_AXIS = "expert"
SP_AXIS = "sp"
TENSOR_AXIS = "tensor"
AXES = (DATA_AXIS, PIPE_AXIS, FSDP_AXIS, EXPERT_AXIS, SP_AXIS, TENSOR_AXIS)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)

# build_mesh creates a process group for every set of the axes whose size
# is > 1 (a collective over a set of axes runs over the ranks that share
# every other coordinate); `Mesh.group` reads a set by those axes alone.
# A mesh of n ranks has at most log2(n) such axes.


def _axes(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(a for a in AXES if a in tuple(axes))


class Mesh:
    """The six-axis layout of `size` ranks and this rank's place in it.

    `shape` maps each axis to its size (JAX `mesh.shape`); `coord(axes)`
    is this rank's index along a set of axes (row-major, so
    `coord(("data", "fsdp"))` is its shard of a batch sharded as JAX's
    `P(("data", "fsdp"))`); `group(axes)` is the process group of the
    ranks that share every other coordinate, None where that group has
    one rank."""

    axis_names = AXES

    def __init__(self, sizes: Sequence[int], rank: int = 0,
                 device_mesh=None, groups: Optional[Dict] = None):
        self.sizes = tuple(int(s) for s in sizes)
        self.shape = dict(zip(AXES, self.sizes))
        self.size = int(np.prod(self.sizes))
        self.rank = int(rank)
        self.ranks = np.arange(self.size).reshape(self.sizes)
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            self.rank, self.sizes))))
        self.device_mesh = device_mesh
        self._groups = groups or {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def axis_size(self, axes) -> int:
        return int(math.prod(self.shape[a] for a in _axes(axes)))

    def coord(self, axes) -> int:
        """This rank's index along `axes` (row-major over them)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes) -> List[int]:
        """The global ranks of this rank's group along `axes`, in the
        group's own order (row-major over `axes`)."""
        axes = _axes(axes)
        sel = tuple(slice(None) if a in axes else self.coords[a]
                    for a in AXES)
        return [int(r) for r in self.ranks[sel].reshape(-1)]

    def group(self, axes):
        """The process group along `axes`, or None where it has one rank."""
        axes = tuple(a for a in _axes(axes) if self.shape[a] > 1)
        if not axes:
            return None
        try:
            return self._groups[axes]
        except KeyError:
            raise KeyError(f"no process group for axes {axes}; build_mesh "
                           f"creates {sorted(self._groups)}") from None


def _partitions(sizes, axes) -> List[List[int]]:
    """Every group along `axes`: the rank lists that share the other
    coordinates, each row-major over `axes`."""
    ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
    keep = [i for i, a in enumerate(AXES) if a in axes]
    other = [i for i in range(len(AXES)) if i not in keep]
    moved = np.transpose(ranks, other + keep)
    return [[int(r) for r in row] for row in
            moved.reshape(-1, int(np.prod([sizes[i] for i in keep])))]


def build_mesh(cfg: MeshConfig = MeshConfig(),
               world_size: Optional[int] = None) -> Mesh:
    """Build a 6-axis mesh over the ranks of the default process group,
    filling the `data` axis with the leftover ranks (`cfg.data == -1`).

    `world_size` defaults to the default group's size (1 without one; a
    layout of more ranks without a group has no process groups). The
    DeviceMesh's device is "cuda" under NCCL, else "cpu" (gloo moves host
    memory; parallel/collectives.py stages CUDA tensors through it)."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else (
        dist.get_world_size() if initialized else 1)
    pipe = max(1, getattr(cfg, "pp", 1))
    fsdp = max(1, cfg.fsdp)
    ep = max(1, getattr(cfg, "ep", 1))
    sp = max(1, getattr(cfg, "sp", 1))
    tensor = max(1, cfg.tensor)
    model = pipe * fsdp * ep * sp * tensor
    if cfg.data == -1:
        if n % model != 0:
            raise ValueError(
                f"{n} devices not divisible by pp*fsdp*ep*sp*tensor={model}")
        data = n // model
    else:
        data = cfg.data
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{pipe}x{fsdp}x{ep}x{sp}x{tensor} != {n} devices")
    sizes = (data, pipe, fsdp, ep, sp, tensor)
    if n == 1 or not initialized:
        return Mesh(sizes)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, sizes, mesh_dim_names=AXES)
    shape = dict(zip(AXES, sizes))
    groups = {(a,): device_mesh.get_group(a) for a in AXES if shape[a] > 1}
    rank = dist.get_rank()
    big = [a for a in AXES if shape[a] > 1]
    for n in range(2, len(big) + 1):
        for axes in itertools.combinations(big, n):
            for ranks in _partitions(sizes, axes):
                g = dist.new_group(ranks)  # every rank creates every group
                if rank in ranks:
                    groups[axes] = g
    return Mesh(sizes, rank, device_mesh, groups)


def single_device_mesh() -> Mesh:
    return Mesh((1, 1, 1, 1, 1, 1))


_MESH_STACK: List[Mesh] = []


@contextmanager
def use_mesh(mesh: Mesh):
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_mesh() -> Optional[Mesh]:
    return _MESH_STACK[-1] if _MESH_STACK else None


def ambient_mesh() -> Optional[Mesh]:
    """The mesh in effect: the innermost `use_mesh`. Lets modules (the
    sequence-parallel attention) find the mesh without threading it
    through every call signature. (JAX also reads `with mesh:`; torch has
    no such context.)"""
    return current_mesh()


@dataclass(frozen=True)
class BatchRows:
    """Which rows of the global batch this rank's tensors hold: rows
    [offset, offset + local) of `total`; `sharded` is False when the batch
    was replicated (every rank holds all rows). `group` is the batch group
    a per-row sum is completed over (None when not sharded)."""

    offset: int
    total: int
    sharded: bool = False
    group: object = None


_ROWS_STACK: List[BatchRows] = []


@contextmanager
def use_batch_rows(rows: BatchRows):
    _ROWS_STACK.append(rows)
    try:
        yield rows
    finally:
        _ROWS_STACK.pop()


def current_batch_rows() -> Optional[BatchRows]:
    return _ROWS_STACK[-1] if _ROWS_STACK else None


def batch_total(x):
    """The sum of `x` (a per-rank partial of a per-row sum, such as a loss
    denominator) over the ranks of the ambient sharded batch; `x` itself
    when the batch is not sharded. No gradient flows through the sum (the
    denominators are label counts)."""
    rows = current_batch_rows()
    if rows is None or not rows.sharded or rows.group is None:
        return x
    from ..parallel.collectives import all_reduce

    return all_reduce(x.detach(), rows.group)


def batch_spec() -> Tuple[str, ...]:
    """Batch dims shard over (data, fsdp) jointly; model dims replicated
    (JAX `P(("data", "fsdp"))`)."""
    return (DATA_AXIS, FSDP_AXIS)


def replicated() -> Tuple[str, ...]:
    return ()


def node_index() -> int:
    """This process's host among the launch's hosts (torchrun's
    GROUP_RANK; 0 on one host): JAX's `jax.process_index()` counts hosts,
    so per-host seeds use this, not the rank."""
    return int(os.environ.get("GROUP_RANK", os.environ.get("NODE_RANK", 0)))


def is_multihost() -> bool:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return dist.get_world_size() > local


def maybe_initialize_distributed(device=None) -> None:
    """Join the launcher's process group (the deepspeed/NCCL launcher of
    the reference). A no-op when a default group exists or when no
    launcher set the environment (a single process). Under torchrun
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `LOCAL_RANK`) it initialises from
    that environment: NCCL when the ranks compute on CUDA, with each rank
    on its `LOCAL_RANK` card, else gloo. Nothing falls back: a failed
    initialisation raises."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or \
            "MASTER_ADDR" not in os.environ:
        return
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
