"""Find the benchmark's parts by name: a cell's file, its configuration,
its driver, a per-layer metric's reader and an op's count. A later
change adds a part by adding a file under the folder its kind lives in;
nothing here lists them.

    workloads/<cell>.json    configs/<config>.json    drivers/<entry>.py
    metrics/<metric>.py      flops/<op>.py
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """The cell's file: config, entry, traffic, checks and their limits."""
    cell = _json("workloads", name)
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {cell.get('name')!r}")
    return cell


def config(name: str) -> dict:
    return _json("configs", name)


def _module(kind: str, name: str):
    mod = name.replace(".", "_")
    if not (ROOT / kind / f"{check_name(mod)}.py").is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module {name!r}")
    return importlib.import_module(f"{__package__}.{kind}.{mod}")


def driver(entry: str):
    """drivers/<entry>.py: `Driver(cfg, cell, seed, device, spans)`."""
    return _module("drivers", entry)


def metric(name: str):
    """metrics/<name>.py: `read(ctx) -> float or None` (a `.` in the
    metric's name is a `_` in the file's)."""
    return _module("metrics", name)


def flops(op: str):
    """flops/<op>.py: `count(...) -> dict(flops=..., bytes=...)`."""
    return _module("flops", op)


def benchmark_metrics(cell: str, trace: bool):
    """The metric entries of BENCHMARK.json that this cell reports, from
    the file at the root of the checkout: end_to_end without trace,
    per_layer with it."""
    path = ROOT.parent / "BENCHMARK.json"
    with open(path) as f:
        bench = json.load(f)
    rows = bench["per_layer" if trace else "end_to_end"]
    return [m for m in rows if cell in m.get("workloads", [cell])]
