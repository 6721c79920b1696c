"""The benchmark finds its parts by name, and BENCHMARK.json keeps to the
contract's names, units and keys."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_load_by_name(cell):
    w = registry.workload(cell)
    cfg = registry.config(w["config"])
    assert cfg["name"] == w["config"]
    drv = registry.driver(w["entry"])
    assert hasattr(drv, "Driver")
    for trace in (False, True):
        for m in registry.benchmark_metrics(cell, trace):
            assert callable(registry.metric(m["name"]).read)


@pytest.mark.parametrize("name", ["../x", "a b", "a/b", ""])
def test_bad_names_refused(name):
    with pytest.raises(ValueError):
        registry.workload(name)


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_new_cell_and_metric_found_without_edits(tmp_path):
    """A copy of the benchmark gains a cell and a per-layer metric by new
    files and new entries only; the harness's lookups find both."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((copy / "portbench/workloads/lisa_mpt7b.robot_b1.json").read_text())
    cell["name"] = "lisa_mpt7b.robot_b2"
    (copy / "portbench/workloads/lisa_mpt7b.robot_b2.json").write_text(json.dumps(cell))
    (copy / "portbench/metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.done))\n")
    bench["workloads"].append({"name": "lisa_mpt7b.robot_b2", "config": "lisa_mpt7b",
                               "traffic": "robot_b2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "req", "better": "higher",
                               "source": "host_clock", "layer": "predictor",
                               "moves": "requests_per_s",
                               "workloads": ["lisa_mpt7b.robot_b2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import registry\n"
            "w = registry.workload('lisa_mpt7b.robot_b2')\n"
            "names = [m['name'] for m in registry.benchmark_metrics(w['name'], True)]\n"
            "assert 'frames_seen' in names, names\n"
            "from types import SimpleNamespace\n"
            "print(registry.metric('frames_seen').read(SimpleNamespace(done=[1, 2])))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, text=True,
                         capture_output=True, env={**os.environ, "PYTHONPATH": str(copy)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2.0"
    for kind in ("workloads", "metrics"):
        for f in (ROOT / "portbench" / kind).iterdir():
            if f.is_file():
                assert (copy / "portbench" / kind / f.name).read_bytes() == f.read_bytes()
