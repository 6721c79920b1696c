"""A run loads neither JAX nor the JAX package; the reference loads
nothing of the program; the check compares whole top-level names."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "haff_tpu_torch_x", types.ModuleType("x"))
    assert "haff_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "haff_tpu.core", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["haff_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        "harness.run(['--workload', 'lisa_mpt7b.robot_b1', '--seed', '3', "
        "'--seconds', '0.5', '--trace', '0'], device='cpu', "
        "cell=tiny.cell('lisa_mpt7b.robot_b1'), cfg=tiny.lisa_cfg())\n"
        "print(harness.forbidden_modules(), 'haff_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.lisa, portbench.reference.sam, "
            "portbench.weights, portbench.traffic\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('haff_tpu_torch', 'haff_tpu', 'jax', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n.split(".")[0] in ("haff_tpu_torch", "haff_tpu", "jax")
                               for n in names), (f, names)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "lisa_mpt7b.robot_b1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
