"""The control: the program with its own int8 path switched on (W8A8 on
its serving set, the SAM encoder's and the LLM's projections, over an
int8 KV cache) in place of the bf16 the configuration states. It has to
come out not correct on every seed, and the program as configured
correct. On the card at the cell's own size,

    python3 -m pytest -s -m cuda portbench/tests/test_portbench_control.py

and its wiring on the CPU at the tiny widths."""

import pytest

from portbench import harness, port
from portbench.tests import tiny
from portbench.tests.test_portbench_reference import CELLS

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
CELL = "lisa_mpt7b.robot_b1"
NUMBER = "llm_hidden_rel_err"  # the number the control fails


def w8a8(drv):
    """Quantize the driver's model to the program's W8A8 serving set and
    bind a Predictor with the int8 KV cache (warmed up again)."""
    from haff_tpu_torch.nn import quant

    port.build_kernels(drv.device, ("w8a8_matmul",))
    quant.quantize_model_(drv.model, quant.lisa_serving_predicate)
    drv.bind(kv_cache_8bit=True)


def run(seed, device, **kw):
    return harness.run(["--workload", CELL, "--seed", str(seed),
                        "--seconds", "4", "--trace", "0"], device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(seed, cuda_device):
    res = run(seed, cuda_device, after_setup=w8a8)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_program_passes(cuda_device):
    res = run(SEEDS[0], cuda_device)
    assert res["correct"] is True, res["checks"]


def test_control_reads_above_the_program_at_tiny():
    """The control's wiring on the CPU: at the tiny widths (float32, with
    the program's bfloat16 KV cache) its LLM reading is 3x the
    program's or more."""
    def reading(**kw):
        res = harness.run(
            ["--workload", CELL, "--seed", str(2 ** 31 + 7), "--seconds",
             "1.5", "--trace", "0"], device="cpu", cell=tiny.cell(CELL),
            cfg=CELLS[CELL](), **kw)
        return res["checks"][NUMBER]["value"]

    assert reading(after_setup=w8a8) >= 3 * reading()
