"""The lisa_rows driver's two cells at the tiny widths on the CPU, in
float32, through a whole harness run: the program agrees with the plain
reference (every row of the checked requests), and the routing the
program recorded is the reference's own (float32 on both sides: no
near-tie). Tolerances as test_portbench_reference.py's: the bf16 KV or
latent cache the port keeps whatever the model's dtype moves the decode
steps' hidden states by a few 1e-3, and the SAM's tanh GELU and norm eps
the masks by ~1e-3."""

import pytest

from portbench import harness
from portbench.tests import tiny_rows


@pytest.mark.parametrize("cell", list(tiny_rows.CELLS))
def test_rows_agree_with_reference(cell):
    res = harness.run(
        ["--workload", cell, "--seed", str(2 ** 31 + 17), "--seconds", "1.5",
         "--trace", "0"], device="cpu", cell=tiny_rows.cell(cell),
        cfg=tiny_rows.CELLS[cell]())
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] and res["failed"] == 0
    assert checks["llm_hidden_rel_err"] < 5e-3
    assert checks["mask_rel_err"] < 5e-3
    assert checks["taxonomy_err"] < 5e-4
    if "route_margin_max" in checks:
        assert checks["route_margin_max"] == 0.0


def test_batch_rows_take_their_own_frames_and_prompts():
    from portbench.drivers.lisa_rows import Driver

    cell = tiny_rows.cell("lisa_mpt7b.label_b8")
    drv = Driver(tiny_rows.CELLS["lisa_mpt7b.label_b8"](), cell, 5, "cpu", None)
    drv.frames = list(range(cell["traffic"]["frames"]))
    frames, prompts = drv.inputs(1)
    assert frames == [0, 1] and len(set(prompts)) == 2
    assert drv.inputs(0)[1] != prompts
