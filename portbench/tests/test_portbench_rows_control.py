"""The Moonlight cell's control: the program with its own int8 path on
the decoder's dense layers (W8A8 through nn/quant.quantize_model_: the
projections q_proj, kv_a_proj_with_mqa and o_proj, the dense first
layer and the head, and the SAM encoder as the lisa_mpt7b control has
it) in place of the bf16 the configuration states. kv_b_proj stays bf16
(the absorbed decode multiplies by its weight), as do the routed and
shared experts (the decode's one moe_decode launch reads both in bf16)
and the latent cache (no int8 form). It has to come out not correct on every
seed, and the program as configured correct. On the card at the cell's
own size,

    python3 -m pytest -s -m cuda portbench/tests/test_portbench_rows_control.py

and its wiring on the CPU at the tiny widths."""

import pytest

from portbench import harness, port
from portbench.tests import tiny_rows

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
CELL = "lisa_moonlight16b.robot_b1"


def predicate(path):
    from haff_tpu_torch.nn import quant

    p = set(str(x) for x in path)
    if "kv_b_proj" in p or "shared_experts" in p:
        return False
    if "llm" in p and "kv_a_proj_with_mqa" in p:
        return True
    return quant.lisa_serving_predicate(path)


def w8a8(drv):
    from haff_tpu_torch.nn import quant

    port.build_kernels(drv.device, ("w8a8_matmul",))
    quant.quantize_model_(drv.model, predicate)
    drv.bind()


def run(seed, device, seconds="20", **kw):
    return harness.run(["--workload", CELL, "--seed", str(seed),
                        "--seconds", seconds, "--trace", "0"], device=device,
                       **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(seed, cuda_device):
    res = run(seed, cuda_device, after_setup=w8a8)
    print("control", seed, {k: v["value"] for k, v in res["checks"].items()})
    assert res["correct"] is False, res["checks"]


def test_control_quantizes_the_decoders_dense_layers_at_tiny():
    """The control's wiring on the CPU: every dense projection of the
    decoder but kv_b_proj and the shared experts is int8, and its
    hidden-state reading lies above the program's."""
    def reading(**kw):
        res = harness.run(
            ["--workload", CELL, "--seed", str(2 ** 31 + 7), "--seconds",
             "1.5", "--trace", "0"], device="cpu", cell=tiny_rows.cell(CELL),
            cfg=tiny_rows.CELLS[CELL](), **kw)
        return res["checks"]["llm_hidden_rel_err"]["value"]

    seen = {}

    def control(drv):
        w8a8(drv)
        attn = drv.model.llm.layers[1].self_attn
        seen["q"] = attn.q_proj.quantized
        seen["kv_b"] = attn.kv_b_proj.quantized
        seen["shared"] = drv.model.llm.layers[1].mlp.shared_experts.\
            gate_proj.quantized

    assert reading(after_setup=control) > 3 * reading()
    assert seen == {"q": True, "kv_b": False, "shared": False}
