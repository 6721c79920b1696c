"""flops/deepseek_v3_forward.py agrees with FlopCounterMode on the
program's decoder at the tiny widths: a prefill over L positions (the
attention counted over every (query, key) pair, as the fused SDPA is
counted whatever its mask: context == L), its experts active only."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import deepseek, registry
from portbench.tests import tiny_rows


@pytest.mark.parametrize("length", [7, 33])
def test_deepseek_v3_forward(length):
    from haff_tpu_torch.nn.deepseek_v3 import DeepseekV3ForCausalLM

    cfg = tiny_rows.moonlight_cfg()
    m = DeepseekV3ForCausalLM(deepseek.decoder_config(cfg)).requires_grad_(False)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(1, length, cfg["hidden_size"])
    with FlopCounterMode(display=False) as c, torch.no_grad():
        m(x, torch.arange(length)[None])
    assert c.get_total_flops() == registry.flops("deepseek_v3_forward").count(
        cfg, length, length, length)["flops"]
