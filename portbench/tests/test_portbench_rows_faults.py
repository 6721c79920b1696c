"""The lisa_rows driver's checks catch a broken program: each test skips
the look for a card and drives a run of the Moonlight cell on the CPU at
the tiny widths (tiny_rows.py) with the cell's own limits, and breaks
the deepseek_v3 decoder where it computes: every token routed to all but
the last of its experts, the correction bias added into the weights, the
shared experts skipped, the decode's latent slot written one position
early, RoPE applied as rotate-half on the raw layout. Each must come out
not correct: some check over its limit (the hidden states, or the
latent cache's rows for the slot written early)."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny_rows

CELL = "lisa_moonlight16b.robot_b1"


def run_broken(break_it):
    return harness.run(
        ["--workload", CELL, "--seed", str(2 ** 31 + 101), "--seconds", "1.5",
         "--trace", "0"], device="cpu", cell=tiny_rows.cell(CELL),
        cfg=tiny_rows.CELLS[CELL](), after_setup=break_it)


def _layers(drv):
    return list(drv.model.llm.layers)


def _routers(drv):
    return [layer.mlp.gate for layer in _layers(drv) if layer.is_moe]


def drop_last_expert(drv):
    for router in _routers(drv):
        inner = router.forward

        def forward(x, inner=inner):
            idx, w = inner(x)
            return idx, torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], 1)

        router.forward = forward


def bias_into_weights(drv):
    for router in _routers(drv):
        inner = router.forward

        def forward(x, router=router, inner=inner):
            idx, _ = inner(x)
            s = torch.sigmoid(torch.nn.functional.linear(
                x.float(), router.weight.float()))
            c = (s + router.e_score_correction_bias.float()).gather(1, idx)
            return idx, c / (c.sum(-1, keepdim=True) + 1e-20) * \
                router.cfg.routed_scaling_factor

        router.forward = forward


def skip_shared_experts(drv):
    """Their output zero at the prefill and in the decode's fused launch."""
    for layer in _layers(drv):
        if layer.is_moe:
            layer.mlp.shared_experts.down_proj.weight.data.zero_()


def latent_slot_early(drv):
    for layer in _layers(drv):
        attn = layer.self_attn
        inner = attn.forward

        def forward(x, cis, segment_ids=None, cache=None, cache_index=None,
                    mask=None, inner=inner):
            if mask is not None:
                cache_index = cache_index - 1
            return inner(x, cis, segment_ids, cache, cache_index, mask)

        attn.forward = forward


def rotate_half_raw(x, cis):
    cos = torch.cat([cis.real, cis.real], -1)[:, :, None]
    sin = torch.cat([cis.imag, cis.imag], -1)[:, :, None]
    xf = x.float()
    d = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., d:], xf[..., :d]], -1)
    return (xf * cos + rot * sin).to(x.dtype)


@pytest.mark.parametrize("fault", [drop_last_expert, bias_into_weights,
                                   skip_shared_experts, latent_slot_early,
                                   "rope"])
def test_moonlight_fault_fails(fault, monkeypatch):
    if fault == "rope":
        from haff_tpu_torch.nn import deepseek_v3

        monkeypatch.setattr(deepseek_v3, "rope_pairs", rotate_half_raw)
        fault = None
    res = run_broken(fault)
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert res["correct"] is False and over, res["checks"]


def test_moonlight_program_is_correct():
    res = run_broken(None)
    assert res["correct"] is True, res["checks"]
