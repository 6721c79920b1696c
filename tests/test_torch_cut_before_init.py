"""A model cut for a mesh before its weights exist (LisaModel(...,
mesh=), parallel/sharding.py `cut_before_init_`): a pipe rank builds only
its stage's decoder layers (the others `OtherStage` places) and an expert
rank only its E / ep experts, at the tiny preset in float32 on the CPU
(no process group: the cut needs only the rank's coordinates).

For every pipe stage and expert rank: each parameter the rank holds
equals the same parameter of the whole model built from the same seed
(its rows of the stacked experts), the parameters it leaves out are
exactly the other stages' (`held_elsewhere`), and it holds fewer
elements. An export loaded into the cut model (tools/bridge.py
`load_jax_params`, as `--pretrained_params`) gives it the same part of
the exported weights."""

import dataclasses

import pytest
import torch

from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.core.mesh import AXES, Mesh
from haff_tpu_torch.model.lisa import LisaModel
from haff_tpu_torch.nn.moe import MoEMLP
from haff_tpu_torch.parallel.sharding import OtherStage, held_elsewhere
from haff_tpu_torch.tools.bridge import load_jax_params, state_dict_to_flax

CASES = {  # name: (decoder, LlamaConfig fields, mesh axes)
    "llama_pp2": ("llama", dict(lora_rank=2, num_layers=4), {"pipe": 2}),
    "llama_pp4": ("llama", dict(lora_rank=2, num_layers=4), {"pipe": 4}),
    "mpt_pp2": ("mpt", dict(lora_rank=2, num_layers=4), {"pipe": 2}),
    "moe_ep2": ("llama", dict(lora_rank=2, moe_num_experts=4, moe_top_k=2,
                              moe_every=2), {"expert": 2}),
}


def _model(decoder, llama, seed, mesh=None):
    base = ModelConfig.preset("tiny")
    cfg = base.replace(decoder=decoder,
                       llama=dataclasses.replace(base.llama, **llama))
    return LisaModel(cfg, torch.float32, device="cpu", mesh=mesh,
                     generator=torch.Generator().manual_seed(seed))


def _part(model, name, full):
    """`full` cut as `model` holds parameter `name`."""
    owner = model.get_submodule(name.rsplit(".", 1)[0])
    if isinstance(owner, MoEMLP):
        p = model.get_parameter(name)
        return full.narrow(0, owner.expert_start, p.shape[0])
    return full


@pytest.mark.parametrize("case", list(CASES))
def test_cut_model_holds_its_part_of_the_whole_init(case):
    decoder, llama, axes = CASES[case]
    whole = dict(_model(decoder, llama, 13).named_parameters())
    exported = _model(decoder, llama, 21)
    tree = state_dict_to_flax(exported)
    exported = dict(exported.named_parameters())
    sizes = [axes.get(a, 1) for a in AXES]
    n = int(torch.tensor(sizes).prod())
    for rank in range(n):
        cut = _model(decoder, llama, 13, Mesh(sizes, rank))
        held = dict(cut.named_parameters())
        elsewhere = held_elsewhere(cut)
        assert set(held) | elsewhere == set(whole), (case, rank)
        assert not set(held) & elsewhere
        for name, p in held.items():
            assert torch.equal(p, _part(cut, name, whole[name])), name
        kept = sum(p.numel() for p in held.values())
        assert kept < sum(p.numel() for p in whole.values())
        if "pipe" in axes:
            stages = [m for m in cut.modules() if isinstance(m, OtherStage)]
            assert len(stages) == 4 - 4 // axes["pipe"]
        load_jax_params(cut, tree)
        for name, p in cut.named_parameters():
            assert torch.equal(p, _part(cut, name, exported[name])), name
