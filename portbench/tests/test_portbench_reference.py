"""The plain reference agrees with the program at the tiny widths on the
CPU, in float32, through a whole run of each cell's harness: the same
seeded weights, inputs and comparison as on the card.

Tolerances: the program's SAM follows the JAX package's tanh GELU and
eps 1e-6 in the two-way transformer's norms where segment-anything uses
the exact GELU and nn.LayerNorm's 1e-5; that alone moves the masks by
~1e-3 relative at these widths (measured 5e-4 to 7e-4). With the
reference switched to the program's two choices it agrees to float32
rounding (1e-5), but for what the decode steps feed: the program's KV
cache is bfloat16 whatever the model's dtype (`generate.DecodeState`),
which moves the hidden states of the decode steps by ~2e-3 relative
(measured 1.9e-3 to 2.3e-3; the prefill's agree to 1e-6), and the masks
and taxonomy that a [SEG] emitted by a decode step prompts by ~3e-4
and ~2e-5."""

import types

import pytest
import torch.nn.functional as F

from portbench import harness
from portbench.reference import sam as ref_sam
from portbench.tests import tiny

DECODE_FED = {"llm_hidden_rel_err": 5e-3, "mask_rel_err": 1e-3,
              "taxonomy_err": 1e-4}

CELLS = {"lisa_mpt7b.robot_b1": tiny.lisa_cfg}


def run_tiny(cell, seed, **kw):
    res = harness.run(
        ["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
         "--trace", "0"], device="cpu", cell=tiny.cell(cell), cfg=CELLS[cell](), **kw)
    return res


@pytest.mark.parametrize("cell", list(CELLS))
def test_program_agrees_with_reference(cell):
    res = run_tiny(cell, 2 ** 31 + 17)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert checks["mask_rel_err"] < 2e-3
    if "llm_hidden_rel_err" in checks:
        assert checks["llm_hidden_rel_err"] < 5e-3
    assert checks["taxonomy_err"] < 1e-4


@pytest.mark.parametrize("cell", list(CELLS))
def test_reference_with_the_programs_gelu_and_eps_is_exact(cell, monkeypatch):
    fn = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                  if not k.startswith("_")})
    fn.gelu = lambda x: F.gelu(x, approximate="tanh")
    monkeypatch.setattr(ref_sam, "F", fn)
    ln = ref_sam._ln
    monkeypatch.setattr(ref_sam, "_ln", lambda x, W, name, eps: ln(x, W, name, 1e-6))
    res = run_tiny(cell, 5)
    for name, c in res["checks"].items():
        assert c["value"] < DECODE_FED.get(name, 1e-5), (name, c)


def test_weights_spec_names_every_parameter():
    import torch

    from portbench import port, weights
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = tiny.lisa_cfg()
    model = LisaModel(port.lisa_config(cfg, 260), torch.float32, device="meta")
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert have == {n: tuple(s) for n, s, _ in weights.lisa_spec(cfg)}


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    import torch

    from portbench import weights

    spec = weights.sam_spec(tiny.TINY_SAM)
    a = weights.reference_weights(spec, 2 ** 31 + 5, "cpu", torch.bfloat16)
    b = weights.reference_weights(spec, 2 ** 31 + 5, "cpu", torch.bfloat16)
    c = weights.reference_weights(spec, 2 ** 31 + 6, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image_encoder.blocks.0.attn.qkv.weight"],
                           c["image_encoder.blocks.0.attn.qkv.weight"])
    # rounded to the served dtype: the float32 copy holds bf16 values
    w = a["image_encoder.blocks.0.attn.qkv.weight"]
    assert torch.equal(w, w.to(torch.bfloat16).float())
