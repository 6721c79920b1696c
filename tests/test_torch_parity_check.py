"""The port's parity harness (haff_tpu_torch/tools/parity_check.py) on the
CPU (`--device cpu`), against haff_tpu's:

* `--clip` / `--sam` on a tiny HF CLIP directory and a tiny original-layout
  SAM `.pth` written here (as tests/test_delta_weights.py writes them):
  both stages PASS with the port's max abs within 1e-4 of the HF classes,
  in the JAX tool's line format (its `check` prints the same lines; its
  own run of these stages is slow-listed);
* `--dry_run_7b`: PASS with 0 homeless, 0 shape-mismatched and 0
  uncovered leaves against the port's 7b model on the meta device;
* the dry run's key accounting (keys read, converted leaves and shapes)
  equal to haff_tpu's `convert_2haff` on the same synthetic state dict cut
  to 2 LLaMA layers and 2 SAM blocks;
* a mutated key map (one converted leaf dropped) makes the dry run FAIL
  with exit 1.
"""

import re

import numpy as np
import pytest
from flax import traverse_util

from haff_tpu.tools import convert_weights as JC
from haff_tpu.tools import parity_check as JP
from haff_tpu_torch.tools import convert_weights as TC
from haff_tpu_torch.tools import parity_check as TP

LINE = re.compile(r"^(PASS|FAIL) (\S+.*): max abs (\S+) rel (\S+)$")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The tool's tiny checkpoints: HF's CLIPVisionModel and SamModel at
    tests/test_delta_weights.py's sizes, seeded."""
    return TP.write_tiny_checkpoints(str(tmp_path_factory.mktemp("ckpt")))


def run(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().out


def test_clip_and_sam_stages_pass_as_jax(checkpoints, capsys):
    clip_dir, sam_pth = checkpoints
    argv = ["--clip", clip_dir, "--sam", sam_pth, "--sam_heads", "1"]
    code, out = run(TP.main, argv + ["--device", "cpu"], capsys)
    assert code == 0, out
    got = {m.group(2): m for m in map(LINE.match, out.splitlines()) if m}
    assert set(got) == {"clip_tower(select=-2, patches)", "sam_image_encoder"}
    for m in got.values():
        assert m.group(1) == "PASS" and float(m.group(3)) <= 1e-4, out
    assert "SAM embedding stats" in out
    # The report lines are JAX's, character for character.
    a = np.random.RandomState(0).rand(3, 5)
    for b in (a + 1e-5, a + 1.0):
        assert TP.check("x", a, b) == JP.check("x", a, b)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == lines[1] and LINE.match(lines[0])


def test_dry_run_7b_passes(capsys):
    code, out = run(TP.main, ["--dry_run_7b"], capsys)
    assert code == 0, out
    assert re.search(r"PASS dry_run_7b: \d+ converted leaves, 0 homeless, "
                     r"0 shape-mismatched, 0 init params uncovered", out), out


def test_dry_run_7b_fails_on_a_mutated_key_map(capsys, monkeypatch):
    convert_llama = TC.convert_llama

    def drops_the_final_norm(sd, num_layers, prefix="model."):
        tree = convert_llama(sd, num_layers, prefix)
        del tree["model"]["norm"]
        return tree

    monkeypatch.setattr(TC, "convert_llama", drops_the_final_norm)
    code, out = run(TP.main, ["--dry_run_7b"], capsys)
    assert code == 1, out
    assert "FAIL dry_run_7b:" in out and "1 init params uncovered" in out
    assert "llm.model.norm.weight" in out


def _cut(sd, layers):
    """The state dict without LLaMA layers and SAM blocks >= `layers`."""
    keep = re.compile(r"(model\.layers|image_encoder\.blocks)\.(\d+)\.")
    return {k: v for k, v in dict.items(sd)
            if not (m := keep.search(k)) or int(m.group(2)) < layers}


def test_key_accounting_equals_jax_convert_2haff():
    sd = _cut(TP._shipped_7b_state_dict(), 2)
    port_sd = TP._TrackingDict(sd)
    conv = TP.convert_tracked(port_sd, llama_layers=2, sam_depth=2)
    jax_sd = JP._TrackingDict(sd)
    jconv = JC.convert_2haff(jax_sd, llama_layers=2, sam_depth=2)
    pfx = "model.visual_model."
    view = JP._TrackingDict({k[len(pfx):]: v for k, v in sd.items()
                             if k.startswith(pfx)})
    JC.convert_sam(view, depth=2)
    jax_sd.read |= {pfx + k for k in view.read}
    assert port_sd.read == jax_sd.read
    unread = {k for k in sd if k not in port_sd.read
              and "rotary_emb" not in k and "inv_freq" not in k}
    assert not unread
    got = {k: np.shape(v) for k, v in traverse_util.flatten_dict(conv).items()}
    want = {k: np.shape(v) for k, v in
            traverse_util.flatten_dict(jconv).items()}
    assert got == want and len(got) > 100
