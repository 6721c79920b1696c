"""The port's torch-free config copy equals haff_tpu/core/config.py field
for field, for every preset and every dataclass default."""

import dataclasses

import pytest

import haff_tpu.core.config as jc
import haff_tpu_torch.core.config as pc

PRESETS = {
    "ModelConfig": ("7b", "13b", "1b", "small", "tiny"),
    "LlamaConfig": ("7b", "13b", "1b", "small", "tiny"),
    "SamEncoderConfig": ("vit_h", "vit_l", "vit_b", "small", "tiny"),
}


@pytest.mark.parametrize("cls,preset", [
    (cls, p) for cls, ps in PRESETS.items() for p in ps])
def test_preset_fields_equal(cls, preset):
    ours = getattr(pc, cls).preset(preset)
    ref = getattr(jc, cls).preset(preset)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("cls", [
    "ClipVisionConfig", "LlamaConfig", "SamEncoderConfig", "SamDecoderConfig",
    "ModelConfig", "LoraConfig", "MeshConfig", "TrainConfig", "InferConfig"])
def test_defaults_equal(cls):
    assert dataclasses.asdict(getattr(pc, cls)()) == \
        dataclasses.asdict(getattr(jc, cls)())


def test_constants_and_derived_properties_equal():
    for name in ("IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN",
                 "DEFAULT_IM_START_TOKEN", "DEFAULT_IM_END_TOKEN", "SEG_TOKEN",
                 "ASPECT_RATIO_SQUARE"):
        assert getattr(pc, name) == getattr(jc, name)
    for p in PRESETS["ModelConfig"]:
        a, b = pc.ModelConfig.preset(p), jc.ModelConfig.preset(p)
        assert a.clip.num_patches == b.clip.num_patches
        assert a.sam_encoder.grid_size == b.sam_encoder.grid_size
    with pytest.raises(ValueError):
        pc.ModelConfig.preset("nope")
