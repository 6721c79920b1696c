"""The port's weight conversions (haff_tpu_torch/tools/convert_weights.py)
against haff_tpu's on seeded PyTorch state dicts of tiny HF models (SAM in
its HF and original layouts, CLIP ViT, LLaMA) and on a merged 2HAff state
dict assembled from them: the port's tree equals the haff_tpu conversion
exactly, and so do both carried through tools/bridge.py into the port's
state_dict names and layouts. `merge_into_init` overlays a stock SAM
checkpoint onto the port's Sam as haff_tpu's overlays it onto a flax init
tree."""

import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.tools import convert_weights as JC
from haff_tpu_torch.tools import convert_weights as TC
from haff_tpu_torch.tools.bridge import flax_to_state_dict


def hf_models():
    from transformers import CLIPVisionConfig, CLIPVisionModel
    from transformers import LlamaConfig, LlamaForCausalLM

    from test_sam_parity import tiny_hf_sam

    sam, _ = tiny_hf_sam()
    torch.manual_seed(1)
    clip = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=2, image_size=32, patch_size=16,
        hidden_act="quick_gelu"))
    llama = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False))

    def sd(m):
        return {k: v.detach().numpy() for k, v in m.state_dict().items()}

    return sd(sam), sd(clip), sd(llama)


@pytest.fixture(scope="module")
def state_dicts():
    sam, clip, llama = hf_models()
    sam_orig = JC.hf_sam_to_original(sam)
    merged = dict(llama)
    rng = np.random.default_rng(0)
    for k, shape in (("model.mm_projector.weight", (32, 32)),
                     ("model.mm_projector.bias", (32,)),
                     ("model.text_hidden_fcs.0.0.weight", (32, 32)),
                     ("model.text_hidden_fcs.0.0.bias", (32,)),
                     ("model.text_hidden_fcs.0.2.weight", (16, 32)),
                     ("model.text_hidden_fcs.0.2.bias", (16,))):
        merged[k] = rng.standard_normal(shape).astype(np.float32)
    merged.update({"model.visual_model." + k: v for k, v in sam_orig.items()})
    merged.update({"model.vision_tower.vision_tower." + k: v
                   for k, v in clip.items()})
    return sam, sam_orig, clip, llama, merged


def same_tree(got, want):
    g, w = traverse_util.flatten_dict(got), traverse_util.flatten_dict(want)
    assert set(g) == set(w) and g
    for k, v in w.items():
        assert g[k].dtype == np.asarray(v).dtype, k
        assert np.array_equal(g[k], np.asarray(v)), k


def same_state_dict(got, want):
    assert set(got) == set(want) and got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", ["sam_hf", "sam_orig", "sam_single_decoder",
                                  "clip", "llama", "2haff"])
def test_conversions_equal_jax(state_dicts, kind):
    sam, sam_orig, clip, llama, merged = state_dicts
    call = {
        "sam_hf": lambda M: M.convert_sam(M.hf_sam_to_original(sam), depth=2),
        "sam_orig": lambda M: M.convert_sam(sam_orig, depth=2),
        "sam_single_decoder": lambda M: M.convert_sam(
            sam_orig, depth=2, dup_decoders=False),
        "clip": lambda M: M.convert_clip(clip, 2),
        "llama": lambda M: M.convert_llama(llama, 2),
        "2haff": lambda M: M.convert_2haff(merged, llama_layers=2,
                                           sam_depth=2),
    }[kind]
    got, want = call(TC), call(JC)
    same_tree(got, want)
    same_state_dict(TC.to_state_dict(got), flax_to_state_dict(want))


def test_transposes_and_hf_rename_equal_jax(state_dicts):
    rng = np.random.default_rng(3)
    lin, conv = rng.standard_normal((5, 7)), rng.standard_normal((4, 3, 2, 2))
    for t in ("t_linear", "t_conv", "t_convT"):
        x = lin if t == "t_linear" else conv
        assert np.array_equal(getattr(TC, t)(x), getattr(JC, t)(x))
    sam = state_dicts[0]
    assert TC.hf_sam_to_original(sam).keys() == JC.hf_sam_to_original(
        sam).keys()


def test_load_state_dict_from_files(state_dicts, tmp_path):
    """.pth (with and without a "state_dict" wrapper) and .safetensors."""
    clip = state_dicts[2]
    tensors = {k: torch.from_numpy(v) for k, v in clip.items()}
    torch.save(tensors, tmp_path / "a.pth")
    torch.save({"state_dict": tensors}, tmp_path / "b.pth")
    from safetensors.numpy import save_file

    save_file(clip, str(tmp_path / "c.safetensors"))
    for name in ("a.pth", "b.pth", "c.safetensors"):
        got = TC.load_state_dict(str(tmp_path / name))
        want = JC.load_state_dict(str(tmp_path / name))
        assert got.keys() == want.keys() == clip.keys()
        for k in clip:
            assert np.array_equal(got[k], want[k])


def test_merge_into_init_sam_equal_jax(state_dicts, capsys):
    """A stock SAM checkpoint over the port's Sam (the test_sam_parity
    tiny geometry): converted weights land where JAX's merge puts them,
    the taxonomy head (absent in stock SAM) keeps its init, keys without a
    home are reported, and a shape mismatch raises."""
    import jax
    import jax.numpy as jnp

    from haff_tpu.core.config import SamDecoderConfig as JDec
    from haff_tpu.core.config import SamEncoderConfig as JEnc
    from haff_tpu.nn.sam import Sam as JaxSam
    from haff_tpu_torch.core.config import SamDecoderConfig, SamEncoderConfig
    from haff_tpu_torch.nn.sam import Sam
    from haff_tpu_torch.tools.bridge import load_jax_params

    enc = dict(image_size=64, patch_size=16, embed_dim=32, depth=2,
               num_heads=2, mlp_ratio=2.0, out_chans=32, window_size=2,
               global_attn_indexes=(1,))
    dec = dict(prompt_embed_dim=32, transformer_mlp_dim=64,
               iou_head_hidden_dim=32)
    jsam = JaxSam(encoder_cfg=JEnc(**enc), decoder_cfg=JDec(**dec))
    init = jax.jit(jsam.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)),
                              jnp.zeros((1, 1, 32)))["params"]
    conv = TC.convert_sam(state_dicts[1], depth=2)
    conv["image_encoder"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    want = flax_to_state_dict(JC.merge_into_init(init, conv))
    model = load_jax_params(Sam(SamEncoderConfig(**enc),
                                SamDecoderConfig(**dec)), init)
    # a Sam is the whole model here: its converted tree is the top level
    assert TC.merge_into_init(model, conv) is model
    assert "1 checkpoint keys without a home" in capsys.readouterr().out
    same_state_dict(model.state_dict(), want)
    assert any("taxonomy" in k for k in want)
    conv["image_encoder"]["pos_embed"] = np.zeros((1, 3, 3, 32), np.float32)
    with pytest.raises(ValueError, match="shape mismatches"):
        TC.merge_into_init(model, conv)


def test_train_cli_vision_pretrained_and_reset_mask_decoder(tmp_path):
    """`--vision_pretrained` (train/cli.py `build_model`): a raw SAM .pth
    at the tiny preset's geometry overlays the seeded model, its single
    mask decoder duplicated into both, the taxonomy head kept from the
    init; `--reset_mask_decoder` then draws both decoders afresh from seed
    + 7, the same on every build."""
    from transformers import SamConfig, SamModel

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.train.cli import build_model

    cfg = SamConfig()
    v, p, m = (cfg.vision_config, cfg.prompt_encoder_config,
               cfg.mask_decoder_config)
    v.hidden_size, v.num_hidden_layers, v.num_attention_heads = 32, 2, 2
    v.mlp_dim, v.image_size, v.patch_size, v.window_size = 128, 128, 16, 4
    v.global_attn_indexes, v.output_channels, v.num_pos_feats = [1], 32, 16
    p.hidden_size, p.image_size, p.patch_size = 32, 128, 16
    p.image_embedding_size, p.mask_input_channels = 8, 4
    m.hidden_size, m.mlp_dim, m.iou_head_hidden_dim = 32, 64, 32
    m.num_attention_heads = 2
    torch.manual_seed(4)
    sd = JC.hf_sam_to_original({k: t.detach() for k, t in
                                SamModel(cfg).state_dict().items()})
    torch.save(sd, tmp_path / "sam.pth")
    want = TC.to_state_dict(TC.convert_sam(
        {k: t.numpy() for k, t in sd.items()}, depth=2), "visual_model")
    tiny = ModelConfig.preset("tiny")
    plain = build_model(tiny, "fp32", "cpu", 3).state_dict()
    model = build_model(tiny, "fp32", "cpu", 3,
                        vision_pretrained=str(tmp_path / "sam.pth"))
    got = model.state_dict()
    assert set(want) < set(got)
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    kept = [k for k in got if k not in want]
    assert any("taxonomy" in k for k in kept)
    assert all(torch.equal(got[k], plain[k]) for k in kept)
    reset = [build_model(tiny, "fp32", "cpu", 3, vision_pretrained=str(
        tmp_path / "sam.pth"), reset_mask_decoder=True).state_dict()
        for _ in range(2)]
    dec = [k for k in got if ".mask_decoder_" in k]
    assert dec and all(torch.equal(reset[0][k], reset[1][k]) for k in got)
    drawn = [k for k in dec if k.endswith("proj.weight")]  # not norms
    assert drawn and not any(torch.equal(reset[0][k], want[k])
                             for k in drawn)
    enc = [k for k in want if "image_encoder" in k]
    assert all(torch.equal(reset[0][k], want[k]) for k in enc)
