"""The benchmark's operation counts (flops/) agree with FlopCounterMode
on the program's modules at small shapes, where it sees the op (matrix
products, convolutions, einsums and the SAM attention operators by the
formula they register)."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import port, registry
from portbench.tests import tiny


def counted(fn, *args):
    for mod in [fn, *args, getattr(fn, "__self__", None)]:
        if isinstance(mod, torch.nn.Module):
            mod.requires_grad_(False)
    with FlopCounterMode(display=False) as c, torch.no_grad():
        fn(*args)
    return c.get_total_flops()


def test_clip_vit():
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = tiny.lisa_cfg()
    model = LisaModel(port.lisa_config(cfg, 260), torch.float32, device="cpu")
    x = torch.randn(2, 32, 32, 3)
    got = counted(model.encode_clip, x)
    assert got == registry.flops("clip_vit").count(
        cfg["clip"], cfg["mpt"]["d_model"], batch=2)["flops"]


@pytest.mark.parametrize("length", [7, 33])
def test_mpt_forward_full_attention(length):
    """The plain attention computes every (query, key) pair: context ==
    positions. The benchmark counts the causal half in the prefill."""
    from haff_tpu_torch.nn.mpt import MptConfig, MptForCausalLM

    cfg = tiny.lisa_cfg()["mpt"]
    m = MptForCausalLM(MptConfig(vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
                                 n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
                                 attn_impl="torch"))
    x = torch.randn(1, length, cfg["d_model"])
    got = counted(m, x)
    assert got == registry.flops("mpt_forward").count(cfg, length, length, length)["flops"]


@pytest.mark.parametrize("image_size", [128, 160])
def test_sam_encoder(image_size):
    """160: a 10 x 10 grid, windows of 4 over a zero-padded 12 x 12 grid."""
    from haff_tpu_torch.nn.sam_image_encoder import SamImageEncoder

    sam = copy.deepcopy(tiny.TINY_SAM)
    sam["encoder"]["image_size"] = image_size
    enc_cfg, _ = port.sam_configs(sam)
    enc = SamImageEncoder(enc_cfg)
    x = torch.randn(1, image_size, image_size, 3)
    assert counted(enc, x) == registry.flops("sam_encoder").count(sam["encoder"])["flops"]


@pytest.mark.parametrize("prompt_tokens", [1, 4])
def test_sam_decoders(prompt_tokens):
    from haff_tpu_torch.nn.sam import Sam

    sam = copy.deepcopy(tiny.TINY_SAM)
    enc_cfg, dec_cfg = port.sam_configs(sam)
    m = Sam(enc_cfg, dec_cfg).requires_grad_(False)
    g = enc_cfg.grid_size
    d = dec_cfg.prompt_embed_dim
    emb = torch.randn(1, g, g, d)
    pe = m.prompt_encoder.get_dense_pe()[None]
    sparse = torch.randn(1, prompt_tokens, d)
    dense = torch.randn(1, g, g, d)

    def both():
        m.mask_decoder_left(emb, pe, sparse, dense)
        m.mask_decoder_right(emb, pe, sparse, dense)

    assert counted(both) == registry.flops("sam_decoders").count(
        sam["encoder"], sam["decoder"], prompt_tokens)["flops"]


def test_sam_relpos_attn_matches_the_registered_formula():
    from haff_tpu_torch.kernels.sam_attention import sam_global_attention_qkv

    qkv = torch.randn(2, 64, 3 * 32)
    rel = torch.randn(15, 16)
    got = counted(sam_global_attention_qkv, qkv, rel, rel, (8, 8), 2)
    assert got == registry.flops("sam_relpos_attn").count(2, 64, 2, 16, 8, 8)["flops"]


def test_generate_is_prefill_plus_fed_back_tokens():
    mpt = tiny.lisa_cfg()["mpt"]
    fwd = registry.flops("mpt_forward").count
    want = fwd(mpt, 10, 5.5, 10)["flops"] + sum(
        fwd(mpt, 1, 10 + t, 1)["flops"] for t in range(1, 4))
    assert registry.flops("mpt_generate").count(mpt, 10, 4)["flops"] == want


def test_seg_projection():
    from torch import nn

    mlp = nn.Sequential(nn.Linear(64, 64), nn.ReLU(), nn.Linear(64, 32))
    assert counted(mlp, torch.randn(3, 64)) == \
        registry.flops("seg_projection").count(64, 32, batch=3)["flops"]
