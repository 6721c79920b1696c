"""LISA with the DeepSeek-V3 decoder (a configuration whose decoder keys
sit at the top level under their published names, e.g. Moonlight-16B-A3B's
config.json): the port's config and model, and the seeded weights for
the program and the reference alike.

The weights follow portbench/weights.py: one seeded normal stream, each
parameter scaled by its kind and rounded to the served dtype; the CLIP
tower, projector, SAM and [SEG] projection as `weights.lisa_spec` lists
them at the decoder's hidden size. The decoder's own kinds:

    dense    N(0, 1 / fan_in)   projections, the router, the untied head
    expert   N(0, 1 / fan_in)   stacked expert weights (E, out, in)
    bias     N(0, 0.1^2)        the router's correction bias
    norm_w   1 + N(0, 0.1^2)    embed  N(0, 0.02^2)

The [SEG] row of the untied head is drawn `seg_row_scale` times larger,
so that the random model serves [SEG] and the [SEG] gather and
projection lie on the path.
"""

from __future__ import annotations

import copy
import math

import torch

from . import port, weights

def is_deepseek(cfg: dict) -> bool:
    return cfg.get("model_type") == "deepseek_v3"


def decoder_config(cfg: dict):
    """The port's DeepseekV3Config for the configuration; raises where
    the configuration states what the port's decoder does not compute."""
    from haff_tpu_torch.nn.deepseek_v3 import DeepseekV3Config

    fixed = dict(q_lora_rank=None, scoring_func="sigmoid",
                 topk_method="noaux_tc", n_group=1, topk_group=1,
                 norm_topk_prob=True, tie_word_embeddings=False,
                 hidden_act="silu", attention_bias=False, moe_layer_freq=1,
                 num_nextn_predict_layers=0)
    for k, v in fixed.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"the port's deepseek_v3 decoder takes {k}={v!r}, "
                             f"the configuration states {cfg[k]!r}")
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("MLA's heads share one latent: num_key_value_heads "
                         "must equal num_attention_heads")
    return DeepseekV3Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_routed_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        norm_topk_prob=cfg["norm_topk_prob"],
        rope_theta=float(cfg["rope_theta"]),
        rms_norm_eps=cfg["rms_norm_eps"],
        max_seq_len=cfg["max_position_embeddings"])


def lisa_config(cfg: dict, seg_token_idx: int):
    """The port's ModelConfig: the MPT configuration's CLIP, SAM and LISA
    parts (port.lisa_config) around this decoder."""
    mpt_like = copy.deepcopy(cfg)
    mpt_like["mpt"] = _mpt_stub(cfg)
    base = port.lisa_config(mpt_like, seg_token_idx)
    return base.replace(llama=decoder_config(cfg), decoder="deepseek_v3")


def _mpt_stub(cfg: dict) -> dict:
    """An MPT section at the decoder's hidden size and no layers: what
    port.lisa_config and weights.lisa_spec read for the parts around the
    decoder."""
    d = cfg["hidden_size"]
    return {"d_model": d, "n_heads": 1, "n_layers": 0, "expansion_ratio": 4,
            "max_seq_len": cfg["max_position_embeddings"],
            "vocab_size": cfg["vocab_size"], "no_bias": True,
            "tie_word_embeddings": True, "layer_norm_eps": 1e-5,
            "attn_config": {"attn_type": "multihead_attention", "alibi": True,
                            "alibi_bias_max": 8, "clip_qkv": None,
                            "qk_ln": False, "prefix_lm": False}}


def decoder_spec(cfg: dict) -> weights.Spec:
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rp, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    e, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    s: weights.Spec = [("llm.embed_tokens.weight", (cfg["vocab_size"], d),
                        "embed")]
    lin = weights._linear
    for i in range(cfg["num_hidden_layers"]):
        b = f"llm.layers.{i}."
        s.append((b + "input_layernorm.weight", (d,), "norm_w"))
        lin(s, b + "self_attn.q_proj", d, nh * (nope + rp), bias=False)
        lin(s, b + "self_attn.kv_a_proj_with_mqa", d, rank + rp, bias=False)
        s.append((b + "self_attn.kv_a_layernorm.weight", (rank,), "norm_w"))
        lin(s, b + "self_attn.kv_b_proj", rank, nh * (nope + vd), bias=False)
        lin(s, b + "self_attn.o_proj", nh * vd, d, bias=False)
        s.append((b + "post_attention_layernorm.weight", (d,), "norm_w"))
        if i < cfg["first_k_dense_replace"]:
            for name, n_in, n_out in (("gate_proj", d, cfg["intermediate_size"]),
                                      ("up_proj", d, cfg["intermediate_size"]),
                                      ("down_proj", cfg["intermediate_size"], d)):
                lin(s, b + "mlp." + name, n_in, n_out, bias=False)
            continue
        s.append((b + "mlp.gate.weight", (e, d), "dense"))
        s.append((b + "mlp.gate.e_score_correction_bias", (e,), "bias"))
        s.append((b + "mlp.gate_proj", (e, fe, d), "expert"))
        s.append((b + "mlp.up_proj", (e, fe, d), "expert"))
        s.append((b + "mlp.down_proj", (e, d, fe), "expert"))
        fs = fe * cfg["n_shared_experts"]
        for name, n_in, n_out in (("gate_proj", d, fs), ("up_proj", d, fs),
                                  ("down_proj", fs, d)):
            lin(s, b + "mlp.shared_experts." + name, n_in, n_out, bias=False)
    s.append(("llm.norm.weight", (d,), "norm_w"))
    lin(s, "llm.lm_head", d, cfg["vocab_size"], bias=False)
    return s


def lisa_spec(cfg: dict) -> weights.Spec:
    """Every parameter of LISA with this decoder, named as the program's."""
    mpt_like = dict(cfg, mpt=_mpt_stub(cfg))
    rest = [p for p in weights.lisa_spec(mpt_like) if not p[0].startswith("llm.")]
    return decoder_spec(cfg) + rest


def seg_special(cfg: dict, seg_token_idx: int):
    return {"llm.lm_head.weight": (seg_token_idx, cfg["lisa"]["seg_row_scale"])}


def _scale(kind, shape):
    if kind == "expert":
        return 0.0, 1.0 / math.sqrt(shape[-1])
    return weights._scale(kind, shape)


def stream(spec, seed, device, dtype, out_dtype=None, special=None):
    """weights.stream with the `expert` kind: (name, tensor) for every
    parameter of `spec` from one seeded normal stream on `device`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out_dtype = out_dtype or dtype
    buf, pos = None, weights.CHUNK
    for name, shape, kind in spec:
        n = math.prod(shape)
        mean, std = _scale(kind, shape)
        t = torch.empty(n, dtype=out_dtype, device=device)
        done = 0
        while done < n:
            if pos == weights.CHUNK:
                buf = torch.randn(weights.CHUNK, generator=g, device=device)
                pos = 0
            take = min(n - done, weights.CHUNK - pos)
            t[done:done + take] = (buf[pos:pos + take] * std + mean).to(
                dtype).to(out_dtype)
            done += take
            pos += take
        t = t.view(shape)
        if special and name in special:
            row, factor = special[name]
            t[row] = (t[row].float() * factor).to(dtype).to(out_dtype)
        yield name, t


def lisa_model(cfg: dict, seed: int, device, seg_token_idx: int):
    """The port's LisaModel with this decoder on `device`, in the
    configuration's dtype, filled from the stream."""
    from haff_tpu_torch.model.lisa import LisaModel

    model = LisaModel(lisa_config(cfg, seg_token_idx), port.dtype_of(cfg),
                      device="meta")
    model.to_empty(device=device)
    spec = lisa_spec(cfg)
    params = dict(model.named_parameters())
    want = {n: tuple(s) for n, s, _ in spec}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        raise ValueError(f"weight spec and model disagree: spec only "
                         f"{sorted(set(want) - set(have))[:5]}, model only "
                         f"{sorted(set(have) - set(want))[:5]}")
    with torch.no_grad():
        for name, t in stream(spec, seed, device, port.dtype_of(cfg),
                              special=seg_special(cfg, seg_token_idx)):
            params[name].copy_(t)
    return model.eval()


def reference_weights(cfg: dict, seed: int, device, seg_token_idx: int):
    """The same weights for the reference: the decoder's in the served
    dtype, which the reference takes to float32 at use (their values are
    the served dtype's, so exactly), the rest as float32 tensors."""
    out = {}
    for name, t in stream(lisa_spec(cfg), seed, device, port.dtype_of(cfg),
                          special=seg_special(cfg, seg_token_idx)):
        out[name] = t if name.startswith("llm.") else t.float()
    return out
