"""The system under test, set up from a configuration file: the port's
config objects, its models with the benchmark's seeded weights, and its
entry points. Everything of `haff_tpu_torch` that a driver touches goes
through here.
"""

from __future__ import annotations

import torch

from . import weights


def sam_configs(sam: dict):
    from haff_tpu_torch.core.config import SamDecoderConfig, SamEncoderConfig

    enc = dict(sam["encoder"])
    enc["global_attn_indexes"] = tuple(enc["global_attn_indexes"])
    return SamEncoderConfig(**enc), SamDecoderConfig(**sam["decoder"])


def lisa_config(cfg: dict, seg_token_idx: int):
    """The port's ModelConfig for a LISA-with-MPT configuration. The port
    builds MPT from the LLaMA config's widths with MptConfig's defaults
    for the rest; a configuration that differs there cannot run as it
    states, so it raises."""
    from haff_tpu_torch.core.config import (ClipVisionConfig, LlamaConfig,
                                            ModelConfig)
    from haff_tpu_torch.nn.mpt import MptConfig

    mpt, clip = cfg["mpt"], cfg["clip"]
    attn = mpt["attn_config"]
    fixed = MptConfig()
    want = dict(expansion_ratio=mpt["expansion_ratio"],
                alibi_bias_max=attn["alibi_bias_max"],
                multiquery=attn["attn_type"] == "multiquery_attention",
                clip_qkv=attn["clip_qkv"], qk_ln=attn["qk_ln"],
                prefix_lm=attn["prefix_lm"],
                layer_norm_eps=mpt["layer_norm_eps"])
    for k, v in want.items():
        if getattr(fixed, k) != v:
            raise ValueError(f"the port's MPT takes {k}={getattr(fixed, k)!r}, "
                             f"the configuration states {v!r}")
    if not (attn["alibi"] and mpt["no_bias"] and mpt["tie_word_embeddings"]):
        raise ValueError("the port's MPT is ALiBi, bias-free and tied")
    d, nh = mpt["d_model"], mpt["n_heads"]
    llama = LlamaConfig(vocab_size=mpt["vocab_size"], hidden_size=d,
                        intermediate_size=mpt["expansion_ratio"] * d,
                        num_layers=mpt["n_layers"], num_heads=nh,
                        num_kv_heads=nh, head_dim=d // nh,
                        max_seq_len=mpt["max_seq_len"])
    vision = ClipVisionConfig(
        image_size=clip["image_size"], patch_size=clip["patch_size"],
        hidden_size=clip["hidden_size"],
        intermediate_size=clip["intermediate_size"],
        num_layers=clip["num_hidden_layers"],
        num_heads=clip["num_attention_heads"],
        select_layer=clip["select_layer"],
        layer_norm_eps=clip["layer_norm_eps"])
    enc, dec = sam_configs(cfg["sam"])
    return ModelConfig(llama=llama, clip=vision, sam_encoder=enc,
                       sam_decoder=dec, out_dim=cfg["lisa"]["out_dim"],
                       seg_token_idx=seg_token_idx, decoder="mpt")


def dtype_of(cfg: dict):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


def seg_special(cfg: dict, seg_token_idx: int):
    return {"llm.wte.weight": (seg_token_idx, cfg["lisa"]["seg_row_scale"])}


def lisa_model(cfg: dict, seed: int, device, seg_token_idx: int):
    """The port's LisaModel, allocated on `device` in the configuration's
    dtype and filled with the benchmark's seeded weights."""
    from haff_tpu_torch.model.lisa import LisaModel

    model = LisaModel(lisa_config(cfg, seg_token_idx), dtype_of(cfg),
                      device="meta")
    model.to_empty(device=device)
    weights.load_into(model, weights.lisa_spec(cfg), seed,
                      seg_special(cfg, seg_token_idx))
    return model.eval()


def build_kernels(device, names) -> None:
    """Build (or reuse from the checkout's build/) the kernels a cell
    runs, all at once."""
    if torch.device(device).type == "cuda":
        from haff_tpu_torch.kernels import _build

        _build.build_all(tuple(names))


def lisa_predictor(model, cfg: dict, kv_cache_8bit: bool):
    """A `Predictor` bound to `model`: what `Predictor.__init__` sets,
    with the configuration's model. `Predictor.__init__` builds its
    model from a preset name, whose MPT takes LLaMA's vocabulary and
    sequence length, so the benchmark makes the same object around the
    model it built. Returns (predictor, its evaluate)."""
    from haff_tpu_torch.data.tokenizer import load_tokenizer
    from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
    from haff_tpu_torch.infer.predictor import Predictor

    lisa = cfg["lisa"]
    p = Predictor.__new__(Predictor)
    p.tok = load_tokenizer(None, model_max_length=lisa["max_text_len"])
    p.cfg = model.cfg
    p.max_text_len = lisa["max_text_len"]
    p.conv_type = lisa["conv_type"]
    p.use_mm_start_end = lisa["use_mm_start_end"]
    p.use_template = True
    p.model = model
    p._eval = make_jitted_evaluate(model, max_new_tokens=lisa["max_new_tokens"],
                                   eos_id=p.tok.eos_token_id,
                                   kv_cache_8bit=kv_cache_8bit)
    return p, p._eval


def seg_token_index() -> int:
    from haff_tpu_torch.data.tokenizer import load_tokenizer, seg_token_idx

    return seg_token_idx(load_tokenizer(None))


def on_generation(fn) -> None:
    """Call `fn(gen)` with each generation the LISA evaluate finishes
    (`infer/evaluate._finish`'s `GenerateResult`: the served tokens and
    the hidden state that emitted each, on the eager and the graphed
    path alike), just before its [SEG] gather. A later call replaces
    the earlier `fn`."""
    from haff_tpu_torch.infer import evaluate

    inner = getattr(evaluate._finish, "__wrapped__", evaluate._finish)

    def _finish(model, gen, *args, **kwargs):
        fn(gen)
        return inner(model, gen, *args, **kwargs)

    _finish.__wrapped__ = inner
    evaluate._finish = _finish
