"""Seeded random weights, made on the card, for the program and the
reference alike.

`lisa_spec(cfg)` and `sam_spec(cfg)` list every parameter of a
configuration as (name, shape, kind), named as the program's parameters
are and in a fixed order. `stream` draws one normal stream from a
`torch.Generator` seeded with the run's seed, in chunks of 2^26 values
(a few large calls), and hands each parameter its slice, scaled by its
kind:

    dense   N(0, 1 / fan_in)   linear and convolution weights
    bias    N(0, 0.1^2)
    norm_w  1 + N(0, 0.1^2)    norm_b N(0, 0.1^2)
    table   N(0, 0.1^2)        rel-pos tables, position embeddings
    token   N(0, 1)            SAM's learned tokens and PE matrix
    embed   N(0, 0.02^2)       the word embedding (MPT's tied head)

Every value is rounded to the served dtype first, so the reference's
float32 copy holds exactly the weights the program serves. The [SEG] row
of the word embedding is drawn `seg_row_scale` times larger, so that
the random model emits [SEG] as a trained one does and the [SEG] gather
and projection lie on the path.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 26
STD = {"bias": 0.1, "norm_w": 0.1, "norm_b": 0.1, "table": 0.1,
       "token": 1.0, "embed": 0.02}

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _linear(spec, name, n_in, n_out, bias=True):
    spec.append((name + ".weight", (n_out, n_in), "dense"))
    if bias:
        spec.append((name + ".bias", (n_out,), "bias"))


def _norm(spec, name, dim, bias=True):
    spec.append((name + ".weight", (dim,), "norm_w"))
    if bias:
        spec.append((name + ".bias", (dim,), "norm_b"))


def _conv(spec, name, n_in, n_out, k, bias=True, transpose=False):
    shape = (n_in, n_out, k, k) if transpose else (n_out, n_in, k, k)
    spec.append((name + ".weight", shape, "dense_t" if transpose else "dense"))
    if bias:
        spec.append((name + ".bias", (n_out,), "bias"))


def sam_spec(sam: dict, prefix: str = "") -> Spec:
    """SAM image encoder, prompt encoder and the two mask decoders."""
    enc, dec = sam["encoder"], sam["decoder"]
    s: Spec = []
    p = prefix + "image_encoder."
    c, g = enc["embed_dim"], enc["image_size"] // enc["patch_size"]
    hd = c // enc["num_heads"]
    s.append((p + "pos_embed", (1, g, g, c), "table"))
    _conv(s, p + "patch_embed", 3, c, enc["patch_size"])
    for i in range(enc["depth"]):
        b = f"{p}blocks.{i}."
        w = g if i in enc["global_attn_indexes"] else enc["window_size"]
        _norm(s, b + "norm1", c)
        s.append((b + "attn.rel_pos_h", (2 * w - 1, hd), "table"))
        s.append((b + "attn.rel_pos_w", (2 * w - 1, hd), "table"))
        _linear(s, b + "attn.qkv", c, 3 * c)
        _linear(s, b + "attn.proj", c, c)
        _norm(s, b + "norm2", c)
        _linear(s, b + "mlp.lin1", c, int(c * enc["mlp_ratio"]))
        _linear(s, b + "mlp.lin2", int(c * enc["mlp_ratio"]), c)
    oc = enc["out_chans"]
    _conv(s, p + "neck_conv1", c, oc, 1, bias=False)
    _norm(s, p + "neck_ln1", oc)
    _conv(s, p + "neck_conv2", oc, oc, 3, bias=False)
    _norm(s, p + "neck_ln2", oc)

    d, mc = dec["prompt_embed_dim"], dec["mask_in_chans"]
    p = prefix + "prompt_encoder."
    s.append((p + "point_embeddings", (4, d), "token"))
    s.append((p + "not_a_point_embed", (1, d), "token"))
    s.append((p + "no_mask_embed", (1, d), "token"))
    s.append((p + "pe_layer.positional_encoding_gaussian_matrix", (2, d // 2),
              "token"))
    _conv(s, p + "mask_conv1", 1, mc // 4, 2)
    _norm(s, p + "mask_ln1", mc // 4)
    _conv(s, p + "mask_conv2", mc // 4, mc, 2)
    _norm(s, p + "mask_ln2", mc)
    _conv(s, p + "mask_conv3", mc, d, 1)

    n = dec["num_multimask_outputs"] + 1
    di = d // dec["attention_downsample_rate"]
    for side, taxonomy in (("left", True), ("right", False)):
        p = f"{prefix}mask_decoder_{side}."
        s.append((p + "iou_token", (1, d), "token"))
        s.append((p + "mask_tokens", (n, d), "token"))

        def attn(name, inner):
            for proj in ("q_proj", "k_proj", "v_proj"):
                _linear(s, f"{name}.{proj}", d, inner)
            _linear(s, name + ".out_proj", inner, d)

        for i in range(dec["transformer_depth"]):
            b = f"{p}transformer.layers.{i}."
            attn(b + "self_attn", d)
            _norm(s, b + "norm1", d)
            attn(b + "cross_attn_token_to_image", di)
            _norm(s, b + "norm2", d)
            _linear(s, b + "mlp.lin1", d, dec["transformer_mlp_dim"])
            _linear(s, b + "mlp.lin2", dec["transformer_mlp_dim"], d)
            _norm(s, b + "norm3", d)
            attn(b + "cross_attn_image_to_token", di)
            _norm(s, b + "norm4", d)
        attn(p + "transformer.final_attn_token_to_image", di)
        _norm(s, p + "transformer.norm_final_attn", d)
        _conv(s, p + "upscale_conv1", d, d // 4, 2, transpose=True)
        _norm(s, p + "upscale_ln", d // 4)
        _conv(s, p + "upscale_conv2", d // 4, d // 8, 2, transpose=True)
        for m in range(n):
            dims = [d, d, d, d // 8]
            for j in range(3):
                _linear(s, f"{p}hyper_mlps.{m}.layers.{j}", dims[j], dims[j + 1])
        h = dec["iou_head_hidden_dim"]
        dims = [d] + [h] * (dec["iou_head_depth"] - 1) + [n]
        for j in range(dec["iou_head_depth"]):
            _linear(s, f"{p}iou_head.layers.{j}", dims[j], dims[j + 1])
        if taxonomy:
            dims = [d * n, d * n, d * n, dec["taxonomy_classes"]]
            for j in range(3):
                _linear(s, f"{p}taxonomy_embed.layers.{j}", dims[j], dims[j + 1])
    return s


def lisa_spec(cfg: dict) -> Spec:
    """The LISA model with the MPT decoder: MPT, CLIP tower, projector,
    SAM with both decoders, the [SEG] projection."""
    mpt, clip = cfg["mpt"], cfg["clip"]
    d = mpt["d_model"]
    s: Spec = [("llm.wte.weight", (mpt["vocab_size"], d), "embed")]
    for i in range(mpt["n_layers"]):
        b = f"llm.blocks.{i}."
        _norm(s, b + "norm_1", d, bias=False)
        _linear(s, b + "attn.Wqkv", d, 3 * d, bias=False)
        _linear(s, b + "attn.out_proj", d, d, bias=False)
        _norm(s, b + "norm_2", d, bias=False)
        _linear(s, b + "up_proj", d, mpt["expansion_ratio"] * d, bias=False)
        _linear(s, b + "down_proj", mpt["expansion_ratio"] * d, d, bias=False)
    _norm(s, "llm.norm_f", d, bias=False)

    e, p = clip["hidden_size"], "vision_tower."
    patches = (clip["image_size"] // clip["patch_size"]) ** 2
    s.append((p + "class_embedding", (e,), "table"))
    s.append((p + "position_embedding", (patches + 1, e), "table"))
    _conv(s, p + "patch_embedding", 3, e, clip["patch_size"], bias=False)
    _norm(s, p + "pre_layrnorm", e)
    for i in range(clip["num_hidden_layers"] + clip["select_layer"] + 1):
        b = f"{p}layers.{i}."
        _norm(s, b + "layer_norm1", e)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(s, b + "self_attn." + proj, e, e)
        _norm(s, b + "layer_norm2", e)
        _linear(s, b + "fc1", e, clip["intermediate_size"])
        _linear(s, b + "fc2", clip["intermediate_size"], e)
    _linear(s, "mm_projector", e, d)
    s += sam_spec(cfg["sam"], "visual_model.")
    _linear(s, "text_fc1", d, d)
    _linear(s, "text_fc2", d, cfg["lisa"]["out_dim"])
    return s


def _scale(kind: str, shape) -> Tuple[float, float]:
    """(mean, std) of a parameter of this kind and shape."""
    if kind == "dense":
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if kind == "dense_t":  # transposed convolution (in, out, k, k), stride k
        return 0.0, 1.0 / math.sqrt(shape[0])
    return (1.0 if kind == "norm_w" else 0.0), STD[kind]


def stream(spec: Spec, seed: int, device, dtype, out_dtype=None,
           special: Dict[str, Tuple[int, float]] = None
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) for every parameter of `spec`: values drawn
    from one seeded normal stream on `device`, scaled by kind, rounded to
    `dtype`, returned as `out_dtype` (default `dtype`). `special` maps a
    name to (row, factor): that row is scaled by `factor` more."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out_dtype = out_dtype or dtype
    buf, pos = None, CHUNK
    for name, shape, kind in spec:
        n = math.prod(shape)
        mean, std = _scale(kind, shape)
        t = torch.empty(n, dtype=out_dtype, device=device)
        done = 0
        while done < n:
            if pos == CHUNK:
                buf = torch.randn(CHUNK, generator=g, device=device)
                pos = 0
            take = min(n - done, CHUNK - pos)
            piece = buf[pos:pos + take] * std + mean
            t[done:done + take] = piece.to(dtype).to(out_dtype)
            done += take
            pos += take
        t = t.view(shape)
        if special and name in special:
            row, factor = special[name]
            t[row] = (t[row].float() * factor).to(dtype).to(out_dtype)
        yield name, t


def load_into(model: torch.nn.Module, spec: Spec, seed: int, special=None):
    """Fill every parameter of `model` (allocated, on its device) from the
    stream; raise unless the spec names exactly its parameters, shapes
    included."""
    params = dict(model.named_parameters())
    want = {n: tuple(s) for n, s, _ in spec}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(n for n in set(want) & set(have) if want[n] != have[n])[:5]
        raise ValueError(f"weight spec and model disagree: spec only {missing}, "
                         f"model only {extra}, shapes {shapes}")
    some = next(iter(params.values()))
    with torch.no_grad():
        for name, t in stream(spec, seed, some.device, some.dtype,
                              special=special):
            params[name].copy_(t)


def reference_weights(spec: Spec, seed: int, device, served_dtype,
                      special=None) -> Dict[str, torch.Tensor]:
    """The same weights as float32 tensors, for the reference."""
    return dict(stream(spec, seed, device, served_dtype, torch.float32,
                       special))
