"""SAM with the 2HandedAfforder dual mask decoders, plain float32.

From segment-anything (`modeling/image_encoder.py` ImageEncoderViT,
`prompt_encoder.py`, `mask_decoder.py`, `transformer.py`) and
2HandedAfforder's left decoder, which adds a 4-way taxonomy MLP over the
flattened mask tokens, softmaxed. NCHW inside, as the published code.
Activations are the published ones: exact (erf) GELU in the encoder MLP
and the upscaling, nn.LayerNorm's eps 1e-5 in the two-way transformer.

`W` is a dict of float32 tensors keyed by the program's parameter names
under `prefix` (e.g. "visual_model.").
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _lin(x, W, name):
    return F.linear(x, W[name + ".weight"], W.get(name + ".bias"))


def _ln(x, W, name, eps):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"],
                        W.get(name + ".bias"), eps)


def _ln2d(x, W, name, eps=1e-6):
    """LayerNorm2d over the channels of NCHW."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return W[name + ".weight"][:, None, None] * x + W[name + ".bias"][:, None, None]


# --------------------------------------------------------------- preprocess

def preprocess_shape(h: int, w: int, long_side: int = 1024):
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def preprocess(frame: np.ndarray, size: int = 1024):
    """uint8 RGB (H, W, 3) -> (1, 3, size, size) float32 normalized and
    zero-padded, and the resized (h, w): ResizeLongestSide through PIL's
    bilinear resize, then (x - mean) / std and padding, as SamPredictor."""
    from PIL import Image

    h, w = preprocess_shape(*frame.shape[:2], size)
    img = np.asarray(Image.fromarray(frame).resize((w, h), Image.BILINEAR))
    x = torch.as_tensor(img.astype(np.float32)).permute(2, 0, 1)[None]
    mean = torch.tensor(PIXEL_MEAN)[None, :, None, None]
    std = torch.tensor(PIXEL_STD)[None, :, None, None]
    x = (x - mean) / std
    return F.pad(x, (0, size - w, 0, size - h)), (h, w)


# ----------------------------------------------------------- image encoder

def _rel_pos(q_size, k_size, rel):
    """get_rel_pos for tables of the exact length."""
    q = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    idx = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel[idx.long().to(rel.device)]


def _attention(x, W, p, num_heads):
    """image_encoder.py Attention over x (B, H, W, C)."""
    b, h, w, c = x.shape
    hd = c // num_heads
    qkv = _lin(x, W, p + ".qkv").reshape(b, h * w, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * num_heads, h * w, hd)
    attn = torch.matmul(q * hd ** -0.5, k.transpose(-2, -1))
    rh = _rel_pos(h, h, W[p + ".rel_pos_h"])
    rw = _rel_pos(w, w, W[p + ".rel_pos_w"])
    r_q = q.reshape(b * num_heads, h, w, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(-1, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(-1, h * w, h * w)
    out = torch.matmul(attn.softmax(dim=-1), v)
    out = out.view(b, num_heads, h, w, hd).permute(0, 2, 3, 1, 4)
    return _lin(out.reshape(b, h, w, c), W, p + ".proj")


def _window_partition(x, ws):
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(x, ws, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w, :]


def image_encoder(x, W, enc, prefix="image_encoder."):
    """ImageEncoderViT: (B, 3, S, S) -> (B, out_chans, g, g)."""
    p = prefix
    x = F.conv2d(x, W[p + "patch_embed.weight"], W[p + "patch_embed.bias"],
                 stride=enc["patch_size"]).permute(0, 2, 3, 1)
    x = x + W[p + "pos_embed"]
    for i in range(enc["depth"]):
        b = f"{p}blocks.{i}"
        shortcut = x
        y = _ln(x, W, b + ".norm1", 1e-6)
        if i in enc["global_attn_indexes"]:
            y = _attention(y, W, b + ".attn", enc["num_heads"])
        else:
            ws = enc["window_size"]
            hw = y.shape[1:3]
            y, pad_hw = _window_partition(y, ws)
            y = _attention(y, W, b + ".attn", enc["num_heads"])
            y = _window_unpartition(y, ws, pad_hw, hw)
        x = shortcut + y
        y = _ln(x, W, b + ".norm2", 1e-6)
        x = x + _lin(F.gelu(_lin(y, W, b + ".mlp.lin1")), W, b + ".mlp.lin2")
    x = x.permute(0, 3, 1, 2)
    x = _ln2d(F.conv2d(x, W[p + "neck_conv1.weight"]), W, p + "neck_ln1")
    x = F.conv2d(x, W[p + "neck_conv2.weight"], padding=1)
    return _ln2d(x, W, p + "neck_ln2")


# ----------------------------------------------------------- prompt encoder

def _pe_encode(coords, W, p):
    coords = 2 * coords - 1
    coords = torch.matmul(coords, W[p + "pe_layer.positional_encoding_gaussian_matrix"])
    coords = 2 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_pe(W, grid, prefix="prompt_encoder."):
    """(1, C, g, g) positional encoding of the embedding grid."""
    ones = torch.ones((grid, grid), device=W[prefix + "no_mask_embed"].device)
    y = (ones.cumsum(0) - 0.5) / grid
    x = (ones.cumsum(1) - 0.5) / grid
    return _pe_encode(torch.stack([x, y], -1), W, prefix).permute(2, 0, 1)[None]


# ------------------------------------------------------------- mask decoder


def _tw_attention(q, k, v, W, p, num_heads):
    q, k, v = _lin(q, W, p + ".q_proj"), _lin(k, W, p + ".k_proj"), _lin(v, W, p + ".v_proj")
    b, n, c = q.shape
    sep = lambda t: t.reshape(b, t.shape[1], num_heads, c // num_heads).transpose(1, 2)  # noqa: E731
    q, k, v = sep(q), sep(k), sep(v)
    attn = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(c // num_heads)
    out = torch.matmul(attn.softmax(dim=-1), v)
    return _lin(out.transpose(1, 2).reshape(b, n, c), W, p + ".out_proj")


def _two_way(image_embedding, image_pe, point_embedding, W, p, dec):
    b, c, h, w = image_embedding.shape
    keys = image_embedding.flatten(2).permute(0, 2, 1)
    key_pe = image_pe.flatten(2).permute(0, 2, 1)
    queries = point_embedding
    nh = dec["transformer_num_heads"]
    for i in range(dec["transformer_depth"]):
        lp = f"{p}layers.{i}"
        if i == 0:
            queries = _tw_attention(queries, queries, queries, W, lp + ".self_attn", nh)
        else:
            q = queries + point_embedding
            queries = queries + _tw_attention(q, q, queries, W, lp + ".self_attn", nh)
        queries = _ln(queries, W, lp + ".norm1", 1e-5)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + _tw_attention(q, k, keys, W, lp + ".cross_attn_token_to_image", nh)
        queries = _ln(queries, W, lp + ".norm2", 1e-5)
        mlp = _lin(F.relu(_lin(queries, W, lp + ".mlp.lin1")), W, lp + ".mlp.lin2")
        queries = _ln(queries + mlp, W, lp + ".norm3", 1e-5)
        q, k = queries + point_embedding, keys + key_pe
        keys = keys + _tw_attention(k, q, queries, W, lp + ".cross_attn_image_to_token", nh)
        keys = _ln(keys, W, lp + ".norm4", 1e-5)
    q, k = queries + point_embedding, keys + key_pe
    queries = queries + _tw_attention(q, k, keys, W, p + "final_attn_token_to_image", nh)
    return _ln(queries, W, p + "norm_final_attn", 1e-5), keys


def _mlp(x, W, p, num_layers):
    for i in range(num_layers):
        x = _lin(x, W, f"{p}.layers.{i}")
        if i < num_layers - 1:
            x = F.relu(x)
    return x


def mask_decoder(image_embeddings, image_pe, sparse, dense, W, p, dec,
                 taxonomy: bool, multimask: bool = False):
    """MaskDecoder.predict_masks: -> (masks (B, k, 4g, 4g), iou (B, k),
    taxonomy probabilities (B, 4) or None)."""
    n = dec["num_multimask_outputs"] + 1
    b = sparse.shape[0]
    out_tokens = torch.cat([W[p + "iou_token"], W[p + "mask_tokens"]], 0)
    tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], 1)
    src = image_embeddings.expand(b, -1, -1, -1) + dense
    pos = image_pe.expand(b, -1, -1, -1)
    _, c, h, w = src.shape
    hs, src = _two_way(src, pos, tokens, W, p + "transformer.", dec)
    iou_out, mask_out = hs[:, 0], hs[:, 1:1 + n]
    src = src.transpose(1, 2).reshape(b, c, h, w)
    x = F.conv_transpose2d(src, W[p + "upscale_conv1.weight"],
                           W[p + "upscale_conv1.bias"], stride=2)
    x = F.gelu(_ln2d(x, W, p + "upscale_ln"))
    up = F.gelu(F.conv_transpose2d(x, W[p + "upscale_conv2.weight"],
                                   W[p + "upscale_conv2.bias"], stride=2))
    hyper = torch.stack([_mlp(mask_out[:, i], W, f"{p}hyper_mlps.{i}", 3)
                         for i in range(n)], 1)
    bb, cc, hh, ww = up.shape
    masks = torch.matmul(hyper, up.view(bb, cc, hh * ww)).view(bb, -1, hh, ww)
    iou = _mlp(iou_out, W, p + "iou_head", dec["iou_head_depth"])
    tax = None
    if taxonomy:
        tax = torch.softmax(_mlp(mask_out.reshape(b, -1), W,
                                 p + "taxonomy_embed", 3), dim=-1)
    sel = slice(1, None) if multimask else slice(0, 1)
    return masks[:, sel], iou[:, sel], tax


def postprocess(masks, input_hw, original_hw, size: int = 1024):
    """Low-res logits -> the canvas -> crop -> the frame's size."""
    x = F.interpolate(masks, (size, size), mode="bilinear", align_corners=False)
    x = x[..., :input_hw[0], :input_hw[1]]
    return F.interpolate(x, tuple(original_hw), mode="bilinear",
                         align_corners=False)


# ------------------------------------------------------------ whole model

@torch.no_grad()
def embed_image(frame, W, sam, device, prefix=""):
    """Preprocess and encode one frame: (embedding (1, C, g, g), dense PE,
    resized (h, w), the frame's (H, W))."""
    enc = sam["encoder"]
    x, hw = preprocess(frame, enc["image_size"])
    emb = image_encoder(x.to(device), W, enc, prefix + "image_encoder.")
    grid = enc["image_size"] // enc["patch_size"]
    pe = dense_pe(W, grid, prefix + "prompt_encoder.")
    return emb, pe, hw, frame.shape[:2]


@torch.no_grad()
def decode(image, sparse, W, sam, prefix=""):
    """Both decoders on one encoded frame, prompted by sparse embeddings
    (B, n, C), masks resized to the frame. Returns (left (B, 1, H, W),
    right, taxonomy (B, 4)) as numpy."""
    emb, pe, hw, orig = image
    size = sam["encoder"]["image_size"]
    b, grid = sparse.shape[0], emb.shape[-1]
    dense = W[prefix + "prompt_encoder.no_mask_embed"].reshape(1, -1, 1, 1)
    dense = dense.expand(b, -1, grid, grid)
    dec = sam["decoder"]
    ml, _, tax = mask_decoder(emb, pe, sparse, dense, W,
                              prefix + "mask_decoder_left.", dec, True)
    mr, _, _ = mask_decoder(emb, pe, sparse, dense, W,
                            prefix + "mask_decoder_right.", dec, False)
    ml = postprocess(ml, hw, orig, size)
    mr = postprocess(mr, hw, orig, size)
    return ml.cpu().numpy(), mr.cpu().numpy(), tax.cpu().numpy()
