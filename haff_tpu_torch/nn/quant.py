"""Weight and KV-cache quantization for serving (port of
haff_tpu/nn/quant.py): per-output-channel symmetric int8 weights with
dynamic per-token int8 activations (W8A8), group-wise packed-int4 weights
with float activations (W4A16), and per-slice int8 activations for the KV
cache.

Layout. The port stores a dense weight as `nn.Linear` does, (out, in), so
every quantized tensor here is the transpose of the JAX package's:

* int8:  values (out, in) int8, scale (out,) float32;
* int4:  packed (out, in/2) uint8, scale (out, in/group) float32; byte r
  of an output row holds input 2r in its low nibble and 2r+1 in its high
  one, each a signed 4-bit value (n > 7 means n - 16).

The quantization arithmetic is IEEE float32 element by element (amax/127
or amax/7, round half to even, clip), so values and scales equal the JAX
package's bit for bit on the same input.

Two hand-written CUDA kernels run the products on the card:

* `int8_matmul` -> csrc/w8a8_matmul.cu (`w8a8_matmul`), replacing
  haff_tpu/nn/quant.py `_w8a8_kernel`, for every M, on the path
  `w8a8_path` picks where K % 16 == 0 and the operands are 16-byte
  aligned: int8 warpgroup MMA fed by TMA (M > 16), or the streamed
  skinny kernel (M <= 16, decode); the rest (odd K, unaligned row blocks)
  takes the `dp4a` scalar kernels, whose launches also count under
  `w8a8_matmul/scalar`;
* `int4_matmul` -> csrc/w4a16_matmul.cu (`w4a16_matmul`), replacing
  `_w4a16_kernel`, for flattened M <= SMALL_M and group % 16 == 0, on the
  path `w4a16_path` picks: bf16 `mma.sync` with the weight dequantized in
  registers where 16-byte copies read every operand (every 4-bit product
  of LLaMA-7B), else the first port's scalar kernel (f32, odd widths),
  whose launches also count under `w4a16_matmul/scalar`; larger M
  (prefill) dequantizes the weight and calls `torch.matmul`, as the JAX
  package leaves that product to XLA.

CPU tensors take the plain versions (`int8_matmul_plain`,
`int4_matmul_plain`); CUDA tensors launch the kernel, with no fallback
between the two. Both wrappers are forward-only and raise when grad mode
is on and an input requires grad.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _build

_W8A8 = "w8a8_matmul"
_W4A16 = "w4a16_matmul"
# w8a8 kernel paths, as the C entry point numbers them.
W8A8_SCALAR, W8A8_WGMMA, W8A8_SKINNY = 0, 1, 2
W8A8_PATH_NAMES = ("scalar", "wgmma", "skinny")
SKINNY_M = 16  # the largest M of the skinny path
# w4a16 kernel paths, as the C entry point numbers them.
W4A16_SCALAR, W4A16_MMA = 0, 1
W4A16_PATH_NAMES = ("scalar", "mma")
# int4_matmul launches its kernel up to this flattened M (decode steps);
# above it (prefill) the dequantized weight goes to torch.matmul.
SMALL_M = 256
_LLM_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                    "up_proj", "down_proj", "lm_head", "Wqkv", "out_proj")


class QuantArray(NamedTuple):
    """int8 values + broadcastable float32 scales (the int8 KV cache)."""

    values: torch.Tensor
    scales: torch.Tensor


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def _symmetric(xf, amax, qmax: float, lo: float, hi: float):
    # Divide by a tensor on amax's device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, which is not the IEEE
    # quotient and would move a scale by an ulp against the CPU and JAX.
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / amax.new_full((), qmax))
    return torch.clamp(torch.round(xf / scale), lo, hi), scale


def quantize_activation(x, axis: int = -1) -> QuantArray:
    """Symmetric per-slice int8 over `axis` (per token-head for KV cache
    entries: head_dim is the reduced axis)."""
    xf = x.float()
    q, scale = _symmetric(xf, xf.abs().amax(dim=axis, keepdim=True), 127.0,
                          -127, 127)
    return QuantArray(values=q.to(torch.int8), scales=scale)


def dequantize_activation(qa: QuantArray, dtype=torch.bfloat16):
    return (qa.values.float() * qa.scales).to(dtype)


def quantize_kernel(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 values (out, in), float32 scales (out,))."""
    wf = w.float()
    q, scale = _symmetric(wf, wf.abs().amax(dim=1, keepdim=True), 127.0,
                          -127, 127)
    return q.to(torch.int8), scale[:, 0]


def dequantize_kernel(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[:, None]).to(dtype)


def quantize_kernel_int4(w, group: int = 64
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (packed uint8 (out, in/2), float32 scales
    (out, in/group)): group-wise symmetric int4 along the input dim, two
    signed nibbles a byte; in must divide by `group`."""
    wf = w.float()
    dout, din = wf.shape
    if din % group or group % 2:
        raise ValueError(f"in={din} does not divide by group={group}, or "
                         "the group is odd")
    g = wf.reshape(dout, din // group, group)
    q, scale = _symmetric(g, g.abs().amax(dim=2, keepdim=True), 7.0, -8, 7)
    q = q.to(torch.int32).reshape(dout, din)
    packed = (q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)
    return packed.to(torch.uint8), scale[:, :, 0]


def _unpack_int4(p) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed bytes -> (lo, hi) signed int32 nibble planes (the inverse of
    quantize_kernel_int4's `lo | hi << 4`)."""
    p = p.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    return (torch.where(lo > 7, lo - 16, lo),
            torch.where(hi > 7, hi - 16, hi))


def dequantize_kernel_int4(packed, scale, group: int = 64,
                           dtype=torch.bfloat16):
    """Inverse of quantize_kernel_int4: (out, in) in `dtype`, each value
    nibble * scale in float32, rounded once."""
    lo, hi = _unpack_int4(packed)
    dout, din2 = packed.shape
    q = torch.stack([lo, hi], dim=2).reshape(dout, 2 * din2)
    q = q.reshape(dout, scale.shape[1], group).float()
    return (q * scale[:, :, None]).reshape(dout, 2 * din2).to(dtype)


# ---------------------------------------------------------------------------
# Products: plain versions
# ---------------------------------------------------------------------------

def quantized_matmul(x, q, scale):
    """W8A16: x (.., in) @ int8 weight (out, in) cast to float, float32
    accumulation, per-channel rescale; plain PyTorch on every device (the
    JAX package has no kernel for it either)."""
    y = F.linear(x.float(), q.float())
    return (y * scale).to(x.dtype)


def _int_dot(xq, q):
    """int8 (M, K) x int8 (N, K) -> exact int32 (M, N). PyTorch multiplies
    integer matrices on the CPU only; on the card the plain version goes
    through float64, which is exact here (|sum| <= 127 * 127 * K < 2^53)."""
    if xq.is_cuda:
        return (xq.double() @ q.double().T).to(torch.int32)
    return xq.to(torch.int32) @ q.to(torch.int32).T


def int8_matmul_plain(xq, q, s_x, scale, dtype):
    """The w8a8 kernel's function in plain PyTorch: xq (M, K) int8,
    q (N, K) int8, s_x (M,) and scale (N,) float32 ->
    (int32 product * s_x * scale, in that order) in `dtype`, (M, N)."""
    acc = _int_dot(xq, q).float()
    return (acc * s_x[:, None] * scale[None, :]).to(dtype)


def int4_matmul_plain(x, packed, scale, group: int, dtype):
    """The w4a16 kernel's function in plain PyTorch: x (M, K), packed
    (N, K/2), scale (N, K/group) -> (M, N) in `dtype`; the weight is
    dequantized in float32 and rounded to `dtype`, products accumulate in
    float32."""
    w = dequantize_kernel_int4(packed, scale, group, dtype)
    return F.linear(x.to(dtype).float(), w.float()).to(dtype)


def int4_matmul_dequant(x, packed, scale, group: int, dtype):
    """The large-M (prefill) route on every device: dequantize one layer's
    weight to `dtype` and hand the product to torch.matmul."""
    return F.linear(x.to(dtype), dequantize_kernel_int4(packed, scale, group,
                                                        dtype))


# ---------------------------------------------------------------------------
# Products: kernel wrappers
# ---------------------------------------------------------------------------

def _forward_only(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the quantized product is forward-only (serving), and "
            "an input requires grad; run it under torch.no_grad()")


def _lib(source, symbol, argtypes):
    fn = getattr(_build.library(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _out_code(name, dtype) -> int:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: compute dtype {dtype}; need bfloat16 or "
                        "float32")
    return int(dtype == torch.bfloat16)


def w8a8_path(xq, q) -> int:
    """The path of a w8a8 launch on xq (M, K) and the weight q (N, K),
    both row-major int8. Where 16-byte copies can read both operands (K %
    16 == 0, TMA's stride rule, 16-byte aligned bases, rows contiguous):
    W8A8_SKINNY, the streamed kernel, for M <= SKINNY_M (decode), and
    W8A8_WGMMA above. W8A8_SCALAR, the `dp4a` scalar kernels, for the
    rest. Pure: shape, pointers and strides only, on any device."""
    m, k = xq.shape
    if (k % 16 == 0 and xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
            and xq.stride() == (k, 1) and q.stride() == (k, 1)):
        return W8A8_SKINNY if m <= SKINNY_M else W8A8_WGMMA
    return W8A8_SCALAR


def int8_matmul_kernel(xq, q, s_x, scale, dtype):
    """Launch csrc/w8a8_matmul.cu on `w8a8_path(xq, q)`: xq (M, K) int8,
    q (N, K) int8, s_x (M,) and scale (N,) float32 -> (M, N) in `dtype`.
    A launch on the scalar path also counts under `w8a8_matmul/scalar`."""
    m, k = xq.shape
    n = q.shape[0]
    check = _build.check_operand
    check(_W8A8, "xq", xq, torch.int8, (m, k))
    check(_W8A8, "weight", q, torch.int8, (n, k))
    check(_W8A8, "s_x", s_x, torch.float32, (m,))
    check(_W8A8, "scale", scale, torch.float32, (n,))
    code = _out_code(_W8A8, dtype)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _lib(_W8A8, _W8A8, [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp])
    out = torch.empty((m, n), dtype=dtype, device=xq.device)
    if m and n:
        path = w8a8_path(xq, q)
        ptr = _build.ptr
        err = fn(ptr(xq), ptr(q), ptr(s_x), ptr(scale), ptr(out), m, n, k,
                 code, path, _build.stream_handle(xq.device))
        _build.LAUNCHES[_W8A8] += 1
        if path == W8A8_SCALAR:
            _build.LAUNCHES[_W8A8 + "/scalar"] += 1
        _build.check(err, _W8A8)
    return out


def w4a16_path(x, packed, scale, group: int) -> int:
    """The path of a w4a16 launch on x (M, K), packed (N, K/2) and scale
    (N, K/group). W4A16_MMA, the bf16 tensor-core kernel, where x is bf16,
    1 <= M <= SMALL_M, group % 16 == 0, K % 32 == 0, the three operands
    have 16-byte aligned bases and contiguous rows, and a scale row is a
    multiple of 16 bytes of at most 4 KB (K / group % 4 == 0, K / group
    <= 1024: a block holds its 16 scale rows whole); W4A16_SCALAR, the first
    port's kernel, for the rest. Pure: dtype, shape, pointers and strides
    only, on any device."""
    m, k = x.shape
    ng = scale.shape[-1]
    # One expression: on the decode path this runs 225 times a step.
    if (x.dtype != torch.bfloat16 or not 1 <= m <= SMALL_M or group % 16
            or k % 32 or k >= 1 << 24 or ng % 4 or ng > 1024
            or packed.shape[0] > 16 * 65535
            or (x.data_ptr() | packed.data_ptr() | scale.data_ptr()) % 16
            or x.stride() != (k, 1) or packed.stride() != (k // 2, 1)
            or scale.stride() != (ng, 1)):
        return W4A16_SCALAR
    return W4A16_MMA


def int4_matmul_kernel(x, packed, scale, group: int, dtype):
    """Launch csrc/w4a16_matmul.cu on `w4a16_path`: x (M, K) in `dtype`,
    M <= SMALL_M, packed (N, K/2) uint8, scale (N, K/group) float32 ->
    (M, N). A launch on the scalar path also counts under
    `w4a16_matmul/scalar`."""
    m, k = x.shape
    n = packed.shape[0]
    if m > SMALL_M or group % 16 or k % group:
        raise ValueError(f"{_W4A16}: M={m} K={k} group={group}; the kernel "
                         f"takes M <= {SMALL_M}, group % 16 == 0, "
                         "K % group == 0")
    code = _out_code(_W4A16, dtype)
    check = _build.check_operand
    check(_W4A16, "x", x, dtype, (m, k))
    check(_W4A16, "packed weight", packed, torch.uint8, (n, k // 2))
    check(_W4A16, "scale", scale, torch.float32, (n, k // group))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _lib(_W4A16, _W4A16,
              [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp])
    out = x.new_empty((m, n))  # x is in `dtype` (checked above)
    if m and n:
        path = w4a16_path(x, packed, scale, group)
        err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, n, k, group, code, path,
                 _build.stream_handle(x.device))
        _build.LAUNCHES[_W4A16] += 1
        if path == W4A16_SCALAR:
            _build.LAUNCHES[_W4A16 + "/scalar"] += 1
        _build.check(err, _W4A16)
    return out


# ---------------------------------------------------------------------------
# Products: public entry points
# ---------------------------------------------------------------------------

def int8_matmul(x, q, scale, dtype=None):
    """W8A8 product: dynamic per-token symmetric activation quantization,
    int8 x int8 -> int32, rescaled by the token's and the channel's scales.

    x (..., in) float; q (out, in) int8; scale (out,) float32 (from
    quantize_kernel). Returns (..., out) in `dtype` (default x's). The
    activation quantization is PyTorch ops on both devices; the product
    and the rescale are the w8a8 kernel on the card."""
    _forward_only(_W8A8, x, scale)
    dtype = dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    xq, s_x = quantize_activation(x.reshape(-1, k))
    run = int8_matmul_kernel if x.is_cuda else int8_matmul_plain
    y = run(xq, q.contiguous(), s_x[:, 0].contiguous(),
            scale.float().contiguous(), dtype)
    return y.reshape(*lead, q.shape[0])


def int4_matmul(x, packed, scale, group: int, dtype=None):
    """W4A16 product on a packed-int4 weight: x (..., in) float; packed
    (out, in/2) uint8; scale (out, in/group) float32. Returns (..., out)
    in `dtype` (default x's).

    Flattened M <= SMALL_M with group % 16 == 0 (decode): the w4a16 kernel
    on the card, its plain version on the CPU. Larger M (prefill), or a
    group the kernel does not take: dequantize and torch.matmul on both."""
    _forward_only(_W4A16, x, scale)
    dtype = dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if x2.shape[0] <= SMALL_M and group % 16 == 0 and k % group == 0:
        run = int4_matmul_kernel if x.is_cuda else int4_matmul_plain
        y = run(x2.to(dtype).contiguous(), packed.contiguous(),
                scale.contiguous(), group, dtype)
    else:
        y = int4_matmul_dequant(x2, packed, scale, group, dtype)
    return y.reshape(*lead, packed.shape[0])


# ---------------------------------------------------------------------------
# Which layers to quantize (on the port's dotted parameter names)
# ---------------------------------------------------------------------------

def sam_encoder_predicate(path: Tuple[str, ...],
                          skip_blocks: Tuple[int, ...] = ()) -> bool:
    """The SAM ViT encoder's transformer products (qkv, proj, MLP) in every
    block not in `skip_blocks`; the patch embedding and the neck stay
    float. `path` is a parameter name split at the dots, e.g.
    (..., "blocks", "3", "attn", "qkv", "weight")."""
    path = tuple(str(p) for p in path)
    if "blocks" not in path[:-1]:
        return False
    if int(path[path.index("blocks") + 1]) in skip_blocks:
        return False
    return len(path) >= 2 and path[-2] in ("qkv", "proj", "lin1", "lin2")


def lisa_serving_predicate(path: Tuple[str, ...]) -> bool:
    """The whole-model W8A8 serving set: the SAM encoder's transformer
    products and the LLM's projections. Embeddings, norms, the mask
    decoders (whose two-way transformer also has q/k/v projections) and
    CLIP stay float."""
    p = set(str(x) for x in path)
    if "image_encoder" in p:
        return sam_encoder_predicate(path)
    if "vision_tower" in p or "embed_tokens" in p or "wte" in p:
        return False
    if "llm" not in p:
        return False
    return any(n in p for n in _LLM_PROJECTIONS)


def default_llm_predicate(path: Tuple[str, ...]) -> bool:
    """The LLM's projections; the visual model, CLIP and the embeddings are
    skipped."""
    p = set(str(x) for x in path)
    if "visual_model" in p or "vision_tower" in p or "embed_tokens" in p:
        return False
    return any(n in p for n in _LLM_PROJECTIONS)


@torch.no_grad()
def quantize_model_(model: nn.Module,
                    should_quantize: Callable[[Tuple[str, ...]], bool],
                    bits: int = 8, group: int = 64) -> nn.Module:
    """Quantize the selected `QDense` layers of a built model in place
    (the counterpart of `quantize_dense_tree`): a layer whose weight's
    dotted name passes `should_quantize` gets an int8 weight with a 1-D
    scale (bits=8, or bits=4 where in_features does not divide by
    `group`), or a packed-int4 weight with 2-D group scales. One layer at
    a time, each float weight freed as it is replaced, so a model on the
    card never holds a second float copy."""
    from .layers import QDense

    if bits not in (4, 8):
        raise ValueError(f"bits={bits}; 4 or 8")
    for name, mod in model.named_modules():
        if (isinstance(mod, QDense) and not mod.quantized
                and should_quantize(tuple(name.split(".")) + ("weight",))):
            mod.quantize_(bits, group)
    return model
