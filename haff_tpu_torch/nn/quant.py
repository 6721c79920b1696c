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
between the two. Under autograd (QLoRA: a frozen quantized base under
trainable adapters) both products pass a straight-through gradient to x,
JAX's rule (haff_tpu/nn/quant.py `_int8_matmul_ste_bwd`): dx = dy @ the
dequantized weight, a plain product as in JAX's XLA backward; the
activation quantization's round and clip are not differentiated, and the
quantized weight and its scale get no gradient. The W4A16 kernel route
has no activation rounding, so its straight-through gradient is exact;
its large-M route is plain `F.linear`, differentiable as it stands.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

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


def dequantize_weight(q, scale, dtype=torch.bfloat16):
    """A quantized weight in `dtype` by its own form: int8 (out, in) with
    scale (out,), or packed uint8 (out, in/2) with group scales
    (out, in/group)."""
    if q.dtype == torch.int8:
        return dequantize_kernel(q, scale, dtype)
    return dequantize_kernel_int4(q, scale, 2 * q.shape[1] // scale.shape[1],
                                  dtype)


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

# Row-parallel W8A8 products whose activation amax was all-reduced over
# the tensor group (`int8_matmul(..., amax_group=)`), on any device.
GLOBAL_AMAX = {"all_reduces": 0}


def quantize_activation_rows(x2, amax_group=None) -> QuantArray:
    """`quantize_activation` of (M, K) rows; with `amax_group` (a
    row-parallel product: x holds a K slice) each row's amax is the
    maximum over the group's slices, so the int8 values and scales are
    those of the whole row."""
    if amax_group is None:
        return quantize_activation(x2)
    from ..parallel.collectives import all_reduce

    xf = x2.float()
    amax = all_reduce(xf.abs().amax(dim=-1, keepdim=True), amax_group,
                      op="max")
    GLOBAL_AMAX["all_reduces"] += 1
    q, scale = _symmetric(xf, amax, 127.0, -127, 127)
    return QuantArray(values=q.to(torch.int8), scales=scale)


class _Int8MatmulSTE(torch.autograd.Function):
    """W8A8 forward (activation quantization and the product, undifferentiated)
    with the straight-through backward dx = dy @ dequantize_kernel(q, scale)."""

    @staticmethod
    def forward(ctx, x, q, scale, dtype, amax_group):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        lead, k = x.shape[:-1], x.shape[-1]
        xq, s_x = quantize_activation_rows(x.reshape(-1, k), amax_group)
        if x.is_cuda:
            y = int8_matmul_kernel(xq, q, s_x[:, 0].contiguous(), scale,
                                   dtype)
            if amax_group is not None:
                _build.LAUNCHES[_W8A8 + "/row_parallel"] += 1
        else:
            y = int8_matmul_plain(xq, q, s_x[:, 0].contiguous(), scale, dtype)
        return y.reshape(*lead, q.shape[0])

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dx = dy @ dequantize_kernel(q, scale, dy.dtype)
        return dx.to(ctx.x_dtype), None, None, None, None


def int8_matmul(x, q, scale, dtype=None, amax_group=None):
    """W8A8 product: dynamic per-token symmetric activation quantization,
    int8 x int8 -> int32, rescaled by the token's and the channel's scales.

    x (..., in) float; q (out, in) int8; scale (out,) float32 (from
    quantize_kernel). Returns (..., out) in `dtype` (default x's). The
    activation quantization is PyTorch ops on both devices; the product
    and the rescale are the w8a8 kernel on the card. Differentiable in x
    by the straight-through rule (module docstring).

    `amax_group`: a row-parallel product (x and q hold a K slice each
    rank of the group): the rows are quantized with their amax over the
    whole K (an all-reduce max), and the result is this slice's partial
    product, which the caller sums over the group (a kernel launch in
    this role also counts under `w8a8_matmul/row_parallel`)."""
    return _Int8MatmulSTE.apply(x, q.contiguous(), scale.float().contiguous(),
                                dtype or x.dtype, amax_group)


class _Int4MatmulSTE(torch.autograd.Function):
    """The W4A16 kernel route (x (M, K) in the compute dtype) with the
    backward dx = dy @ dequantize_kernel_int4(packed, scale)."""

    @staticmethod
    def forward(ctx, x, packed, scale, group, dtype):
        ctx.save_for_backward(packed, scale)
        ctx.group = group
        run = int4_matmul_kernel if x.is_cuda else int4_matmul_plain
        return run(x, packed, scale, group, dtype)

    @staticmethod
    def backward(ctx, dy):
        packed, scale = ctx.saved_tensors
        dx = dy @ dequantize_kernel_int4(packed, scale, ctx.group, dy.dtype)
        return dx, None, None, None, None


def int4_matmul(x, packed, scale, group: int, dtype=None):
    """W4A16 product on a packed-int4 weight: x (..., in) float; packed
    (out, in/2) uint8; scale (out, in/group) float32. Returns (..., out)
    in `dtype` (default x's).

    Flattened M <= SMALL_M with group % 16 == 0 (decode): the w4a16 kernel
    on the card, its plain version on the CPU. Larger M (prefill), or a
    group the kernel does not take: dequantize and torch.matmul on both.
    Differentiable in x (module docstring)."""
    dtype = dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if x2.shape[0] <= SMALL_M and group % 16 == 0 and k % group == 0:
        y = _Int4MatmulSTE.apply(x2.to(dtype).contiguous(),
                                 packed.contiguous(), scale.contiguous(),
                                 group, dtype)
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


# ---------------------------------------------------------------------------
# The external-scales family (JAX quantize_tree / dequantize_tree /
# make_quantized_apply) and random serving-precision weights
# ---------------------------------------------------------------------------

def quantize_tree(state: Union[Mapping[str, torch.Tensor], nn.Module],
                  should_quantize: Callable[[Tuple[str, ...]], bool],
                  bits: int = 8, group: int = 64
                  ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Quantize the selected dense weights of a state dict (or a module's).

    A 2-D float `weight` whose dotted name passes `should_quantize`
    becomes int8 (bits=8, or bits=4 where in does not divide by `group`)
    or packed int4. Returns (new_state, scales): new_state is `state` with
    those entries replaced (the others are the same tensors), and scales
    maps each replaced name to ("int8", scale (out,), None) or ("int4",
    scale (out, in/group), group), the JAX package's entries transposed to
    the port's layout. The float state is not changed."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}; 4 or 8")
    out = dict(state.state_dict() if isinstance(state, nn.Module)
               else state)
    scales = {}
    for name, w in list(out.items()):
        if (name.rpartition(".")[2] == "weight" and w.dim() == 2
                and w.is_floating_point()
                and should_quantize(tuple(name.split(".")))):
            if bits == 4 and w.shape[1] % group == 0:
                out[name], s = quantize_kernel_int4(w, group)
                scales[name] = ("int4", s, group)
            else:
                out[name], s = quantize_kernel(w)
                scales[name] = ("int8", s, None)
    return out, scales


def _scale_entry(entry):
    """A scales entry as (kind, scale, group); a bare tensor is the legacy
    int8 form."""
    return entry if isinstance(entry, tuple) else ("int8", entry, None)


def dequantize_tree(state: Mapping[str, torch.Tensor], scales: Dict,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The float state back from quantize_tree's (state, scales): each
    scaled entry dequantized to `dtype` (value * scale in float32, rounded
    once), the rest as they are."""
    out = dict(state)
    for name, entry in scales.items():
        kind, s, group = _scale_entry(entry)
        out[name] = (dequantize_kernel_int4(out[name], s, group, dtype)
                     if kind == "int4" else dequantize_kernel(out[name], s,
                                                              dtype))
    return out


@torch.no_grad()
def bind_quantized_tree_(model: nn.Module, state: Mapping[str, torch.Tensor],
                         scales: Dict) -> nn.Module:
    """Load quantize_tree's (state, scales) into `model`, in place: each
    scaled `QDense` weight becomes its int8 / packed uint8 buffer with the
    float32 scale beside it, its float weight freed; every other entry is
    copied in, except a tensor the model already holds. Every name of the
    model must be given. The bound layers run the W8A8 / W4A16 product,
    as after quantize_model_; under DequantizeAtUse they are dequantized
    at use instead."""
    from .layers import QDense

    modules = dict(model.named_modules())
    for name, entry in scales.items():
        kind, s, _ = _scale_entry(entry)
        prefix, _, leaf = name.rpartition(".")
        mod = modules.get(prefix)
        if leaf != "weight" or not isinstance(mod, QDense):
            raise TypeError(f"{name}: not the weight of a QDense layer")
        q = state[name]
        if q.dtype != (torch.uint8 if kind == "int4" else torch.int8):
            raise TypeError(f"{name}: {q.dtype} values for {kind} scales")
        dev = mod.weight.device
        mod.set_quantized_(q.to(dev), s.to(dev))
    own = model.state_dict()
    rest = {n: t for n, t in state.items() if n not in scales
            and not (n in own and t.data_ptr() == own[n].data_ptr())}
    missing, unexpected = model.load_state_dict(rest, strict=False)
    missing = [n for n in missing if n not in state and not (
        n.endswith(".scale") and n[: -len("scale")] + "weight" in scales)]
    if missing or unexpected:
        raise KeyError(f"bind_quantized_tree_: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model


class DequantizeAtUse:
    """A reusable context in which the layers named in `scales` (each
    holding the quantized weight of its entry: bind_quantized_tree_) are
    dequantized to `dtype` at use, each just before its `F.linear`, and
    launch no quantized kernel (`QDense.dequant_dtype`). On exit each
    layer is as it was: the scales act only on the calls made inside,
    as JAX's `quant_scales=` acts only on the call it is given to."""

    def __init__(self, model: nn.Module, scales: Dict, dtype):
        modules = dict(model.named_modules())
        self.layers, self.dtype, self._saved = [], dtype, None
        for name, entry in scales.items():
            kind, s, _ = _scale_entry(entry)
            mod = modules.get(name.rpartition(".")[0])
            want = torch.uint8 if kind == "int4" else torch.int8
            if (getattr(mod, "weight", None) is None
                    or mod.weight.dtype != want
                    or tuple(mod.scale.shape) != tuple(s.shape)):
                raise ValueError(f"{name}: the model does not hold its "
                                 f"{kind} weight; bind the quantized tree "
                                 "first (nn.quant.bind_quantized_tree_)")
            self.layers.append(mod)

    def __enter__(self):
        self._saved = [m.dequant_dtype for m in self.layers]
        for m in self.layers:
            m.dequant_dtype = self.dtype
        return self

    def __exit__(self, *exc):
        for m, dt in zip(self.layers, self._saved):
            m.dequant_dtype = dt
        return False


def make_quantized_apply(model: nn.Module,
                         predicate: Callable = default_llm_predicate,
                         dtype=torch.bfloat16):
    """Returns (qparams, apply_fn): qparams the state of `model` with the
    selected weights int8 at rest (quantize_tree with `predicate`), and
    apply_fn(qparams, *args, method=None, **kwargs) the model's forward
    (or the named method) run by torch.func.functional_call on qparams,
    each selected layer's weight dequantized to `dtype` at use. The
    products are `F.linear`; no quantized kernel is launched.

    `model` is consumed: qparams are bound into it in place (its selected
    float weights freed, so that no float copy stays beside the int8
    one), and qparams alias its tensors. Called directly afterwards it is
    the int8 model of quantize_model_, whose products run W8A8."""
    qparams, scales = quantize_tree(model, predicate)
    bind_quantized_tree_(model, qparams, scales)
    at_use = DequantizeAtUse(model, scales, dtype)

    def apply_fn(qp, *args, method=None, **kwargs):
        with at_use:
            return torch.func.functional_call(
                _MethodCall(model, method),
                {f"model.{k}": v for k, v in qp.items()}, args, kwargs)

    return model.state_dict(), apply_fn


class _MethodCall(nn.Module):
    """`model`, or its method `name`, as a module's forward (what
    torch.func.functional_call runs)."""

    def __init__(self, model: nn.Module, name=None):
        super().__init__()
        self.model, self.name = model, name

    def forward(self, *args, **kwargs):
        fn = self.model if self.name is None else getattr(self.model,
                                                          self.name)
        return fn(*args, **kwargs)


@torch.no_grad()
def random_quantized_like(model, predicate: Callable[[Tuple[str, ...]], bool],
                          seed: int = 0, big_bf16: int = 1_000_000,
                          bits: int = 8, group: int = 64,
                          dtype=torch.bfloat16, device="cuda") -> nn.Module:
    """Random weights made directly in serving precision (JAX
    `random_quantized_like`): `model` is a module on the meta device (a
    `ModelConfig` builds `LisaModel(cfg, dtype, device="meta")`), and each
    of its parameters is made on `device`, one at a time, from a
    generator seeded `seed`. A `QDense` weight whose name passes
    `predicate` becomes int8 values in [-127, 127] with a 1-D scale
    (bits=8, or bits=4 where in does not divide by `group`), or packed
    uint8 bytes with 2-D group scales, every scale 0.02 / sqrt(in); the
    layer then runs the W8A8 / W4A16 product. Every other float parameter
    is normal(0, 0.02), in bfloat16 when it has more than `big_bf16`
    elements, else in its own dtype; any other is zero. The float model is
    never made. Returns the model."""
    from ..core.config import ModelConfig
    from .layers import QDense

    if bits not in (4, 8):
        raise ValueError(f"bits={bits}; 4 or 8")
    if isinstance(model, ModelConfig):
        from ..model.lisa import LisaModel

        model = LisaModel(model, dtype, device="meta")
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    for mod_name, mod in model.named_modules():
        if any(b is not None for b in mod._buffers.values()):
            raise ValueError(f"{mod_name}: buffers have no random form")
        for leaf, p in list(mod._parameters.items()):
            if p is None:
                continue
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if (isinstance(mod, QDense) and leaf == "weight"
                    and predicate(tuple(name.split(".")))):
                dout, din = p.shape
                s = 0.02 / math.sqrt(max(din, 1))
                if bits == 4 and din % group == 0:
                    q = torch.randint(0, 256, (dout, din // 2), generator=gen,
                                      device=device, dtype=torch.uint8)
                    scale = torch.full((dout, din // group), s,
                                       device=device)
                else:
                    q = torch.randint(-127, 128, (dout, din), generator=gen,
                                      device=device, dtype=torch.int8)
                    scale = torch.full((dout,), s, device=device)
                mod.set_quantized_(q, scale)
                continue
            if p.is_floating_point():
                dt = torch.bfloat16 if p.numel() > big_bf16 else p.dtype
                t = (torch.randn(p.shape, generator=gen, device=device)
                     * 0.02).to(dt)
            else:
                t = torch.zeros(p.shape, dtype=p.dtype, device=device)
            mod._parameters[leaf] = nn.Parameter(
                t, requires_grad=p.requires_grad and t.is_floating_point())
    return model
