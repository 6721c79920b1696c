"""SAM ViT attention with the decomposed relative-position bias: the
wrappers of the two CUDA kernels, their autograd rule and their plain
PyTorch versions.

Port of haff_tpu/kernels/sam_attention.py. Its six Pallas kernels compute
two functions (windowed and global attention with the bias) under
different operand layouts and lane geometries; the port has one kernel a
function, reading every layout in place through pointers and strides:

* csrc/sam_window_attn.cu (`sam_window_relpos_attn`) replaces
  `_window_qkv_kernel_db_iband`, `_window_qkv_kernel_db`,
  `_window_qkv_kernel` and `_window_kernel`;
* csrc/sam_global_attn.cu (`sam_global_relpos_attn`) replaces
  `_global_qkv_kernel` and `_fused_kernel`.

The public functions take the JAX entry points' arguments in their order
(`interpret` and the TPU tile size `block_q` dropped):

=================================  ==========================  =========
entry                              operands                    LAUNCHES key
=================================  ==========================  =========
`sam_window_attention_qkv_split`   q3 (BW, L, C), kv3 (.., 2C)  sam_window_relpos_attn
`sam_window_attention_qkv`         qkv (BW, L, 3C)              sam_window_relpos_attn_fused
`sam_window_attention`             q, k, v (BW, L, nh, d)       sam_window_relpos_attn_heads
`sam_global_attention_qkv`         qkv (B, L, 3C)               sam_global_relpos_attn
`sam_global_attention`             q, k, v (B, L, nh, d)        sam_global_relpos_attn_heads
=================================  ==========================  =========

CPU tensors take the plain version (decomposed bias + softmax attention
in float32, JAX `_window_xla` semantics); CUDA tensors launch the kernel,
with no fallback between the two. `force_xla=True` or
`train_rel_pos=True` asks for the plain version under ordinary autograd
on either device, as in JAX. The TPU-only artefacts (196 -> 200 tile-pad
rows, the -1e30 lane poison, head-half grids, group sizes dividing the
window count, the 128-lane alignment guards) are not part of the port: L
is the window area and every geometry runs the kernel.

Each launch takes one path, chosen before it by the pure function
`kernel_path` (no fallback from one to another): bf16 operands with
16-byte aligned bases, batch and row strides that are multiples of 8 and
d % 8 == 0 (`_tensor_core_ok`) run on the tensor cores, the global kernel
by warpgroup MMA fed by TMA, the window kernel by mma.sync fed by 16-byte
copies, both with the band built in the kernel from the raw rel-pos
tables; float32 operands and bf16 views a 16-byte copy cannot read run
the scalar f32 code. A scalar bf16 launch also counts under
`<key>/scalar`. A window whose keys and values do not fit
one block's shared memory on its path (above 21 x 21 at d = 80 on the
tensor cores, about 16 x 16 on the scalar path) goes to the global kernel
as a batch of small grids.

Gradients (`RelPosAttentionFn`): the kernels have no backward kernel, as
the Pallas ones have none. Window entries take the VJP of the plain
version recomputed from the saved inputs, reaching q, k, v and both
rel-pos tables. Global entries take `banded_attention_bwd`, a loop over
key rows with an O(L * W) working set that never builds an (L, L) tensor;
it reaches q (through the scores and through the bias), k and v, and
gives the rel-pos tables zero gradients, but only where the JAX package's
fused global path runs (`global_tables_frozen`); elsewhere it takes the
plain version's VJP, with true table gradients.

Numerics against the Pallas kernels: both products run on the tensor
cores with f32 sums, as there. The Pallas kernels round P to bf16 before
P @ V; that alone puts outputs outside the bf16 tolerance against the
float32 function at ViT-H shapes, so these kernels keep more of P: bf16
hi + lo halves (~16 significant bits), or fp16 (11) against V converted
to fp16 in the window kernel. The Pallas kernels also scale q and round it, and
round the band tables, to the operand dtype before the products; these
kernels keep the scale and the band in float32 (the band from bf16 hi +
lo halves of the f32 tables), inside the stated bf16 tolerance.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import mha_reference

WINDOW_SPLIT = "sam_window_relpos_attn"
WINDOW_FUSED = "sam_window_relpos_attn_fused"
WINDOW_HEADS = "sam_window_relpos_attn_heads"
GLOBAL_FUSED = "sam_global_relpos_attn"
GLOBAL_HEADS = "sam_global_relpos_attn_heads"
_SMEM_LIMIT = 227 * 1024


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """Relative positional embeddings for a q/k pair: (q_size, k_size, d)
    (reference image_encoder.py get_rel_pos). Every preset stores tables
    of the exact length, so no interpolation is done."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        raise ValueError(f"rel_pos has {rel_pos.shape[0]} rows, need "
                         f"{max_rel_dist} for sizes {q_size}, {k_size}")
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    idx = torch.as_tensor(relative.astype(np.int64), device=rel_pos.device)
    return rel_pos[idx]


def decomposed_rel_pos_bias(q, rel_pos_h, rel_pos_w, q_hw: Tuple[int, int],
                            k_hw: Tuple[int, int]):
    """q (B, qh*qw, nh, d) -> (B, nh, qh*qw, kh*kw) float32 bias
    (reference image_encoder.py add_decomposed_rel_pos)."""
    q_h, q_w = q_hw
    k_h, k_w = k_hw
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).float()
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).float()
    b, _, nh, _ = q.shape
    r_q = q.reshape(b, q_h, q_w, nh, -1).float()
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", r_q, Rh)
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", r_q, Rw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(b, nh, q_h * q_w, k_h * k_w)


def head_view(t, parts: int, index: int, num_heads: int):
    """Part `index` of a projection output (B, L, parts * C) as its
    (B, L, nh, d) view: never a copy (splitting the last axis keeps
    every other stride, whatever the layout)."""
    b, l, f = t.shape
    c = f // parts
    if f != parts * c or c % num_heads:
        raise ValueError(f"operand {tuple(t.shape)} is not {parts} x "
                         f"{num_heads} heads wide")
    return t.narrow(2, index * c, c).view(b, l, num_heads, c // num_heads)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def relpos_attention_plain(q, k, v, rel_h, rel_w, hw, sm_scale):
    """Per-head form: q, k, v (B, L, nh, d), L = hw[0]*hw[1] ->
    (B, L, nh, d). The plain version of all five entries."""
    bias = decomposed_rel_pos_bias(q, rel_h, rel_w, hw, hw)
    return mha_reference(q, k, v, bias=bias, sm_scale=sm_scale)


def window_attention_plain(q3, kv3, rel_h, rel_w, hw, num_heads, sm_scale):
    """Split form: q3 (BW, L, C), kv3 (BW, L, 2C) -> (BW, L, C)."""
    out = relpos_attention_plain(
        head_view(q3, 1, 0, num_heads), head_view(kv3, 2, 0, num_heads),
        head_view(kv3, 2, 1, num_heads), rel_h, rel_w, hw, sm_scale)
    return out.reshape(q3.shape)


def global_attention_plain(qkv, rel_h, rel_w, hw, num_heads, sm_scale):
    """Fused form: qkv (B, L, 3C) -> (B, L, C). The function does not
    depend on the scope, so this is also the plain version of the fused
    window entry (`hw` the window)."""
    q, k, v = (head_view(qkv, 3, i, num_heads) for i in range(3))
    out = relpos_attention_plain(q, k, v, rel_h, rel_w, hw, sm_scale)
    return out.reshape(qkv.shape[0], qkv.shape[1], -1)



# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _lib(name):
    lib = _build.library(name)
    fn = getattr(lib, WINDOW_SPLIT if name == "sam_window_attn"
                 else GLOBAL_FUSED)
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 6 + [i32] * 5 + [i64] * 6
                       + [ctypes.c_float, i32, i32, vp])
        fn.restype = ctypes.c_int
        smem = getattr(lib, fn.__name__ + "_smem")
        smem.argtypes = [i32] * 4
        smem.restype = ctypes.c_size_t
    return lib


# Kernel paths, as the C entry points number them.
SCALAR, MMA_SYNC, WGMMA = 0, 1, 2
PATH_NAMES = ("scalar", "mma.sync", "wgmma")


def _tensor_core_ok(q, k, v) -> bool:
    """Whether the kernels' tensor-core path can read these (B, L, nh, d)
    operands: bf16, d % 8 == 0, and every row of every head reachable by
    16-byte copies (base 16-byte aligned, batch and row strides multiples
    of 8 elements; heads are side by side, so h * d stays aligned too).
    Pure: dtype, shape, pointers and strides only, on any device."""
    if q.shape[-1] % 8:
        return False
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
               and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
               for t in (q, k, v))


def kernel_path(kind, q, k, v) -> int:
    """The path a launch takes: SCALAR unless `_tensor_core_ok`; on the
    tensor cores the global kernel runs warpgroup MMA (WGMMA) and the
    window kernel mma.sync, at every grid. Pure, like `_tensor_core_ok`."""
    if not _tensor_core_ok(q, k, v):
        return SCALAR
    return WGMMA if kind == "global" else MMA_SYNC


def _table(t, device):
    """A rel-pos table as the kernels read it: float32, contiguous, on
    `device`, 16-byte aligned (the window kernel loads 4 floats at a
    time); a copy only where the caller's tensor is none of these."""
    t = t.detach().to(device=device, dtype=torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_heads(name, t, like):
    """A (B, L, nh, d) operand the kernels can read in place: head h of
    row i at i * stride(1) + h * d, elements of a head adjacent. Batch and
    row strides are free (fused, split and per-head layouts differ only
    there). The scalar paths load single elements, so the only alignment
    they assume is the element type's; `_tensor_core_ok` decides whether
    the operands also suit 16-byte copies."""
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"{name}: operands must be CUDA tensors on one "
                         "device")
    if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != like.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}; need bfloat16 or float32, "
                        "one for all operands")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    d = t.shape[3]
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"{name}: strides {t.stride()}: heads must lie "
                         f"side by side in a row (stride {d}, 1)")
    if t.data_ptr() % t.element_size():
        raise ValueError(f"{name}: operand not aligned to its element size")


def _check_rel(t, rows, d):
    if tuple(t.shape) != (rows, d):
        raise ValueError(f"rel-pos table {tuple(t.shape)}, expected "
                         f"{(rows, d)}")


def band_tables(q, rel_h, rel_w, hw):
    """Band tables of the global kernel, float32: q (B, L, nh, d) ->
    Bh (B, L, nh, H) = q . Rh[row], Bw (B, L, nh, W) = q . Rw[col]
    (JAX `_natural_band_tables`, without the key padding)."""
    H, W = hw
    b, l, nh, d = q.shape
    Rh = get_rel_pos(H, H, rel_h).float()
    Rw = get_rel_pos(W, W, rel_w).float()
    r_q = q.reshape(b, H, W, nh, d).float()
    bh = torch.einsum("bhwnc,hkc->bhwnk", r_q, Rh).reshape(b, l, nh, H)
    bw = torch.einsum("bhwnc,wkc->bhwnk", r_q, Rw).reshape(b, l, nh, W)
    return bh.contiguous(), bw.contiguous()


def _operands(name, q, k, v, rel_h, rel_w, hw):
    h, w = hw
    b, l, nh, d = q.shape
    if l != h * w or d > 128:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match grid "
                         f"{hw} (head dim at most 128)")
    for t in (q, k, v):
        _check_heads(name, t, q)
    _check_rel(rel_h, 2 * h - 1, d)
    _check_rel(rel_w, 2 * w - 1, d)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1))]
    return b, nh, d, strides


def _launch_global(counter, q, k, v, rel_h, rel_w, hw, sm_scale):
    """csrc/sam_global_attn.cu on (B, L, nh, d) views -> (B, L, nh, d).
    The tensor-core path builds the band in the kernel from the rel-pos
    tables; the scalar path reads the wrapper's band tables."""
    b, nh, d, strides = _operands(counter, q, k, v, rel_h, rel_w, hw)
    lib = _lib("sam_global_attn")
    path = kernel_path("global", q, k, v)
    if lib.sam_global_relpos_attn_smem(hw[0], hw[1], d, path) > _SMEM_LIMIT:
        raise ValueError(f"{counter}: grid {hw} x head dim {d} exceeds one "
                         "block's shared memory")
    if path != SCALAR:
        bh, bw = _table(rel_h, q.device), _table(rel_w, q.device)
    else:
        bh, bw = band_tables(q, rel_h, rel_w, hw)
    out = torch.empty((b, q.shape[1], nh, d), dtype=q.dtype, device=q.device)
    ptr = _build.ptr
    err = lib.sam_global_relpos_attn(
        ptr(q), ptr(k), ptr(v), ptr(bh), ptr(bw), ptr(out), b, hw[0], hw[1],
        nh, d, *strides, float(sm_scale), int(q.dtype == torch.bfloat16),
        path, _build.stream_handle(q.device))
    _build.count(counter, q, path)
    _build.check(err, counter)
    return out


def _launch_window(counter, q, k, v, rel_h, rel_w, hw, sm_scale):
    """csrc/sam_window_attn.cu on (BW, L, nh, d) views -> (BW, L, nh, d);
    a window too large for one block's shared memory on its path runs on
    the global kernel instead (a window is a small grid)."""
    b, nh, d, strides = _operands(counter, q, k, v, rel_h, rel_w, hw)
    lib = _lib("sam_window_attn")
    path = kernel_path("window", q, k, v)
    if lib.sam_window_relpos_attn_smem(hw[0], hw[1], d, path) > _SMEM_LIMIT:
        return _launch_global(counter, q, k, v, rel_h, rel_w, hw, sm_scale)
    rh, rw = _table(rel_h, q.device), _table(rel_w, q.device)
    out = torch.empty((b, q.shape[1], nh, d), dtype=q.dtype, device=q.device)
    ptr = _build.ptr
    err = lib.sam_window_relpos_attn(
        ptr(q), ptr(k), ptr(v), ptr(rh), ptr(rw), ptr(out), b, hw[0], hw[1],
        nh, d, *strides, float(sm_scale), int(q.dtype == torch.bfloat16),
        path, _build.stream_handle(q.device))
    _build.count(counter, q, path)
    _build.check(err, counter)
    return out


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def global_tables_frozen(hw: Tuple[int, int]) -> bool:
    """Whether a global entry gives the rel-pos tables zero gradients.

    This is the JAX package's predicate for its fused global path, kept
    only to decide this: `sam_global_attention` leaves the fused path (and
    its zero table gradients) for XLA, with true table gradients, when
    `L < 256 or W % 8 != 0`, and `sam_global_attention_qkv` falls back to
    it under stricter conditions that all imply L >= 256 and W % 8 == 0.
    The port's kernel runs at every geometry, so it needs the rule spelt
    out to give the reference's gradients: zeros at the `small` preset
    and every SAM ViT (32 x 32, 64 x 64), true gradients at `tiny`
    (8 x 8). The same on the CPU and on the card."""
    return hw[0] * hw[1] >= 256 and hw[1] % 8 == 0


def banded_attention_bwd(q, k, v, rel_h, rel_w, out, g, hw, sm_scale):
    """Backward of global rel-pos attention by key-row bands (JAX
    `_banded_bwd`): q, k, v, out, g (B, L, nh, d) -> (dq, dk, dv) in the
    operands' dtypes, computed in float32. Pass 1 accumulates the
    log-sum-exp over the H bands of W keys, pass 2 the gradients; the
    largest tensor is a band of scores (B, nh, L, W), never (L, L). dq
    includes the bias terms: dBh[i, r] = sum_w ds[i, r, w] and
    dBw[i, w] = sum_r ds[i, r, w] go back through q . Rh and q . Rw."""
    H, W = hw
    b, l, nh, d = q.shape
    Rh = get_rel_pos(H, H, rel_h).float()           # (H, H, d)
    Rw = get_rel_pos(W, W, rel_w).float()           # (W, W, d)
    bh, bw = band_tables(q, rel_h, rel_w, hw)
    bh, bw = bh.permute(0, 2, 1, 3), bw.permute(0, 2, 1, 3)   # (B, nh, L, *)
    qh = q.float().permute(0, 2, 1, 3)              # (B, nh, L, d)
    kh = k.float().permute(0, 2, 1, 3).reshape(b, nh, H, W, d)
    vh = v.float().permute(0, 2, 1, 3).reshape(b, nh, H, W, d)
    do = g.float().permute(0, 2, 1, 3)
    delta = (do * out.float().permute(0, 2, 1, 3)).sum(-1, keepdim=True)
    qs = qh * sm_scale

    def band_logits(r):
        return qs @ kh[:, :, r].transpose(-1, -2) + bh[..., r, None] + bw

    lse = torch.full((b, nh, l), -torch.inf, device=q.device)
    for r in range(H):
        lse = torch.logaddexp(lse, torch.logsumexp(band_logits(r), dim=-1))

    dq = torch.zeros_like(qh)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    dbh = torch.empty_like(bh)
    dbw = torch.zeros_like(bw)
    for r in range(H):
        p = torch.exp(band_logits(r) - lse[..., None])        # (B, nh, L, W)
        dv[:, :, r] = p.transpose(-1, -2) @ do
        ds = p * (do @ vh[:, :, r].transpose(-1, -2) - delta)
        dq += sm_scale * (ds @ kh[:, :, r])
        dk[:, :, r] = sm_scale * (ds.transpose(-1, -2) @ qh)
        dbh[..., r] = ds.sum(-1)
        dbw += ds
    rows = torch.arange(l, device=q.device) // W
    cols = torch.arange(l, device=q.device) % W
    dq += torch.einsum("bnlh,lhd->bnld", dbh, Rh[rows])
    dq += torch.einsum("bnlw,lwd->bnld", dbw, Rw[cols])
    back = lambda t, like: t.reshape(b, nh, l, d).permute(0, 2, 1, 3).to(  # noqa: E731
        like.dtype)
    return back(dq, q), back(dk, k), back(dv, v)


class RelPosAttentionFn(torch.autograd.Function):
    """Rel-pos attention on (B, L, nh, d) operands. Forward: the `kind`
    ("window" or "global") kernel on CUDA tensors, counted under
    `counter`, the plain version on CPU tensors. Backward, plain torch:
    `banded` (global entries where `global_tables_frozen`) takes
    `banded_attention_bwd` and gives the tables zeros; otherwise the VJP of
    the plain version recomputed from the saved inputs, tables included."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, hw, sm_scale, kind, counter,
                banded):
        if q.is_cuda:
            launch = _launch_window if kind == "window" else _launch_global
            out = launch(counter, q, k, v, rel_h, rel_w, hw, sm_scale)
        else:
            out = relpos_attention_plain(q, k, v, rel_h, rel_w, hw, sm_scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w,
                              *((out,) if banded else ()))
        ctx.hw, ctx.sm_scale, ctx.banded = hw, sm_scale, banded
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors  # read once: remat unpacks on access
        q, k, v, rel_h, rel_w = saved[:5]
        need = ctx.needs_input_grad[:5]
        if ctx.banded:
            dq, dk, dv = banded_attention_bwd(
                q, k, v, rel_h, rel_w, saved[5], g, ctx.hw, ctx.sm_scale)
            grads = [dq, dk, dv, torch.zeros_like(rel_h),
                     torch.zeros_like(rel_w)]
            grads = [t if n else None for t, n in zip(grads, need)]
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(n)
                       for t, n in zip((q, k, v, rel_h, rel_w), need)]
                out = relpos_attention_plain(*ins, ctx.hw, ctx.sm_scale)
                wanted = [t for t, n in zip(ins, need) if n]
                got = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
            grads = [next(got) if n else None for n in need]
        return (*grads, None, None, None, None, None)


def _attend(kind, counter, q, k, v, rel_h, rel_w, hw, sm_scale, plain):
    hw = (int(hw[0]), int(hw[1]))
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if plain or q.shape[0] == 0:
        return relpos_attention_plain(q, k, v, rel_h, rel_w, hw, sm_scale)
    banded = kind == "global" and global_tables_frozen(hw)
    return RelPosAttentionFn.apply(q, k, v, rel_h, rel_w, hw, float(sm_scale),
                                   kind, counter, banded)


# ---------------------------------------------------------------------------
# Public entry points (JAX argument order)
# ---------------------------------------------------------------------------

def sam_window_attention_qkv_split(q3, kv3, rel_h, rel_w,
                                   hw: Tuple[int, int], num_heads: int,
                                   sm_scale=None, force_xla: bool = False,
                                   train_rel_pos: bool = False):
    """Windowed SAM attention over a column-split qkv projection:
    q3 (BW, L, C), kv3 (BW, L, 2C), L = hw[0]*hw[1]. Returns (BW, L, C)."""
    out = _attend("window", WINDOW_SPLIT, head_view(q3, 1, 0, num_heads),
                  head_view(kv3, 2, 0, num_heads), head_view(kv3, 2, 1, num_heads),
                  rel_h, rel_w, hw, sm_scale, force_xla or train_rel_pos)
    return out.reshape(q3.shape)


def sam_window_attention_qkv(qkv, rel_h, rel_w, hw: Tuple[int, int],
                             num_heads: int, sm_scale=None,
                             force_xla: bool = False,
                             train_rel_pos: bool = False):
    """Windowed SAM attention over the fused qkv projection (BW, L, 3C),
    L = hw[0]*hw[1], read in place. Returns (BW, L, C). The encoder also
    sends global grids under 1024 tokens here, as the JAX encoder does."""
    q, k, v = (head_view(qkv, 3, i, num_heads) for i in range(3))
    out = _attend("window", WINDOW_FUSED, q, k, v, rel_h, rel_w, hw, sm_scale,
                  force_xla or train_rel_pos)
    return out.reshape(qkv.shape[0], qkv.shape[1], -1)


def sam_window_attention(q, k, v, rel_h, rel_w, hw: Tuple[int, int],
                         sm_scale=None, force_xla: bool = False,
                         train_rel_pos: bool = False):
    """Windowed SAM attention on per-head operands: q, k, v
    (BW, L, nh, d), L = hw[0]*hw[1]. Returns (BW, L, nh, d)."""
    return _attend("window", WINDOW_HEADS, q, k, v, rel_h, rel_w, hw,
                   sm_scale, force_xla or train_rel_pos)


def sam_global_attention(q, k, v, rel_h, rel_w, hw: Tuple[int, int],
                         sm_scale=None, force_xla: bool = False,
                         train_rel_pos: bool = False):
    """Global SAM attention on per-head operands: q, k, v (B, L, nh, d),
    L = hw[0]*hw[1]. Returns (B, L, nh, d). The rel-pos tables get zero
    gradients where `global_tables_frozen(hw)`; `train_rel_pos=True` gives
    true ones through the plain version."""
    return _attend("global", GLOBAL_HEADS, q, k, v, rel_h, rel_w, hw,
                   sm_scale, force_xla or train_rel_pos)


def sam_global_attention_qkv(qkv, rel_h, rel_w, hw: Tuple[int, int],
                             num_heads: int, sm_scale=None,
                             force_xla: bool = False,
                             train_rel_pos: bool = False):
    """Global SAM attention over the fused qkv projection (B, L, 3C),
    L = hw[0]*hw[1], read in place. Returns (B, L, C). Table gradients as
    `sam_global_attention`."""
    q, k, v = (head_view(qkv, 3, i, num_heads) for i in range(3))
    out = _attend("global", GLOBAL_FUSED, q, k, v, rel_h, rel_w, hw, sm_scale,
                  force_xla or train_rel_pos)
    return out.reshape(qkv.shape[0], qkv.shape[1], -1)
