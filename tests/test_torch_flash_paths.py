"""The design choices of the port's tensor-core flash kernels
(haff_tpu_torch/kernels/csrc/flash_prefill.cu, flash_bwd.cu: the forward,
flash_bwd_dq and flash_bwd_dkv), checked on the CPU before the card sees
them:

* the pure path function (`kernel_path`): bf16 operands with D % 16 == 0,
  D <= 128 and 16-byte aligned bases and strides take the warpgroup-MMA
  path; float32, other head dims and misaligned operands stay scalar;
  both backward kernels take the path of (q, k, v, dO);
* a plain-torch emulation of the kernels' rounding at the train and
  prefill shape (L = 575, D = 128, two heads, causal, row 1 short by
  100): the forward's online softmax over 64-key tiles with P entering
  P V as bf16 hi + lo halves, the backward's dS (dq), P^T and dS^T
  (dk/dv) entering their products as bf16 hi + lo, f32 sums and bf16
  outputs, all within the card's bf16 tolerance |err| <= 1e-3 + 2^-7 |ref|
  of the float32 plain versions; P, dS, P^T or dS^T rounded to bf16
  alone, as the JAX kernel rounds P (`p.astype(v.dtype)`), leave it;
* the emulated forward and dq against haff_tpu's `flash_attention` and
  its `jax.vjp` at bf16 in interpret mode at a small shape: with the
  Pallas kernel's rounding the forward reproduces the kernel's output
  within the same tolerance, with the port's it is closer to the float32
  plain version than the Pallas kernel; the emulated dq is within the
  tolerance of the Pallas dq and of the float32 plain version.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu_torch.kernels import flash_attention as fa

# haff_tpu.kernels re-exports the function under the module's name.
jfa = importlib.import_module("haff_tpu.kernels.flash_attention")

LOG2E = 1.0 / math.log(2.0)


def _rounded(x, split):
    """x as the tensor cores see it: bf16, or bf16 hi + lo halves."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _bad(got, ref):
    """Elements outside |err| <= 1e-3 + 2^-7 |ref|, and the worst ratio."""
    err = (got.float() - ref.float()).abs()
    tol = 1e-3 + 2.0 ** -7 * ref.float().abs()
    assert torch.isfinite(got).all()
    return int((err > tol).sum()), float((err / tol).max())


def emulate_forward(q, k, v, q_seg, kv_seg, causal, split=True):
    """The forward kernel's arithmetic on bf16-valued float32 operands
    (B, L, H, D): scores scaled by scale * log2 e, an online softmax over
    64-key tiles (running max, exp2, f32 row sums), P rounded (`split`:
    hi + lo) before P V with f32 sums, O / l rounded to bf16; fully masked
    rows give 0."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d ** -0.5 * LOG2E)
    mask = fa._mask(b, lq, lk, causal, q_seg, kv_seg, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, -torch.inf)
    m = torch.full((b, h, lq, 1), -torch.inf)
    l = torch.zeros(b, h, lq, 1)
    o = torch.zeros(b, h, lq, d)
    for j0 in range(0, lk, 64):
        st = s[..., j0:j0 + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - use)
        p = torch.exp2(st - use)
        m = m_new
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", _rounded(p, split),
                                     v[:, j0:j0 + 64])
    out = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(o))
    return out.permute(0, 2, 1, 3).bfloat16().float()


def _emulate_p_ds(q, k, v, q_seg, kv_seg, out, lse, do, causal):
    """The backward kernels' P and dS (B, H, Lq, Lk): S and dP from
    bf16-valued operands with f32 sums, P = exp2(S scale log2 e - lse log2
    e) where visible, dS = P (dP - delta) scale in f32, delta =
    rowsum(dO * O) as the wrapper computes it."""
    b, lq, h, d = q.shape
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = fa._mask(b, lq, k.shape[1], causal, q_seg, kv_seg, q.device)
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    p = p.masked_fill(~mask, 0.0)
    delta = (do * out).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None]) * scale
    return p, ds


def emulate_dq(q, k, v, q_seg, kv_seg, out, lse, do, causal, split=True):
    """flash_bwd_dq's arithmetic: dS (`_emulate_p_ds`) rounded (`split`:
    hi + lo) before dQ = dS K with f32 sums, dQ rounded to bf16."""
    _, ds = _emulate_p_ds(q, k, v, q_seg, kv_seg, out, lse, do, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", _rounded(ds, split), k)
    return dq.bfloat16().float()


def emulate_dkv(q, k, v, q_seg, kv_seg, out, lse, do, causal, split=True):
    """flash_bwd_dkv's arithmetic: P^T and dS^T (`_emulate_p_ds`, read
    key-major) rounded (`split`: hi + lo) before dV = P^T dO and dK = dS^T
    Q with f32 sums, dK and dV rounded to bf16."""
    p, ds = _emulate_p_ds(q, k, v, q_seg, kv_seg, out, lse, do, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", _rounded(ds, split), q)
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, split), do)
    return dk.bfloat16().float(), dv.bfloat16().float()


@pytest.fixture(scope="module")
def train_shape():
    """The prefill / train shape at two heads: bf16-valued operands, row 1
    right-padded by 100 (its pad queries see nothing, its pad keys are seen
    by none), and the float32 plain versions' forward and dk, dv."""
    b, l, h, d = 2, 575, 2, 128
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, l, h, d))
                                    .astype(np.float32)).bfloat16().float()
                   for _ in range(4))
    seg = (torch.arange(l)[None] < torch.tensor([l, l - 100])[:, None]).int()
    ref, lse = fa.attention_plain(q, k, v, None, seg, seg, True)
    out = ref.bfloat16().float()  # the forward's bf16 output, as the backward gets it
    _, dk, dv = fa.attention_bwd_plain(q, k, v, None, seg, seg, out, lse, do,
                                       True)
    return q, k, v, do, seg, ref, out, lse, dk, dv


@pytest.fixture(scope="module")
def train_dq(train_shape):
    """The float32 plain dq at the train shape."""
    q, k, v, do, seg, _, out, lse, *_ = train_shape
    return fa.attention_bwd_dq_plain(q, k, v, None, seg, seg, out, lse, do,
                                     True)


@pytest.mark.parametrize("dtype,d,offset,stride_pad,path", [
    (torch.bfloat16, 128, 0, 0, fa.WGMMA),
    (torch.bfloat16, 64, 0, 0, fa.WGMMA),
    (torch.bfloat16, 16, 0, 0, fa.WGMMA),
    (torch.float32, 128, 0, 0, fa.SCALAR),
    (torch.bfloat16, 24, 0, 0, fa.SCALAR),
    (torch.bfloat16, 256, 0, 0, fa.SCALAR),
    (torch.bfloat16, 128, 1, 0, fa.SCALAR),   # base 2 bytes off 16
    (torch.bfloat16, 64, 0, 4, fa.SCALAR),    # rows 68 elements apart
], ids=["bf16-d128", "bf16-d64", "bf16-d16", "f32", "d24", "d256",
        "misaligned-base", "misaligned-stride"])
def test_kernel_path(dtype, d, offset, stride_pad, path):
    b, l, h = 2, 9, 3
    buf = torch.zeros(b * l * h * (d + stride_pad) + offset, dtype=dtype)
    t = buf[offset:].view(b, l, h, d + stride_pad)[..., :d]
    if offset:  # keep the storage's own base aligned, so only the view is off
        assert buf.data_ptr() % 16 == 0 and t.data_ptr() % 16 != 0
    ok = torch.zeros(b, l, h, d, dtype=dtype)
    assert fa.kernel_path(t, ok, ok) == path
    assert fa.kernel_path(ok, ok, ok, t) == path  # dq, dk/dv: dO checked too
    assert fa.PATH_NAMES[path] in ("scalar", "wgmma")


@pytest.mark.parametrize("odd", ["none", "q", "k", "v", "dO"])
def test_backward_path_reads_every_operand(odd):
    """Both backward kernels launch on `kernel_path(q, k, v, dO)`: the
    tensor cores when all four are bf16 tensors TMA can address, the
    scalar code when any one of them starts 2 bytes off 16."""
    b, l, h, d = 2, 9, 3, 64
    ops = {}
    for name in ("q", "k", "v", "dO"):
        buf = torch.zeros(b * l * h * d + 1, dtype=torch.bfloat16)
        ops[name] = (buf[1:] if name == odd else buf[:-1]).view(b, l, h, d)
    want = fa.WGMMA if odd == "none" else fa.SCALAR
    assert fa.kernel_path(*ops.values()) == want


def test_emulated_forward_is_within_tolerance(train_shape):
    q, k, v, _, seg, ref, *_ = train_shape
    got = emulate_forward(q, k, v, seg, seg, True)
    assert _bad(got, ref)[0] == 0
    assert not got[1, 475:].any()


def test_emulated_dkv_is_within_tolerance(train_shape):
    q, k, v, do, seg, _, out, lse, dk, dv = train_shape
    gdk, gdv = emulate_dkv(q, k, v, seg, seg, out, lse, do, True)
    assert _bad(gdk, dk)[0] == 0 and _bad(gdv, dv)[0] == 0
    assert not gdk[1, 475:].any() and not gdv[1, 475:].any()


def test_emulated_dq_is_within_tolerance(train_shape, train_dq):
    q, k, v, do, seg, _, out, lse, *_ = train_shape
    got = emulate_dq(q, k, v, seg, seg, out, lse, do, True)
    bad, worst = _bad(got, train_dq)
    assert bad == 0 and worst < 0.5
    assert not got[1, 475:].any()


def test_bf16_products_alone_leave_the_tolerance(train_shape, train_dq):
    """Why the kernels split P, dS, P^T and dS^T: rounded to bf16 alone,
    each puts outputs outside the tolerance at this shape (dq: 33 values,
    worst 2.5x the tolerance, where hi + lo stays under 0.5x)."""
    q, k, v, do, seg, ref, out, lse, dk, dv = train_shape
    assert _bad(emulate_forward(q, k, v, seg, seg, True, split=False), ref)[0]
    gdk, gdv = emulate_dkv(q, k, v, seg, seg, out, lse, do, True, split=False)
    assert _bad(gdk, dk)[0] and _bad(gdv, dv)[0]
    bad, worst = _bad(emulate_dq(q, k, v, seg, seg, out, lse, do, True,
                                 split=False), train_dq)
    assert bad and worst > 1.0


def test_emulated_forward_against_pallas_at_bf16():
    """The emulation against the Pallas kernel it replaces, on bf16
    operands in interpret mode (causal, row 1 right-padded past a tile):
    with the Pallas kernel's own rounding (P to bf16) it reproduces the
    kernel's output within the tolerance, which checks the emulation's
    tiles, online softmax and masks against the reference; with the
    port's rounding (P as hi + lo) it is within the tolerance of the
    float32 plain version and closer to it than the Pallas kernel, whose
    bf16 P puts outputs outside that tolerance at this shape."""
    b, l, h, d = 2, 64, 2, 32
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    seg = (np.arange(l)[None] < np.array([[l], [l - 20]])).astype(np.int32)
    pallas = jfa.flash_attention(
        *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
        q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
        causal=True, block_q=32, block_k=32, interpret=True)
    pallas = torch.from_numpy(np.asarray(pallas, dtype=np.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16().float() for x in (q, k, v))
    ts = torch.from_numpy(seg)
    assert _bad(emulate_forward(tq, tk, tv, ts, ts, True, split=False),
                pallas)[0] == 0
    ref = fa.attention_plain(tq, tk, tv, None, ts, ts, True)[0]
    bad, worst = _bad(emulate_forward(tq, tk, tv, ts, ts, True), ref)
    assert bad == 0 and worst < _bad(pallas, ref)[1]


def test_emulated_dq_against_pallas_at_bf16():
    """The dq emulation against haff_tpu's dq: `jax.vjp` of the Pallas
    `flash_attention` in q on bf16 operands in interpret mode (causal, row
    1 right-padded past a tile), its backward fed the Pallas forward's
    bf16 output. The emulation, given that output, is within the
    tolerance of the Pallas dq (whose products are f32: the two differ by
    dS's hi + lo rounding and the bf16 output's) and of the float32 plain
    dq; padded query rows are exactly 0 in both."""
    b, l, h, d = 2, 64, 2, 32
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((b, l, h, d)).astype(np.float32)
                   for _ in range(4))
    seg = (np.arange(l)[None] < np.array([[l], [l - 20]])).astype(np.int32)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype=jnp.bfloat16)
                       for x in (q, k, v, do))
    jseg = jnp.asarray(seg)
    out, vjp = jax.vjp(lambda x: jfa.flash_attention(
        x, jk, jv, q_segment_ids=jseg, kv_segment_ids=jseg, causal=True,
        block_q=32, block_k=32, interpret=True), jq)
    pallas = torch.from_numpy(np.asarray(vjp(jdo)[0], dtype=np.float32))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16().float()
                       for x in (q, k, v, do))
    ts = torch.from_numpy(seg)
    tout = torch.from_numpy(np.asarray(out, dtype=np.float32))
    lse = fa.attention_plain(tq, tk, tv, None, ts, ts, True)[1]
    got = emulate_dq(tq, tk, tv, ts, ts, tout, lse, tdo, True)
    assert _bad(got, pallas)[0] == 0
    ref = fa.attention_bwd_dq_plain(tq, tk, tv, None, ts, ts, tout, lse, tdo,
                                    True)
    assert _bad(got, ref)[0] == 0
    assert not got[1, l - 20:].any() and not pallas[1, l - 20:].any()
