"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device; on the chip:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Each kernel runs on bf16 (and float32) inputs and is compared with the
plain version evaluated in float32 on the same input values. The kernel
computes in float32 too, so they differ by the output rounding (half a
bf16 ulp, 2^-8 relative) and summation order: tolerance
|err| <= 1e-3 + 2^-7 |ref| for bf16, 1e-4 + 1e-4 |ref| for float32. The
w8a8 product is exact in int32, so its float32 output must equal the
plain version's bit for bit.
"""

import pytest
import torch

from haff_tpu_torch.kernels import _build
from haff_tpu_torch.kernels import decode_attention as da
from haff_tpu_torch.kernels import flash_attention as fa
from haff_tpu_torch.kernels import sam_attention as sa
from haff_tpu_torch.nn import quant
from haff_tpu_torch.nn.layers import QDense

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_kernels_cuda.py)")
    return torch.device("cuda")


def _close(got, ref):
    tol = ((1e-3, 2.0 ** -7) if got.dtype == torch.bfloat16
           else (1e-4, 1e-4))
    err = (got.float() - ref.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= tol[0] + tol[1] * ref.float().abs()).all(), float(err.max())


def _scalar_bf16_launches():
    """bf16 SAM launches that took the scalar path (`<key>/scalar`)."""
    return {k: v for k, v in _build.LAUNCHES.items() if k.endswith("/scalar")}


def _assert_tensor_cores(dtype, scalar_before):
    """A bf16 case whose operands suit 16-byte copies runs on the tensor
    cores: no `/scalar` counter moved."""
    if dtype == torch.bfloat16:
        assert _scalar_bf16_launches() == scalar_before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nwin,w,nh,d", [(25, 14, 16, 80), (3, 6, 16, 16),
                                         (2, 4, 2, 16), (4, 7, 3, 32)])
def test_window_kernel_matches_plain(dev, dtype, nwin, w, nh, d):
    g = torch.Generator(dev).manual_seed(nwin * w)
    c, l = nh * d, w * w
    q3 = torch.randn(nwin, l, c, generator=g, device=dev).to(dtype)
    kv3 = torch.randn(nwin, l, 2 * c, generator=g, device=dev).to(dtype)
    rh = 0.2 * torch.randn(2 * w - 1, d, generator=g, device=dev)
    rw = 0.2 * torch.randn(2 * w - 1, d, generator=g, device=dev)
    before = _build.LAUNCHES["sam_window_relpos_attn"]
    scalar = _scalar_bf16_launches()
    got = sa.sam_window_attention_qkv_split(q3, kv3, rh, rw, (w, w), nh)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sam_window_relpos_attn"] == before + 1
    _assert_tensor_cores(dtype, scalar)
    ref = sa.window_attention_plain(q3.float(), kv3.float(), rh, rw, (w, w),
                                    nh, d ** -0.5)
    _close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,H,W,nh,d", [(1, 64, 64, 16, 80), (2, 8, 8, 2, 16),
                                        (1, 32, 32, 2, 128), (1, 10, 6, 3, 24),
                                        (2, 64, 64, 16, 80)])  # evaluate's batch
def test_global_kernel_matches_plain(dev, dtype, b, H, W, nh, d):
    g = torch.Generator(dev).manual_seed(H * W + d)
    c = nh * d
    qkv = torch.randn(b, H * W, 3 * c, generator=g, device=dev).to(dtype)
    rh = 0.2 * torch.randn(2 * H - 1, d, generator=g, device=dev)
    rw = 0.2 * torch.randn(2 * W - 1, d, generator=g, device=dev)
    scalar = _scalar_bf16_launches()
    got = sa.sam_global_attention_qkv(qkv, rh, rw, (H, W), nh)
    _assert_tensor_cores(dtype, scalar)
    ref = sa.global_attention_plain(qkv.float(), rh, rw, (H, W), nh, d ** -0.5)
    _close(got, ref)


def _segments(dev, b, lq, lk, seg):
    """Segment ids (B, Lq), (B, Lk) or None: row 0 whole, later rows
    right-padded by 70 (at least one token); `seg == "empty"` makes row 1
    all padding."""
    if not seg:
        return None, None
    qlen = [lq] + [max(lq - 70, 1)] * (b - 1)
    klen = [lk] + [max(lk - 70, 1)] * (b - 1)
    if seg == "empty":
        qlen[1] = klen[1] = 0
    qlen, klen = (torch.tensor(x, device=dev) for x in (qlen, klen))
    return ((torch.arange(lq, device=dev)[None] < qlen[:, None]).int(),
            (torch.arange(lk, device=dev)[None] < klen[:, None]).int())


def _flash_path(dtype, *operands):
    """bf16 operands (all of these take D % 16 == 0) run on the warpgroup
    MMA path, float32 on the scalar one."""
    want = fa.WGMMA if dtype == torch.bfloat16 else fa.SCALAR
    assert fa.kernel_path(*operands) == want


# The prefill shape; tiny and ragged tiles; Lq > Lk and Lq < Lk with the
# causal offset; an exact multiple of the 128-row block; a batch row that
# is all padding; D = 16, 32, 64, 128; with and without a bias.
FLASH_CASES = [
    (2, 575, 575, 32, 128, True, False, True),
    (2, 5, 5, 4, 16, True, False, True),
    (1, 70, 70, 2, 64, False, True, False),
    (2, 9, 130, 4, 32, True, True, True),
    (1, 130, 9, 2, 16, True, False, False),
    (2, 256, 256, 4, 128, True, False, True),
    (2, 100, 300, 4, 64, True, True, True),
    (3, 150, 150, 2, 128, True, False, "empty"),
    (2, 200, 200, 2, 16, True, True, True),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias,seg", FLASH_CASES)
def test_flash_prefill_matches_plain(dev, dtype, b, lq, lk, h, d, causal,
                                     bias, seg):
    g = torch.Generator(dev).manual_seed(lq * lk)
    q = torch.randn(b, lq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, lk, h, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, lk, h, d, generator=g, device=dev).to(dtype)
    bias_t = (torch.randn(1, h, 1, lk, generator=g, device=dev)
              if bias else None)
    qseg, kseg = _segments(dev, b, lq, lk, seg)
    _flash_path(dtype, q, k, v)
    scalar = _scalar_bf16_launches()
    out, lse = fa.flash_attention(q, k, v, bias_t, qseg, kseg, causal,
                                  return_lse=True)
    torch.cuda.synchronize()
    _assert_tensor_cores(dtype, scalar)
    ref, ref_lse = fa.attention_plain(q.float(), k.float(), v.float(), bias_t,
                                      qseg, kseg, causal)
    _close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
    if seg and b > 1:  # pad query rows: exactly zero
        n = int(qseg[1].sum())
        assert not out[1, n:].any() and not lse[1, :, n:].any()


@pytest.mark.parametrize("scope,b,hw,nh,d", [("window", 4, (14, 14), 4, 80),
                                            ("global", 1, (64, 64), 2, 64)])
def test_unaligned_bf16_views_take_the_scalar_path(dev, scope, b, hw, nh, d):
    """A bf16 fused projection that starts 2 bytes into its storage cannot
    be read by 16-byte copies: both kernels take their scalar path for it
    (counted under `<key>/scalar`) and stay within the bf16 tolerance."""
    g = torch.Generator(dev).manual_seed(7)
    l, c = hw[0] * hw[1], nh * d
    buf = torch.randn(b * l * 3 * c + 1, generator=g, device=dev).bfloat16()
    qkv = buf[1:].view(b, l, 3 * c)
    rh = 0.2 * torch.randn(2 * hw[0] - 1, d, generator=g, device=dev)
    rw = 0.2 * torch.randn(2 * hw[1] - 1, d, generator=g, device=dev)
    q, k, v = (sa.head_view(qkv, 3, i, nh) for i in range(3))
    assert sa.kernel_path(scope, q, k, v) == sa.SCALAR
    fn, key = ((sa.sam_window_attention_qkv, sa.WINDOW_FUSED) if scope == "window"
               else (sa.sam_global_attention_qkv, sa.GLOBAL_FUSED))
    before = dict(_build.LAUNCHES)
    got = fn(qkv, rh, rw, hw, nh)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before.get(key, 0) + 1
    assert _build.LAUNCHES[key + "/scalar"] == before.get(key + "/scalar", 0) + 1
    _close(got, sa.global_attention_plain(qkv.float(), rh, rw, hw, nh,
                                          d ** -0.5))


def test_window_kernel_keeps_bf16_where_v_exceeds_fp16(dev):
    """The window kernel multiplies P V in fp16 when every value of the
    block's V fits fp16; a window-head whose V holds a value above 65504
    takes the bf16 product instead and stays within tolerance."""
    g = torch.Generator(dev).manual_seed(11)
    nwin, hw, nh, d = 3, (14, 14), 2, 64
    l, c = hw[0] * hw[1], nh * d
    qkv = torch.randn(nwin, l, 3 * c, generator=g, device=dev)
    qkv[1, 5, 2 * c + 3] = 1e5            # one head's V in one window
    qkv = qkv.bfloat16()
    rh = 0.2 * torch.randn(2 * hw[0] - 1, d, generator=g, device=dev)
    rw = 0.2 * torch.randn(2 * hw[1] - 1, d, generator=g, device=dev)
    got = sa.sam_window_attention_qkv(qkv, rh, rw, hw, nh)
    _close(got, sa.global_attention_plain(qkv.float(), rh, rw, hw, nh,
                                          d ** -0.5))


def test_wrappers_refuse_unsupported_operands(dev):
    x = torch.zeros(1, 16, 8, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError), torch.no_grad():
        sa.sam_window_attention_qkv_split(
            x, torch.zeros(1, 16, 16, device=dev, dtype=torch.float16),
            torch.zeros(7, 4), torch.zeros(7, 4), (4, 4), 2)
    q = torch.zeros(1, 8, 2, 256, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias,seg", [
    (2, 575, 575, 32, 128, True, False, True),
    (2, 5, 5, 4, 16, True, False, True),
    (2, 9, 9, 3, 32, True, True, True),
    (1, 70, 70, 2, 64, False, True, False),
    (2, 130, 130, 4, 32, True, False, True),
    (1, 9, 130, 2, 16, True, False, False),
] + FLASH_CASES[5:])
def test_flash_backward_matches_plain(dev, dtype, b, lq, lk, h, d, causal,
                                      bias, seg):
    """dq (flash_bwd_dq) and dk/dv (flash_bwd_dkv) against
    attention_bwd_plain on the float32 values of the same operands; pad
    query rows give exactly-zero dq, pad keys exactly-zero dk/dv. Both
    kernels run bf16 on the warpgroup MMA path (no `/scalar` count
    moves), float32 on the scalar one."""
    g = torch.Generator(dev).manual_seed(7 * lq + lk)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, do = rnd(b, lq, h, d), rnd(b, lq, h, d)
    k, v = rnd(b, lk, h, d), rnd(b, lk, h, d)
    bias_t = (torch.randn(1, h, 1, lk, generator=g, device=dev)
              if bias else None)
    qseg, kseg = _segments(dev, b, lq, lk, seg)
    out, lse = fa.flash_prefill_kernel(q, k, v, bias_t, qseg, kseg, causal)
    args = (q, k, v, bias_t, qseg, kseg, out, lse, do, causal)
    _flash_path(dtype, q, k, v, do)
    scalar = _scalar_bf16_launches()
    before = dict(_build.LAUNCHES)
    dq = fa.flash_bwd_dq_kernel(*args)
    dk, dv = fa.flash_bwd_dkv_kernel(*args)
    torch.cuda.synchronize()
    _assert_tensor_cores(dtype, scalar)
    assert _build.LAUNCHES["flash_bwd_dq"] == before.get("flash_bwd_dq", 0) + 1
    assert _build.LAUNCHES["flash_bwd_dkv"] == before.get("flash_bwd_dkv", 0) + 1
    ref = fa.attention_bwd_plain(q.float(), k.float(), v.float(), bias_t,
                                 qseg, kseg, out.float(), lse, do.float(),
                                 causal)
    for got, r in zip((dq, dk, dv), ref):
        assert got.dtype == dtype
        _close(got, r)
    if seg and b > 1:
        assert not dq[1, int(qseg[1].sum()):].any()
        assert not dk[1, int(kseg[1].sum()):].any()
        assert not dv[1, int(kseg[1].sum()):].any()


def test_unaligned_bf16_flash_operands_take_the_scalar_path(dev):
    """bf16 q, k, v and dO that start 2 bytes into their storage cannot be
    read by TMA: the forward, dq and dk/dv kernels take their scalar path
    (counted under `<key>/scalar`) and stay within the bf16 tolerance."""
    g = torch.Generator(dev).manual_seed(5)
    b, l, h, d = 2, 70, 2, 64
    n = b * l * h * d

    def view():
        buf = torch.randn(n + 1, generator=g, device=dev).bfloat16()
        return buf[1:].view(b, l, h, d)

    q, k, v, do = view(), view(), view(), view()
    assert fa.kernel_path(q, k, v) == fa.kernel_path(q, k, v, do) == fa.SCALAR
    seg = torch.ones(b, l, dtype=torch.int32, device=dev)
    seg[1, 40:] = 0
    before = dict(_build.LAUNCHES)
    out, lse = fa.flash_prefill_kernel(q, k, v, None, seg, seg, True)
    dq = fa.flash_bwd_dq_kernel(q, k, v, None, seg, seg, out, lse, do, True)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, None, seg, seg, out, lse, do,
                                     True)
    torch.cuda.synchronize()
    for key in ("flash_prefill_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for k_ in (key, key + "/scalar"):
            assert _build.LAUNCHES[k_] == before.get(k_, 0) + 1, k_
    ref = fa.attention_plain(q.float(), k.float(), v.float(), None, seg, seg,
                             True)[0]
    _close(out, ref)
    rdq, rdk, rdv = fa.attention_bwd_plain(q.float(), k.float(), v.float(),
                                           None, seg, seg, out.float(), lse,
                                           do.float(), True)
    _close(dq, rdq)
    assert not dq[1, 40:].any()
    _close(dk, rdk)
    _close(dv, rdv)


def test_flash_attention_autograd_on_the_card(dev):
    """Grad mode routes flash_attention through FlashAttentionFn: the
    forward and both backward kernels launch once, and the gradients match
    torch autograd through the plain forward (float32)."""
    g = torch.Generator(dev).manual_seed(3)
    b, l, h, d = 2, 70, 4, 32
    q, k, v = (torch.randn(b, l, h, d, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    seg = torch.ones(b, l, dtype=torch.int32, device=dev)
    seg[1, 50:] = 0
    go = torch.randn(b, l, h, d, generator=g, device=dev)
    before = dict(_build.LAUNCHES)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, None, seg,
                                                 causal=True), (q, k, v), go)
    torch.cuda.synchronize()
    for name in ("flash_prefill_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1, name
    ref = torch.autograd.grad(fa.attention_plain(q, k, v, None, seg, seg,
                                                 True)[0], (q, k, v), go)
    for a, r in zip(got, ref):
        _close(a, r)


# ----- quantized products and decode attention -----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 1), (2, 4096, 4096), (2, 100, 7), (16, 37, 33), (17, 64, 130),
    (256, 1280, 7), (300, 52, 65), (2, 4096, 32004), (1150, 128, 32004),
    (9800, 1280, 3840), (129, 11008, 64), (1150, 11008, 4096),
    (8192, 1280, 5120), (17, 4096, 4096)])
def test_w8a8_kernel_matches_plain(dev, dtype, m, k, n):
    """Each shape on the path `w8a8_path` gives it: K % 16 == 0 the
    streamed skinny kernel (M <= 16) or the int8 tensor cores (M > 16),
    odd K the dp4a scalar kernels (also counted under
    `w8a8_matmul/scalar`)."""
    g = torch.Generator(dev).manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
    q, s = quant.quantize_kernel(w)
    want = (quant.W8A8_SCALAR if k % 16 else
            quant.W8A8_SKINNY if m <= 16 else quant.W8A8_WGMMA)
    assert quant.w8a8_path(quant.quantize_activation(x).values, q) == want
    before = dict(_build.LAUNCHES)
    got = quant.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w8a8_matmul"] == before.get("w8a8_matmul", 0) + 1
    scalar = "w8a8_matmul/scalar"
    assert _build.LAUNCHES[scalar] == (before.get(scalar, 0)
                                       + (want == quant.W8A8_SCALAR))
    assert got.dtype == dtype and got.shape == (m, n)
    xq, s_x = quant.quantize_activation(x)
    exact = quant.int8_matmul_plain(xq, q, s_x[:, 0], s, torch.float32)
    if dtype == torch.float32:
        assert torch.equal(got, exact)
    else:
        _close(got, exact)


def test_w8a8_kernel_on_an_unaligned_row_block(dev):
    """An out_split piece starting at a row whose byte offset is not a
    multiple of 16 (K = 40, row 3) takes the dp4a tile's byte-load path,
    counted under `w8a8_matmul/scalar`."""
    g = torch.Generator(dev).manual_seed(5)
    x = torch.randn(20, 40, generator=g, device=dev)
    q, s = quant.quantize_kernel(torch.randn(50, 40, generator=g, device=dev))
    before = _build.LAUNCHES["w8a8_matmul/scalar"]
    got = quant.int8_matmul(x, q[3:], s[3:])
    assert _build.LAUNCHES["w8a8_matmul/scalar"] == before + 1
    xq, s_x = quant.quantize_activation(x)
    assert torch.equal(got, quant.int8_matmul_plain(xq, q[3:], s_x[:, 0],
                                                    s[3:], torch.float32))


# LLaMA-7B's decode products (K, N): q/k/v/o, gate/up, down, lm_head; and
# narrow weights, ragged N and K not a multiple of the 512-byte stage.
SEVEN_B_DECODE = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32004)]
NARROW = [(4096, 64), (4096, 7), (2080, 33), (1040, 1000), (11008, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 5, 16])
@pytest.mark.parametrize("k,n", SEVEN_B_DECODE + NARROW)
def test_w8a8_skinny_kernel_at_decode_shapes(dev, dtype, m, k, n):
    """The streamed skinny kernel at every 7B decode shape and at narrow
    weights: on the skinny path (no `/scalar` launch), float32 equal to
    the exact product bit for bit, bf16 within one ulp."""
    g = torch.Generator(dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    q, s = quant.quantize_kernel(torch.randn(n, k, generator=g, device=dev)
                                 * k ** -0.5)
    xq, s_x = quant.quantize_activation(x)
    assert quant.w8a8_path(xq, q) == quant.W8A8_SKINNY
    before = dict(_build.LAUNCHES)
    got = quant.int8_matmul_kernel(xq, q, s_x[:, 0], s, dtype)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w8a8_matmul"] == before.get("w8a8_matmul", 0) + 1
    assert (_build.LAUNCHES["w8a8_matmul/scalar"]
            == before.get("w8a8_matmul/scalar", 0))
    exact = quant.int8_matmul_plain(xq, q, s_x[:, 0], s, torch.float32)
    if dtype == torch.float32:
        assert torch.equal(got, exact)
    else:
        _close(got, exact)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,group", [
    (1, 64, 1, 64), (2, 4096, 4096, 64), (2, 4096, 11008, 64),
    (2, 11008, 4096, 64), (2, 4096, 32004, 64), (3, 48, 7, 16),
    (5, 2080, 33, 32), (256, 1280, 7, 128), (256, 4096, 1024, 64)])
def test_w4a16_kernel_matches_plain(dev, dtype, m, k, n, group):
    """Each case on the path it must take: bf16 with K % 32 == 0 and a
    scale row of a multiple of 16 bytes on the mma kernel, float32 and the
    odd widths on the scalar kernel (counted under `w4a16_matmul/scalar`)."""
    g = torch.Generator(dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
    packed, s = quant.quantize_kernel_int4(w, group)
    want = (quant.W4A16_MMA if dtype == torch.bfloat16 and k % 32 == 0
            and (k // group) % 4 == 0 else quant.W4A16_SCALAR)
    assert quant.w4a16_path(x, packed, s, group) == want
    before = dict(_build.LAUNCHES)
    got = quant.int4_matmul(x, packed, s, group)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a16_matmul"] == before.get("w4a16_matmul", 0) + 1
    scalar = "w4a16_matmul/scalar"
    assert _build.LAUNCHES[scalar] == (before.get(scalar, 0)
                                       + (want == quant.W4A16_SCALAR))
    assert got.dtype == dtype and got.shape == (m, n)
    # Same rounded weight and inputs, float32 accumulation, unrounded sum.
    wd = quant.dequantize_kernel_int4(packed, s, group, dtype).float()
    _close(got, x.float() @ wd.T)


# Besides the 7B decode shapes: a partial last stage and super-span (K =
# 4160, 1152), a group that is not a power of two (48), ragged N.
W4A16_ODD = [(4160, 24, 16), (1152, 40, 48), (1152, 7, 96)]


@pytest.mark.parametrize("m", [1, 2, 8, 16, 37, 256])
@pytest.mark.parametrize("k,n,group", [(k, n, 64) for k, n in SEVEN_B_DECODE]
                         + W4A16_ODD)
def test_w4a16_mma_kernel_at_decode_shapes(dev, m, k, n, group):
    """The bf16 mma kernel at every 7B decode shape (M = 1, 2, 8, 16), at M
    = 256 and at an M of three row tiles: on the mma path (no `/scalar`
    launch), within the bf16 tolerance of the product of the same rounded
    weight in float32."""
    g = torch.Generator(dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5
    packed, s = quant.quantize_kernel_int4(w, group)
    assert quant.w4a16_path(x, packed, s, group) == quant.W4A16_MMA
    before = dict(_build.LAUNCHES)
    got = quant.int4_matmul_kernel(x, packed, s, group, torch.bfloat16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a16_matmul"] == before.get("w4a16_matmul", 0) + 1
    assert (_build.LAUNCHES["w4a16_matmul/scalar"]
            == before.get("w4a16_matmul/scalar", 0))
    wd = quant.dequantize_kernel_int4(packed, s, group, torch.bfloat16).float()
    _close(got, x.float() @ wd.T)


def test_w4a16_large_m_and_odd_groups_take_the_dequant_route(dev):
    g = torch.Generator(dev).manual_seed(9)
    w = torch.randn(24, 96, generator=g, device=dev)
    before = _build.LAUNCHES["w4a16_matmul"]
    for m, group in ((257, 32), (4, 8), (4, 24)):
        packed, s = quant.quantize_kernel_int4(w, group)
        x = torch.randn(m, 96, generator=g, device=dev)
        got = quant.int4_matmul(x, packed, s, group)
        ref = x @ quant.dequantize_kernel_int4(packed, s, group,
                                               torch.float32).T
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert _build.LAUNCHES["w4a16_matmul"] == before


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,lmax,nh,nkv,hd", [
    (2, 591, 32, 32, 128), (3, 5, 4, 4, 16), (2, 70, 8, 2, 32),
    (2, 1500, 16, 4, 80), (1, 33, 4, 1, 128)])
def test_decode_kernel_matches_plain(dev, qdtype, kind, b, lmax, nh, nkv, hd):
    g = torch.Generator(dev).manual_seed(lmax + hd)
    q = (0.5 * torch.randn(b, nh, hd, generator=g, device=dev)).to(qdtype)
    k = 0.5 * torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
    v = torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
    if kind == "int8":
        k, v = quant.quantize_activation(k), quant.quantize_activation(v)
    elif kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    lengths = torch.tensor([lmax, 1, max(lmax // 2, 1)][:b], device=dev)
    mask = (torch.arange(lmax, device=dev)[None] < lengths[:, None]).int()
    mask[0, lmax // 3] = 0  # a hole: live slots need not be a prefix
    before = _build.LAUNCHES["decode_attn"]
    got = da.flash_decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attn"] == before + 1
    ref = da.decode_attention_plain(q.float(), k, v, mask, hd ** -0.5)
    assert got.dtype == qdtype
    _close(got, ref)


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("b,lmax,nh,nkv,hd,lengths", [
    (2, 591, 32, 32, 128, (590, 1)), (2, 591, 32, 32, 128, (590, 590)),
    (2, 591, 32, 8, 128, (590, 0)), (2, 300, 64, 4, 64, (17, 300)),
    (3, 200, 8, 2, 20, (200, 0, 70)), (1, 9, 4, 4, 12, (5,))])
def test_decode_split_kernel_matches_plain(dev, kind, b, lmax, nh, nkv, hd,
                                           lengths):
    """The split kernel at LLaMA-7B's decode shape (live lengths (590, 1)
    and (590, 590)), with GQA (4 and 16 query heads a kv head: two head
    blocks), an all-dead row (exactly 0) and rows the 16-byte copies cannot
    read (hd * itemsize not a multiple of 16): against the plain version
    and the split-and-merge emulation of decode_plan's split, one launch
    counted a call."""
    g = torch.Generator(dev).manual_seed(lmax + nh + hd)
    q = (0.5 * torch.randn(b, nh, hd, generator=g, device=dev)).bfloat16()
    k = 0.5 * torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
    v = torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
    if kind == "int8":
        k, v = quant.quantize_activation(k), quant.quantize_activation(v)
    elif kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    mask = (torch.arange(lmax, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).int()
    before = _build.LAUNCHES["decode_attn"]
    got = da.decode_attention_kernel(q, k, v, mask, hd ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attn"] == before + 1
    ref = da.decode_attention_plain(q.float(), k, v, mask, hd ** -0.5)
    _close(got, ref)
    _close(got, da.decode_attention_split(q.float(), k, v, mask, hd ** -0.5))
    for row, n in enumerate(lengths):
        if n == 0:
            assert not got[row].any()


def test_decode_kernel_gives_zero_for_a_row_without_live_slots(dev):
    g = torch.Generator(dev).manual_seed(1)
    q = torch.randn(2, 4, 32, generator=g, device=dev)
    k = torch.randn(2, 40, 4, 32, generator=g, device=dev)
    mask = torch.ones(2, 40, dtype=torch.int32, device=dev)
    mask[1] = 0
    got = da.flash_decode_attention(q, k, k, mask)
    assert torch.isfinite(got).all() and not got[1].any() and got[0].any()


def test_quantized_wrappers_refuse_grad_and_bad_operands(dev):
    """The quantized products take grad now (their straight-through
    backward, `test_quantized_products_under_grad_on_the_card`); decode
    attention stays forward-only; bad operands raise."""
    x = torch.randn(2, 64, device=dev, requires_grad=True)
    q, s = quant.quantize_kernel(torch.randn(8, 64, device=dev))
    quant.int8_matmul(x, q, s).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    packed, s4 = quant.quantize_kernel_int4(torch.randn(8, 64, device=dev), 16)
    x.grad = None
    quant.int4_matmul(x, packed, s4, 16).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    kv = torch.randn(2, 5, 2, 32, device=dev)
    with pytest.raises(RuntimeError):
        da.flash_decode_attention(torch.randn(2, 2, 32, device=dev,
                                              requires_grad=True), kv, kv,
                                  torch.ones(2, 5, device=dev))
    with torch.no_grad():
        with pytest.raises(TypeError):
            quant.int8_matmul(x.half(), q, s)
        with pytest.raises(ValueError):
            da.flash_decode_attention(torch.randn(2, 2, 256, device=dev),
                                      torch.randn(2, 5, 2, 256, device=dev),
                                      torch.randn(2, 5, 2, 256, device=dev),
                                      torch.ones(2, 5, device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits,m", [(8, 2), (8, 1150), (4, 2), (4, 256),
                                    (4, 600)])
def test_quantized_products_under_grad_on_the_card(dev, dtype, bits, m):
    """The straight-through backward on the card: the kernel route's
    output and dx (W8A8: the tensor-core path at M > 16, the skinny one at
    decode M; W4A16: the kernel at M <= 256, the dequantize route above)
    against the same product on the CPU (plain versions) from the same
    values, q and scale without gradient."""
    g = torch.Generator().manual_seed(bits * m)
    k, n = 4096, 256
    w = torch.randn(n, k, generator=g) / 64
    x = torch.randn(m, k, generator=g).to(dtype)
    dy = torch.randn(m, n, generator=g).to(dtype)
    if bits == 8:
        q, s = quant.quantize_kernel(w)
        fn = lambda t, q, s: quant.int8_matmul(t, q, s)  # noqa: E731
    else:
        q, s = quant.quantize_kernel_int4(w, 64)
        fn = lambda t, q, s: quant.int4_matmul(t, q, s, 64)  # noqa: E731
    out = {}
    for where in ("cpu", dev):
        xt = x.to(where).detach().clone().requires_grad_()
        before = dict(_build.LAUNCHES)
        y = fn(xt, q.to(where), s.to(where))
        y.backward(dy.to(where))
        launched = {kk: v - before.get(kk, 0) for kk, v in
                    _build.LAUNCHES.items() if v != before.get(kk, 0)}
        out[str(where)] = (y.detach().cpu(), xt.grad.cpu(), launched)
    (y_c, dx_c, none), (y_g, dx_g, ran) = out["cpu"], out[str(dev)]
    assert not none
    product = "w8a8_matmul" if bits == 8 else "w4a16_matmul"
    assert ran.get(product, 0) == (0 if bits == 4 and m > 256 else 1)
    assert not any(kk.endswith("/scalar") for kk in ran) or dtype != \
        torch.bfloat16
    _close(y_g, y_c)
    _close(dx_g, dx_c)
    assert dx_g.dtype == dtype


@pytest.mark.parametrize("bits,group", [(8, 64), (4, 16)])
def test_quantized_qdense_on_the_card_matches_the_cpu(dev, bits, group):
    """A quantized QDense (bias, 3-D input, out_split) on the card, through
    the kernels, against the same layer on the CPU (plain versions)."""
    g = torch.Generator().manual_seed(bits)
    cpu = QDense(64, 48)
    with torch.no_grad():
        cpu.weight.copy_(torch.randn(48, 64, generator=g) / 8)
        cpu.bias.copy_(torch.randn(48, generator=g))
    cpu.quantize_(bits, group)
    gpu = QDense(64, 48)
    gpu.set_quantized_(cpu.weight.clone(), cpu.scale.clone())
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    x = torch.randn(2, 5, 64, generator=g)
    with torch.no_grad():
        ref = cpu(x, out_split=(16, 32))
        got = gpu(x.to(dev), out_split=(16, 32))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-5, atol=1e-5)


def test_quantizers_on_the_card_equal_the_cpu_bit_for_bit(dev):
    """The quantization arithmetic is IEEE float32 on both devices (a
    division by a Python scalar would not be, on the card)."""
    g = torch.Generator().manual_seed(11)
    w = torch.randn(96, 256, generator=g) / 16
    x = torch.randn(4, 7, 256, generator=g)
    for fn, arg in ((quant.quantize_kernel, w),
                    (lambda t: quant.quantize_kernel_int4(t, 64), w),
                    (quant.quantize_activation, x)):
        for a, r in zip(fn(arg.to(dev)), fn(arg)):
            assert a.dtype == r.dtype and torch.equal(a.cpu(), r)


# ----- SAM attention: every entry, geometry and operand layout -----

def _sam_inputs(dev, dtype, b, hw, nh, d, seed=0):
    g = torch.Generator(dev).manual_seed(seed + b * hw[0] + d)
    l, c = hw[0] * hw[1], nh * d
    qkv = torch.randn(b, l, 3 * c, generator=g, device=dev).to(dtype)
    rh = 0.2 * torch.randn(2 * hw[0] - 1, d, generator=g, device=dev)
    rw = 0.2 * torch.randn(2 * hw[1] - 1, d, generator=g, device=dev)
    return qkv, rh, rw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nwin,hw,nh,d", [
    (25, (14, 14), 12, 64),   # ViT-B windows
    (16, (8, 8), 8, 32),      # the small preset
    (25, (14, 12), 16, 80),   # non-square
    (5, (14, 14), 16, 80),    # a window count no group divides
    (2, (18, 18), 8, 32),     # above 16 x 16
    (3, (20, 20), 2, 128),    # too large for the window kernel's shared memory
    (1, (5, 7), 3, 24)])
def test_window_entries_agree_on_every_layout(dev, dtype, nwin, hw, nh, d):
    """The fused, split and per-head entries read one storage in place
    through different pointers and strides: equal bits among themselves,
    and the plain version within tolerance; each counts under its key."""
    qkv, rh, rw = _sam_inputs(dev, dtype, nwin, hw, nh, d)
    l, c = hw[0] * hw[1], nh * d
    before, scalar = dict(_build.LAUNCHES), _scalar_bf16_launches()
    fused = sa.sam_window_attention_qkv(qkv, rh, rw, hw, nh)
    split = sa.sam_window_attention_qkv_split(
        qkv[..., :c].contiguous(), qkv[..., c:].contiguous(), rh, rw, hw, nh)
    # Per-head operands that are strided slices of the fused tensor and a
    # contiguous copy: both are valid layouts.
    q, k, v = (sa.head_view(qkv, 3, i, nh) for i in range(3))
    heads = sa.sam_window_attention(q, k, v, rh, rw, hw)
    heads_c = sa.sam_window_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), rh, rw, hw)
    torch.cuda.synchronize()
    for key, n in ((sa.WINDOW_FUSED, 1), (sa.WINDOW_SPLIT, 1),
                   (sa.WINDOW_HEADS, 2)):
        assert _build.LAUNCHES[key] == before.get(key, 0) + n, key
    _assert_tensor_cores(dtype, scalar)
    assert heads.shape == (nwin, l, nh, d)
    for other in (split, heads.reshape(nwin, l, c), heads_c.reshape(nwin, l, c)):
        assert torch.equal(fused, other)
    _close(fused, sa.global_attention_plain(qkv.float(), rh, rw, hw, nh,
                                            d ** -0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,nh,d", [
    (1, (64, 64), 12, 64),    # ViT-B global block
    (2, (32, 32), 8, 32),     # the small preset
    (1, (12, 20), 3, 24),     # ragged last query and key tile (240 = 3*64+48)
    (2, (16, 16), 2, 32)])
def test_global_entries_agree_on_every_layout(dev, dtype, b, hw, nh, d):
    qkv, rh, rw = _sam_inputs(dev, dtype, b, hw, nh, d, seed=1)
    l, c = hw[0] * hw[1], nh * d
    before, scalar = dict(_build.LAUNCHES), _scalar_bf16_launches()
    fused = sa.sam_global_attention_qkv(qkv, rh, rw, hw, nh)
    q, k, v = (sa.head_view(qkv, 3, i, nh) for i in range(3))
    heads = sa.sam_global_attention(q, k, v, rh, rw, hw)
    heads_c = sa.sam_global_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), rh, rw, hw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[sa.GLOBAL_FUSED] == before.get(sa.GLOBAL_FUSED, 0) + 1
    assert _build.LAUNCHES[sa.GLOBAL_HEADS] == before.get(sa.GLOBAL_HEADS, 0) + 2
    _assert_tensor_cores(dtype, scalar)
    assert torch.equal(fused, heads.reshape(b, l, c))
    assert torch.equal(fused, heads_c.reshape(b, l, c))
    _close(fused, sa.global_attention_plain(qkv.float(), rh, rw, hw, nh,
                                            d ** -0.5))


def test_sam_wrappers_refuse_layouts_the_kernels_cannot_read(dev):
    qkv, rh, rw = _sam_inputs(dev, torch.float32, 2, (4, 4), 2, 16)
    q, k, v = (sa.head_view(qkv, 3, i, 2) for i in range(3))
    with pytest.raises(ValueError, match="strides"):   # heads not adjacent
        sa.sam_window_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k, v, rh, rw, (4, 4))
    with pytest.raises(TypeError):
        sa.sam_window_attention(q, k.bfloat16(), v, rh, rw, (4, 4))
    with pytest.raises(ValueError):
        sa.sam_global_attention(q, k, v, rh, rw, (4, 5))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 1000, 3 * 128, device=dev)
        sa.sam_global_attention_qkv(big, torch.zeros(1, 128, device=dev),
                                    torch.zeros(1999, 128, device=dev),
                                    (1, 1000), 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry,hw,nh,d", [("window_split", (14, 14), 16, 80),
                                           ("window_fused", (8, 8), 8, 32),
                                           ("global", (64, 64), 16, 80),
                                           ("global", (16, 16), 2, 32),
                                           ("global", (8, 8), 2, 16)])
def test_sam_attention_backward_on_the_card(dev, dtype, entry, hw, nh, d):
    """The kernel forward with the plain-torch backward against autograd
    through the plain version, in float32 on the same values. The global
    entry's tables get exact zeros where `global_tables_frozen`, true
    gradients at the 8 x 8 grid."""
    b = 1 if hw[0] == 64 else 3
    qkv, rh, rw = _sam_inputs(dev, dtype, b, hw, nh, d, seed=2)
    c = nh * d
    g = torch.Generator(dev).manual_seed(3)
    go = torch.randn(b, hw[0] * hw[1], c, generator=g, device=dev).to(dtype)
    ins = [t.requires_grad_() for t in (qkv, rh, rw)]
    ref_ins = [t.detach().float().requires_grad_() for t in ins]
    ref_out = sa.global_attention_plain(*ref_ins, hw, nh, d ** -0.5)
    ref = torch.autograd.grad(ref_out, ref_ins, go.float())
    before, scalar = dict(_build.LAUNCHES), _scalar_bf16_launches()
    if entry == "window_split":
        out = sa.sam_window_attention_qkv_split(
            qkv[..., :c].contiguous(), qkv[..., c:].contiguous(), rh, rw, hw, nh)
        key = sa.WINDOW_SPLIT
    elif entry == "window_fused":
        out, key = sa.sam_window_attention_qkv(*ins, hw, nh), sa.WINDOW_FUSED
    else:
        out, key = sa.sam_global_attention_qkv(*ins, hw, nh), sa.GLOBAL_FUSED
    got = torch.autograd.grad(out, ins, go)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before.get(key, 0) + 1
    _assert_tensor_cores(dtype, scalar)
    _close(out, ref_out)
    frozen = entry == "global" and sa.global_tables_frozen(hw)
    for name, a, r in zip(("qkv", "rel_h", "rel_w"), got, ref):
        assert a.dtype == (dtype if name == "qkv" else torch.float32)
        if frozen and name != "qkv":
            assert not a.any(), name
            continue
        # Gradients are sums over up to 4096 keys of bf16-rounded terms:
        # compare at the scale of the leaf.
        err = float((a.float() - r).abs().max())
        tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * float(
            r.abs().max()) + 1e-6
        assert err <= tol, (name, err, tol)


def test_sam_encoder_backward_with_remat_on_the_card(dev):
    """A 4-block encoder at the small preset: remat recomputes each block,
    so every SAM kernel launches twice a forward + backward, and the
    gradients equal the CPU's (plain versions)."""
    from haff_tpu_torch.core.config import SamEncoderConfig
    from haff_tpu_torch.model.lisa import init_random_
    from haff_tpu_torch.nn.sam_image_encoder import SamImageEncoder

    cfg = SamEncoderConfig.preset("small")
    gpu = SamImageEncoder(cfg).to(dev)
    init_random_(gpu, torch.Generator(dev).manual_seed(0))
    cpu = SamImageEncoder(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 512, 512, 3, generator=gen)
    # A random cotangent: the last LayerNorm makes sum(emb^2) nearly constant.
    go = torch.randn(1, 32, 32, cfg.out_chans, generator=gen)
    before = dict(_build.LAUNCHES)
    (gpu(x.to(dev), remat=True) * go.to(dev)).sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[sa.WINDOW_SPLIT] == before.get(sa.WINDOW_SPLIT, 0) + 4
    assert _build.LAUNCHES[sa.GLOBAL_FUSED] == before.get(sa.GLOBAL_FUSED, 0) + 4
    (cpu(x) * go).sum().backward()
    for (name, p), q in zip(gpu.named_parameters(), cpu.parameters()):
        err = float((p.grad.cpu() - q.grad).abs().max())
        assert err <= 1e-3 * float(q.grad.abs().max()) + 1e-6, (name, err)


@pytest.mark.parametrize("m,k,n", [(2048, 2048, 2048), (70, 64, 130),
                                   (1, 32, 1), (65, 96, 63)])
def test_matmul_probe_matches_plain(dev, m, k, n):
    from haff_tpu_torch.tools.bench_kernels import (PROBE, matmul_probe,
                                                    matmul_probe_plain)

    g = torch.Generator(dev).manual_seed(m + n)
    a8, b8 = (torch.randint(-127, 128, s, generator=g, device=dev,
                            dtype=torch.int8) for s in ((m, k), (n, k)))
    before = _build.LAUNCHES[PROBE]
    got = matmul_probe(a8, b8)
    assert got.dtype == torch.int32
    assert torch.equal(got, matmul_probe_plain(a8, b8))
    a16, b16 = (torch.randn(s, generator=g, device=dev).bfloat16()
                for s in ((m, k), (n, k)))
    got = matmul_probe(a16, b16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[PROBE] == before + 2
    torch.testing.assert_close(got, matmul_probe_plain(a16, b16), rtol=1e-4,
                               atol=1e-4 * k ** 0.5)
    with pytest.raises(ValueError):
        matmul_probe(a8[:, :k - 1].contiguous(), b8[:, :k - 1].contiguous())
    with pytest.raises(TypeError):
        matmul_probe(a8, b16)


def test_stream_handle_is_the_current_stream(dev):
    """`_build.stream_handle` reads torch's private raw-stream accessor for
    every wrapper's launch: it must exist and give the stream
    `torch.cuda.current_stream` names, on the default stream and on a side
    stream."""
    d = torch.empty(1, device=dev).device  # with its index, as a wrapper's
    assert hasattr(torch._C, "_cuda_getCurrentRawStream")
    assert _build.stream_handle(d).value == \
        (torch.cuda.current_stream(d).cuda_stream or None)
    side = torch.cuda.Stream(d)
    with torch.cuda.stream(side):
        assert _build.stream_handle(d).value == side.cuda_stream


@pytest.mark.parametrize("kv_cache_8bit", [False, True])
def test_graphed_evaluate_equals_eager(dev, kv_cache_8bit):
    """make_jitted_evaluate on the card (the decode loop captured in a CUDA
    graph at the first call, replayed at the next two) against evaluate_fn
    at the tiny preset in float32: identical tokens, masks and taxonomy
    within 1e-6, and the same launches per call."""
    import collections

    import numpy as np

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny")
    model = LisaModel(cfg, torch.float32, device=dev)
    rng = np.random.RandomState(0)
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    graphed = make_jitted_evaluate(model, 6, 2, kv_cache_8bit=kv_cache_8bit)

    def counted(fn, req):
        before = collections.Counter(_build.LAUNCHES)
        out = fn(*req)
        torch.cuda.synchronize()
        after = collections.Counter(_build.LAUNCHES)
        after.subtract(before)
        return out, +after

    for call in range(3):
        ids = rng.randint(5, 400, (2, 12))
        ids[:, 2] = -200
        att = np.ones((2, 12), np.int64)
        att[1, 8 + call:] = 0
        req = (rng.randn(2, S, S, 3).astype(np.float32),
               rng.randn(2, C, C, 3).astype(np.float32), ids, att)
        got, n_got = counted(graphed, req)
        ref, n_ref = counted(lambda *r: evaluate_fn(
            model, *r, 6, 2, kv_cache_8bit=kv_cache_8bit), req)
        assert torch.equal(got.output_ids, ref.output_ids)
        assert torch.equal(got.gen_lengths, ref.gen_lengths)
        for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
            torch.testing.assert_close(getattr(got, key), getattr(ref, key),
                                       rtol=0, atol=1e-6)
        assert n_got == n_ref and n_ref["decode_attn"] == 5 * cfg.llama.num_layers
    assert (graphed.captures, graphed.replays) == (1, 2)


# ----- speculative decode and the MPT decoder -----

# MPT-7B's W8A8 products (K, N): the fused Wqkv, up and down at expansion 4.
MPT_7B = [(4096, 12288), (4096, 16384), (16384, 4096)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [2, 16, 1150])
@pytest.mark.parametrize("k,n", MPT_7B)
def test_w8a8_kernel_at_mpt_shapes(dev, dtype, m, k, n):
    """MPT-7B's products at a decode step (M = 2), a speculative verify
    step (M = 16, both on the skinny kernel) and its prefill (the tensor
    cores), as test_w8a8_kernel_matches_plain holds them."""
    test_w8a8_kernel_matches_plain(dev, dtype, m, k, n)


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("b,lmax,nh,nkv,hd,lengths", [
    (2, 591, 32, 32, 128, (590, 1)), (2, 591, 32, 32, 128, (590, 590)),
    (2, 300, 12, 12, 64, (17, 300)), (2, 200, 32, 1, 128, (200, 0))])
def test_decode_kernel_with_alibi_slopes_matches_plain(dev, kind, b, lmax, nh,
                                                       nkv, hd, lengths):
    """The kernel's ALiBi variant (MPT's decode step: slot j's score gains
    slope_h * j, up to 0.84 x 590 here) at MPT-7B's shape, 12 heads
    (interleaved slopes) and multi-query attention (one kv head, 32 query
    heads: four head blocks), against the plain version and the split
    emulation with the same slopes; one launch counted under
    `decode_attn/alibi` too; an all-dead row exactly 0."""
    from haff_tpu_torch.nn.mpt import alibi_slopes

    g = torch.Generator(dev).manual_seed(lmax + nh + nkv)
    q = (0.5 * torch.randn(b, nh, hd, generator=g, device=dev)).bfloat16()
    k = 0.5 * torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
    v = torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
    if kind == "int8":
        k, v = quant.quantize_activation(k), quant.quantize_activation(v)
    elif kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    mask = (torch.arange(lmax, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).int()
    slopes = alibi_slopes(nh, device=dev)
    before = dict(_build.LAUNCHES)
    got = da.decode_attention_kernel(q, k, v, mask, hd ** -0.5, slopes=slopes)
    torch.cuda.synchronize()
    for key in ("decode_attn", "decode_attn/alibi"):
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1, key
    ref = da.decode_attention_plain(q.float(), k, v, mask, hd ** -0.5,
                                    slopes=slopes)
    _close(got, ref)
    _close(got, da.decode_attention_split(q.float(), k, v, mask, hd ** -0.5,
                                          slopes=slopes))
    plain = da.decode_attention_plain(q.float(), k, v, mask, hd ** -0.5)
    assert not torch.allclose(got.float(), plain, atol=1e-2)
    for row, n in enumerate(lengths):
        if n == 0:
            assert not got[row].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,h,d", [(2, 575, 32, 128), (2, 130, 12, 64)])
def test_flash_prefill_with_alibi_bias(dev, dtype, b, l, h, d):
    """The flash forward with MPT's ALiBi column bias (1, nh, 1, L) as its
    bias operand, read through strides, magnitudes up to ~480 at MPT-7B's
    prefill (2, 575, 32, 128), causal, row 1 right-padded."""
    from haff_tpu_torch.nn.mpt import alibi_column_bias

    g = torch.Generator(dev).manual_seed(l + h)
    q, k, v = (torch.randn(b, l, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    seg = torch.ones(b, l, dtype=torch.int32, device=dev)
    seg[1, l - l // 5:] = 0
    bias = alibi_column_bias(h, l, device=dev)
    assert float(bias.max()) > 0.5 * (l - 1)
    _flash_path(dtype, q, k, v)
    scalar = _scalar_bf16_launches()
    out, lse = fa.flash_attention(q, k, v, bias, seg, seg, True,
                                  return_lse=True)
    torch.cuda.synchronize()
    _assert_tensor_cores(dtype, scalar)
    ref, ref_lse = fa.attention_plain(q.float(), k.float(), v.float(), bias,
                                      seg, seg, True)
    _close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)
    assert not out[1, l - l // 5:].any()


def _tiny_requests(cfg, rng, call):
    import numpy as np

    ids = rng.randint(5, 400, (2, 12))
    ids[:, 2] = -200
    att = np.ones((2, 12), np.int64)
    att[1, 8 + call:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.randn(2, S, S, 3).astype(np.float32),
            rng.randn(2, C, C, 3).astype(np.float32), ids, att)


def _counted(fn, req):
    import collections

    before = collections.Counter(_build.LAUNCHES)
    out = fn(*req)
    torch.cuda.synchronize()
    after = collections.Counter(_build.LAUNCHES)
    after.subtract(before)
    return out, +after


@pytest.mark.parametrize("kv_cache_8bit", [False, True])
def test_graphed_speculative_evaluate_equals_eager(dev, kv_cache_8bit):
    """make_jitted_evaluate(draft_corpus=...) on the card (one verify step
    captured at the first call, replayed while a row is live at the next
    two) against evaluate_fn's eager speculative decode and against greedy
    at the tiny preset in float32: identical tokens and decode steps,
    masks within 1e-6 of eager, the same launches per call, replays
    equal to the replayed calls' decode steps."""
    import numpy as np

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.infer.generate import make_lookup_corpus
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny")
    model = LisaModel(cfg, torch.float32, device=dev)
    corpus, lens = make_lookup_corpus([[3, 4, 5]], 8, 1, 2)
    kw = dict(kv_cache_8bit=kv_cache_8bit, draft_corpus=corpus,
              corpus_lengths=lens, draft_len=3)
    graphed = make_jitted_evaluate(model, 6, 2, **kw)
    rng = np.random.RandomState(0)
    replayed = 0
    for call in range(3):
        req = _tiny_requests(cfg, rng, call)
        got, n_got = _counted(graphed, req)
        ref, n_ref = _counted(lambda *r: evaluate_fn(model, *r, 6, 2, **kw),
                              req)
        plain = evaluate_fn(model, *req, 6, 2, kv_cache_8bit=kv_cache_8bit)
        for other in (ref, plain):
            assert torch.equal(got.output_ids, other.output_ids)
            assert torch.equal(got.gen_lengths, other.gen_lengths)
        assert int(got.decode_steps) == int(ref.decode_steps)
        for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
            torch.testing.assert_close(getattr(got, key), getattr(ref, key),
                                       rtol=0, atol=1e-6)
        assert n_got == n_ref and "decode_attn" not in n_ref
        replayed += int(got.decode_steps) if call else 0
    assert graphed.captures == 1 and graphed.replays == replayed


@pytest.mark.parametrize("kv_cache_8bit", [False, True])
def test_mpt_evaluate_on_the_card_matches_the_cpu(dev, kv_cache_8bit):
    """The MPT decoder at tiny in float32: evaluate_fn and the graphed
    evaluate on the card against evaluate_fn on the CPU from the same
    weights: identical tokens, masks within 1e-4, every decode step on
    the decode kernel's ALiBi variant."""
    import numpy as np

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny").replace(decoder="mpt")
    gpu = LisaModel(cfg, torch.float32, device=dev)
    cpu = LisaModel(cfg, torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    req = _tiny_requests(cfg, np.random.RandomState(1), 0)
    ref = evaluate_fn(cpu, *req, 6, 2, kv_cache_8bit=kv_cache_8bit)
    graphed = make_jitted_evaluate(gpu, 6, 2, kv_cache_8bit=kv_cache_8bit)
    for run in (lambda *r: evaluate_fn(gpu, *r, 6, 2,
                                       kv_cache_8bit=kv_cache_8bit),
                graphed, graphed):
        got, n = _counted(run, req)
        assert torch.equal(got.output_ids.cpu(), ref.output_ids)
        for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
            torch.testing.assert_close(getattr(got, key).cpu(),
                                       getattr(ref, key), rtol=1e-4, atol=1e-4)
        assert n["decode_attn"] == n["decode_attn/alibi"] == 5 * 2


@pytest.mark.parametrize("kind,b,hw,nh,d", [("window", 8, (14, 14), 4, 80),
                                            ("global", 1, (32, 32), 4, 80)])
def test_sam_custom_ops_eager_and_in_a_cuda_graph(dev, kind, b, hw, nh, d):
    """`haff::sam_{window,global}_relpos_attn` called directly on CUDA
    tensors against the plain version (forward), one launch counted a
    call; the autograd entry's gradients through the op against autograd
    through the plain version; and the op replayed from a CUDA graph gives
    the eager output bit for bit, its launches counted at capture only."""
    g = torch.Generator(dev).manual_seed(b * hw[0])
    L = hw[0] * hw[1]
    qkv = torch.randn((b, L, 3 * nh * d), generator=g, device=dev,
                      dtype=torch.bfloat16)
    rel = [0.5 * torch.randn((2 * s - 1, d), generator=g, device=dev)
           for s in hw]
    q, k, v = (sa.head_view(qkv, 3, i, nh) for i in range(3))
    op = sa.WINDOW_OP if kind == "window" else sa.GLOBAL_OP
    counter = sa.WINDOW_FUSED if kind == "window" else sa.GLOBAL_FUSED
    scale = d ** -0.5
    before = _build.LAUNCHES[counter]
    out = op(q, k, v, *rel, hw, scale, counter)
    assert _build.LAUNCHES[counter] == before + 1
    _close(out, sa.relpos_attention_plain(q.float(), k.float(), v.float(),
                                          *rel, hw, scale))

    entry = (sa.sam_window_attention_qkv if kind == "window"
             else sa.sam_global_attention_qkv)
    x = qkv.float().requires_grad_(True)
    ref = sa.global_attention_plain(x, *rel, hw, nh, scale)
    dy = torch.randn(ref.shape, generator=g, device=dev)
    (want,) = torch.autograd.grad(ref, x, dy)
    xf = qkv.float().requires_grad_(True)
    (got,) = torch.autograd.grad(entry(xf, *rel, hw, nh), xf, dy)
    _close(got, want)

    static = qkv.clone()
    sq, sk, sv = (sa.head_view(static, 3, i, nh) for i in range(3))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        op(sq, sk, sv, *rel, hw, scale, counter)   # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(sq, sk, sv, *rel, hw, scale, counter)
    counted = _build.LAUNCHES[counter]
    graph.replay()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == counted
    assert torch.equal(captured, out)
