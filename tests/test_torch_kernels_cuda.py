"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device; on the chip:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Each kernel runs on bf16 (and float32) inputs and is compared with the
plain version evaluated in float32 on the same input values. The kernel
computes in float32 too, so they differ by the output rounding (half a
bf16 ulp, 2^-8 relative) and summation order: tolerance
|err| <= 1e-3 + 2^-7 |ref| for bf16, 1e-4 + 1e-4 |ref| for float32.
"""

import pytest
import torch

from haff_tpu_torch.kernels import _build
from haff_tpu_torch.kernels import flash_attention as fa
from haff_tpu_torch.kernels import sam_attention as sa

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
    got = sa.sam_window_attention_qkv_split(q3, kv3, rh, rw, (w, w), nh)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sam_window_relpos_attn"] == before + 1
    ref = sa.window_attention_plain(q3.float(), kv3.float(), rh, rw, (w, w),
                                    nh, d ** -0.5)
    _close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,H,W,nh,d", [(1, 64, 64, 16, 80), (2, 8, 8, 2, 16),
                                        (1, 32, 32, 2, 128), (1, 10, 6, 3, 24)])
def test_global_kernel_matches_plain(dev, dtype, b, H, W, nh, d):
    g = torch.Generator(dev).manual_seed(H * W + d)
    c = nh * d
    qkv = torch.randn(b, H * W, 3 * c, generator=g, device=dev).to(dtype)
    rh = 0.2 * torch.randn(2 * H - 1, d, generator=g, device=dev)
    rw = 0.2 * torch.randn(2 * W - 1, d, generator=g, device=dev)
    got = sa.sam_global_attention_qkv(qkv, rh, rw, (H, W), nh)
    ref = sa.global_attention_plain(qkv.float(), rh, rw, (H, W), nh, d ** -0.5)
    _close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,d,causal,bias,seg", [
    (2, 575, 575, 32, 128, True, False, True),
    (2, 5, 5, 4, 16, True, False, True),
    (1, 70, 70, 2, 64, False, True, False),
    (2, 9, 130, 4, 32, True, True, True),
    (1, 130, 9, 2, 16, True, False, False),
])
def test_flash_prefill_matches_plain(dev, dtype, b, lq, lk, h, d, causal,
                                     bias, seg):
    g = torch.Generator(dev).manual_seed(lq * lk)
    q = torch.randn(b, lq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, lk, h, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, lk, h, d, generator=g, device=dev).to(dtype)
    bias_t = (torch.randn(1, h, 1, lk, generator=g, device=dev)
              if bias else None)
    qseg = kseg = None
    if seg:
        qlen = torch.tensor([lq] + [max(lq - 70, 1)] * (b - 1), device=dev)
        klen = torch.tensor([lk] + [max(lk - 70, 1)] * (b - 1), device=dev)
        qseg = (torch.arange(lq, device=dev)[None] < qlen[:, None]).int()
        kseg = (torch.arange(lk, device=dev)[None] < klen[:, None]).int()
    out, lse = fa.flash_attention(q, k, v, bias_t, qseg, kseg, causal,
                                  return_lse=True)
    ref, ref_lse = fa.attention_plain(q.float(), k.float(), v.float(), bias_t,
                                      qseg, kseg, causal)
    _close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-3)


def test_wrappers_refuse_unsupported_operands(dev):
    x = torch.zeros(1, 16, 8, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
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
])
def test_flash_backward_matches_plain(dev, dtype, b, lq, lk, h, d, causal,
                                      bias, seg):
    """dq (flash_bwd_dq) and dk/dv (flash_bwd_dkv) against
    attention_bwd_plain on the float32 values of the same operands; pad
    query rows give exactly-zero dq, pad keys exactly-zero dk/dv."""
    g = torch.Generator(dev).manual_seed(7 * lq + lk)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, do = rnd(b, lq, h, d), rnd(b, lq, h, d)
    k, v = rnd(b, lk, h, d), rnd(b, lk, h, d)
    bias_t = (torch.randn(1, h, 1, lk, generator=g, device=dev)
              if bias else None)
    qseg = kseg = None
    if seg:
        qlen = torch.tensor([lq] + [max(lq - 70, 1)] * (b - 1), device=dev)
        klen = torch.tensor([lk] + [max(lk - 70, 1)] * (b - 1), device=dev)
        qseg = (torch.arange(lq, device=dev)[None] < qlen[:, None]).int()
        kseg = (torch.arange(lk, device=dev)[None] < klen[:, None]).int()
    out, lse = fa.flash_prefill_kernel(q, k, v, bias_t, qseg, kseg, causal)
    args = (q, k, v, bias_t, qseg, kseg, out, lse, do, causal)
    before = dict(_build.LAUNCHES)
    dq = fa.flash_bwd_dq_kernel(*args)
    dk, dv = fa.flash_bwd_dkv_kernel(*args)
    torch.cuda.synchronize()
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
