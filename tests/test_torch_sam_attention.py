"""The plain versions of the two SAM attention kernels of the port
(haff_tpu_torch/kernels/sam_attention.py) against the JAX Pallas kernels
they replace, run in interpret mode at geometries that really reach them:

* `sam_window_attention_qkv_split` -> `_window_qkv_kernel_db_iband`
  (nh 16, d 16, a 6 x 6 window: 36 rows tile-padded to 40 on the JAX side);
* `sam_global_attention_qkv` -> `_global_qkv_kernel` (hw 32 x 32, nh 2,
  d 128).

Inputs are float32 on both sides; the tolerance (2e-5 abs + rel) covers
float32 summation-order differences over <= 1024-term softmax sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.kernels import sam_attention as jsa
from haff_tpu.nn.sam_image_encoder import decomposed_rel_pos_bias as j_bias
from haff_tpu.nn.sam_image_encoder import get_rel_pos as j_get_rel_pos
from haff_tpu_torch.kernels import sam_attention as tsa

TOL = dict(rtol=2e-5, atol=2e-5)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(jsa, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(jsa, name, spy)
    return calls


@pytest.mark.parametrize("nwin", [3, 5])
def test_window_plain_matches_iband_kernel(monkeypatch, nwin):
    nh, d, w = 16, 16, 6
    c, lcont, lpad = nh * d, w * w, 40
    # The JAX guard (sam_attention.py:910) that selects the in-kernel-band
    # kernel, evaluated for this geometry.
    kp = 16
    while kp < w or (nh * kp) % 128:
        kp += 16
    hh = nh // 2
    assert jsa._ikband_enabled() and nh % 2 == 0 and (hh * d) % 128 == 0 \
        and (hh * kp) % 128 == 0 and kp >= w
    rng = np.random.default_rng(nwin)
    q3 = rng.standard_normal((nwin, lpad, c)).astype(np.float32)
    kv3 = rng.standard_normal((nwin, lpad, 2 * c)).astype(np.float32)
    rel_h = (0.5 * rng.standard_normal((2 * w - 1, d))).astype(np.float32)
    rel_w = (0.5 * rng.standard_normal((2 * w - 1, d))).astype(np.float32)
    calls = _spy(monkeypatch, "_window_qkv_band_fwd")
    ref = jsa.sam_window_attention_qkv_split(
        jnp.asarray(q3), jnp.asarray(kv3), jnp.asarray(rel_h),
        jnp.asarray(rel_w), (w, w), nh, interpret=True)
    assert calls, "the JAX call did not reach the iband kernel"
    got = tsa.sam_window_attention_qkv_split(
        torch.from_numpy(q3[:, :lcont].copy()),
        torch.from_numpy(kv3[:, :lcont].copy()), torch.from_numpy(rel_h),
        torch.from_numpy(rel_w), (w, w), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :lcont], **TOL)


def test_global_plain_matches_global_qkv_kernel(monkeypatch):
    H = W = 32
    nh, d = 2, 128
    c = nh * d
    kp = jsa._global_kp((H, W), nh)
    hh = nh // 2
    # The JAX alignment guard (sam_attention.py:1365-1367).
    assert nh % 2 == 0 and (hh * d) % 128 == 0 and (hh * 2 * kp) % 128 == 0 \
        and H * W >= 1024 and W % 8 == 0
    rng = np.random.default_rng(1)
    qkv = (0.5 * rng.standard_normal((1, H * W, 3 * c))).astype(np.float32)
    rel_h = (0.3 * rng.standard_normal((2 * H - 1, d))).astype(np.float32)
    rel_w = (0.3 * rng.standard_normal((2 * W - 1, d))).astype(np.float32)
    calls = _spy(monkeypatch, "_global_qkv_fwd")
    ref = jsa.sam_global_attention_qkv(
        jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w), (H, W), nh,
        interpret=True)
    assert calls, "the JAX call did not reach the global qkv kernel"
    got = tsa.sam_global_attention_qkv(
        torch.from_numpy(qkv), torch.from_numpy(rel_h),
        torch.from_numpy(rel_w), (H, W), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_band_tables_of_global_kernel():
    """The wrapper's band tables (kernel b's bias operand) equal the
    decomposed bias: bias[i, j] = Bh[i, row(j)] + Bw[i, col(j)]."""
    H, W, nh, d = 4, 6, 2, 8
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, H * W, nh, d, generator=g)
    rh = torch.randn(2 * H - 1, d, generator=g)
    rw = torch.randn(2 * W - 1, d, generator=g)
    bh, bw = tsa.band_tables(q, rh, rw, (H, W))
    j = torch.arange(H * W)
    expect = bh[..., j // W] + bw[..., j % W]             # (B, L, nh, L)
    got = tsa.decomposed_rel_pos_bias(q, rh, rw, (H, W), (H, W))
    torch.testing.assert_close(expect.permute(0, 2, 1, 3), got,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [4, 14])
def test_rel_pos_and_bias_match_jax(size):
    rng = np.random.default_rng(size)
    d, nh = 8, 2
    rel = rng.standard_normal((2 * size - 1, d)).astype(np.float32)
    np.testing.assert_array_equal(
        tsa.get_rel_pos(size, size, torch.from_numpy(rel)).numpy(),
        np.asarray(j_get_rel_pos(size, size, jnp.asarray(rel))))
    q = rng.standard_normal((1, size * size, nh, d)).astype(np.float32)
    ref = j_bias(jnp.asarray(q), jnp.asarray(rel), jnp.asarray(rel),
                 (size, size), (size, size))
    got = tsa.decomposed_rel_pos_bias(torch.from_numpy(q),
                                      torch.from_numpy(rel),
                                      torch.from_numpy(rel),
                                      (size, size), (size, size))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_version():
    before = dict(tsa._build.LAUNCHES)
    q3 = torch.zeros(1, 16, 8)
    kv3 = torch.zeros(1, 16, 16)
    out = tsa.sam_window_attention_qkv_split(
        q3, kv3, torch.zeros(7, 4), torch.zeros(7, 4), (4, 4), 2)
    assert out.shape == (1, 16, 8)
    assert dict(tsa._build.LAUNCHES) == before


@pytest.mark.parametrize("wrapper", ["window", "global"])
def test_kernel_wrappers_refuse_to_drop_a_gradient(wrapper):
    """Neither entry drops a gradient: with an input that requires grad
    the output carries a grad_fn (`RelPosAttentionFn`) and the gradient
    arrives at q, k and v; the rel-pos tables get a true gradient from the
    window entry and exact zeros from the global one at a grid where the
    JAX fused path runs."""
    nh, d, w = 2, 8, 16
    g = torch.Generator().manual_seed(0)
    rel_h = torch.randn(2 * w - 1, d, generator=g, requires_grad=True)
    rel_w = torch.randn(2 * w - 1, d, generator=g, requires_grad=True)
    qkv = torch.randn(1, w * w, 3 * nh * d, generator=g, requires_grad=True)
    if wrapper == "window":
        c = nh * d
        out = tsa.sam_window_attention_qkv_split(
            qkv[..., :c].contiguous(), qkv[..., c:].contiguous(), rel_h,
            rel_w, (w, w), nh)
    else:
        out = tsa.sam_global_attention_qkv(qkv, rel_h, rel_w, (w, w), nh)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert qkv.grad is not None and all(
        qkv.grad[..., i * nh * d:(i + 1) * nh * d].abs().max() > 0
        for i in range(3))
    if wrapper == "window":
        assert rel_h.grad.abs().max() > 0 and rel_w.grad.abs().max() > 0
    else:
        assert not rel_h.grad.any() and not rel_w.grad.any()


def _views(dtype, d=16, nh=2, l=16):
    """Fused, split and per-head (B, L, nh, d) views of one storage."""
    qkv = torch.zeros(2, l, 3 * nh * d, dtype=dtype)
    fused = [tsa.head_view(qkv, 3, i, nh) for i in range(3)]
    c = nh * d
    q3, kv3 = qkv[..., :c], qkv[..., c:]
    split = [tsa.head_view(q3, 1, 0, nh), tsa.head_view(kv3, 2, 0, nh),
             tsa.head_view(kv3, 2, 1, nh)]
    return qkv, {"fused": fused, "split": split,
                 "heads": [t.contiguous() for t in fused]}


@pytest.mark.parametrize("layout", ["fused", "split", "heads"])
def test_tensor_core_path_takes_every_aligned_bf16_layout(layout):
    """`_tensor_core_ok` is a pure function of dtype, d, pointers and
    strides: fused, split and per-head views of one bf16 storage all
    qualify (bases 16-byte aligned, strides multiples of 8)."""
    _, views = _views(torch.bfloat16)
    assert tsa._tensor_core_ok(*views[layout])


@pytest.mark.parametrize("case", ["float32", "d=12", "mixed dtype",
                                  "misaligned base", "odd row stride",
                                  "odd batch stride"])
def test_tensor_core_path_refuses_what_16_byte_copies_cannot_read(case):
    if case == "float32":
        _, views = _views(torch.float32)
        q, k, v = views["fused"]
    elif case == "d=12":
        _, views = _views(torch.bfloat16, d=12)
        q, k, v = views["heads"]
    elif case == "mixed dtype":
        _, views = _views(torch.bfloat16)
        q, k, v = views["heads"]
        v = v.float()
    elif case == "misaligned base":
        # The same layout one element further on: base 2 bytes off.
        buf = torch.zeros(2 * 16 * 3 * 32 + 1, dtype=torch.bfloat16)
        qkv = buf[1:].view(2, 16, 96)
        q, k, v = (tsa.head_view(qkv, 3, i, 2) for i in range(3))
        assert q.data_ptr() % 16 == 2
    elif case == "odd row stride":
        qkv = torch.zeros(2, 16, 3 * 32 + 4, dtype=torch.bfloat16)[..., :96]
        q, k, v = (tsa.head_view(qkv, 3, i, 2) for i in range(3))
        assert q.stride(1) == 100
    else:
        qkv = torch.zeros(2 * 16 * 96 + 4, dtype=torch.bfloat16)
        qkv = qkv.as_strided((2, 16, 96), (16 * 96 + 4, 96, 1))
        q, k, v = (tsa.head_view(qkv, 3, i, 2) for i in range(3))
    assert not tsa._tensor_core_ok(q, k, v)


def test_tensor_core_path_reads_d_24_and_the_scalar_count_key():
    """d = 24 (a multiple of 8, not of 16) qualifies: the kernel pads the
    head to 32 columns of zeros. The scalar key is the entry's key with
    `/scalar`, bumped only by bf16 launches off the tensor cores."""
    _, views = _views(torch.bfloat16, d=24)
    assert tsa._tensor_core_ok(*views["split"])
    before = dict(tsa._build.LAUNCHES)
    q = views["heads"][0]
    tsa._build.count("k", q, tsa.MMA_SYNC)
    tsa._build.count("k", q, tsa.WGMMA)
    tsa._build.count("k", q.float(), tsa.SCALAR)
    tsa._build.count("k", q, tsa.SCALAR)
    got = {k: v - before.get(k, 0) for k, v in tsa._build.LAUNCHES.items()
           if v != before.get(k, 0)}
    assert got == {"k": 4, "k/scalar": 1}
    for key in ("k", "k/scalar"):
        tsa._build.LAUNCHES[key] = before.get(key, 0)


@pytest.mark.parametrize("kind,hw,nh,d,dtype,want", [
    ("global", (64, 64), 16, 80, torch.bfloat16, "wgmma"),     # ViT-H
    ("global", (64, 64), 12, 64, torch.bfloat16, "wgmma"),     # ViT-B / L
    ("global", (32, 32), 8, 32, torch.bfloat16, "wgmma"),      # small
    ("global", (12, 64), 2, 80, torch.bfloat16, "wgmma"),      # any H
    ("global", (64, 32), 2, 80, torch.bfloat16, "wgmma"),      # W != 64
    ("window", (14, 14), 16, 80, torch.bfloat16, "mma.sync"),
    ("window", (8, 8), 8, 32, torch.bfloat16, "mma.sync"),
    ("global", (64, 64), 16, 80, torch.float32, "scalar"),
    ("window", (14, 14), 16, 80, torch.float32, "scalar")])
def test_kernel_path_by_kind_grid_and_head_dim(kind, hw, nh, d, dtype, want):
    """On the tensor cores the global kernel runs warpgroup MMA at every
    grid and the window kernel mma.sync; float32 runs the scalar code."""
    l = hw[0] * hw[1]
    qkv = torch.zeros(1, l, 3 * nh * d, dtype=dtype)
    q, k, v = (tsa.head_view(qkv, 3, i, nh) for i in range(3))
    assert tsa.PATH_NAMES[tsa.kernel_path(kind, q, k, v)] == want
