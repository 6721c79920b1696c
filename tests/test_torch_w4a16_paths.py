"""The W4A16 product's paths (haff_tpu_torch/nn/quant.py `w4a16_path`,
csrc/w4a16_matmul.cu), checked on the CPU before the card sees them:

* the pure path function: bf16 activations, 1 <= M <= SMALL_M, group %
  16 == 0, K % 32 == 0, 16-byte aligned row-major operands and a scale row
  of a multiple of 16 bytes, at most 4 KB, take the tensor-core kernel;
  the rest (float32, odd K, a base off 16 bytes, a strided view, M >
  SMALL_M) the scalar kernel. Every 4-bit product of LLaMA-7B at decode and at M = 256 is on
  the tensor cores;
* the mma kernel's dequantization, emulated in numpy bit by bit (xor,
  the nibble or-ed into 0x4B000000, the subtraction of 2^23 + 8, the
  float32 multiply, round to nearest even bf16): bit-equal to
  `dequantize_kernel_int4` for all 16 nibbles at scales from subnormal to
  huge;
* the mma kernel's K-permuted fragments, built lane by lane as the kernel
  builds them (16-byte words of two weight rows a lane, the matching 16
  bytes of an activation row, 512-K stages, 4 warps of 128-K super-spans,
  two chains of products a warp, tiles added in warp order) and
  multiplied as m16n8k16 products: equal to `int4_matmul_plain` and to
  haff_tpu's `pallas_int4_matmul` in interpret mode, at shapes whose last
  stage and last super-span are partial.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.nn import quant as jq
from haff_tpu_torch.nn import quant as tq

F32 = dict(rtol=1e-5, atol=1e-5)  # test_torch_quant.py's float32 tolerance
BF16 = dict(rtol=2e-2, atol=2e-2)

# (K, N) of LLaMA-7B's 4-bit products: q/k/v/o, gate/up, down, lm_head.
SEVEN_B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32004)]


def _meta(m, k, n, group, dtype=torch.bfloat16):
    """Contiguous operands on the meta device (the path reads dtype,
    shapes, pointers and strides only)."""
    return (torch.empty(m, k, dtype=dtype, device="meta"),
            torch.empty(n, k // 2, dtype=torch.uint8, device="meta"),
            torch.empty(n, k // group, dtype=torch.float32, device="meta"))


@pytest.mark.parametrize("m", list(range(1, 17)) + [256])
@pytest.mark.parametrize("k,n", SEVEN_B)
def test_seven_b_products_take_the_tensor_cores(m, k, n):
    assert tq.w4a16_path(*_meta(m, k, n, 64), 64) == tq.W4A16_MMA
    assert tq.W4A16_PATH_NAMES[tq.W4A16_MMA] == "mma"


def _aligned(shape, dtype, offset=0):
    """A CPU tensor whose storage starts `offset` elements past a 16-byte
    boundary."""
    numel = int(np.prod(shape))
    buf = torch.zeros(numel + offset + 16, dtype=dtype)
    base = (-buf.data_ptr()) % 16 // buf.element_size()
    return buf[base + offset:base + offset + numel].view(shape)


@pytest.mark.parametrize("m,k,group,dtype,what", [
    (2, 4096, 64, torch.float32, "float32 activations"),
    (2, 48, 16, torch.bfloat16, "K % 32 != 0"),
    (2, 2080, 32, torch.bfloat16, "a scale row of 260 bytes"),
    (257, 4096, 64, torch.bfloat16, "M > SMALL_M"),
    (2, 96, 48, torch.bfloat16, "2 groups a row"),
    (2, 32768, 16, torch.bfloat16, "2048 groups a row"),
])
def test_scalar_cases(m, k, group, dtype, what):
    x, p, s = _meta(m, k, 8, group, dtype)
    assert tq.w4a16_path(x, p, s, group) == tq.W4A16_SCALAR, what


def test_unaligned_and_strided_operands_take_the_scalar_kernel():
    k, group = 256, 64
    x = _aligned((2, k), torch.bfloat16)
    p = _aligned((40, k // 2), torch.uint8)
    s = _aligned((40, k // group), torch.float32)
    assert tq.w4a16_path(x, p, s, group) == tq.W4A16_MMA
    assert tq.w4a16_path(x, p[16:], s[16:], group) == tq.W4A16_MMA
    # Row 3 of the weight: 384 bytes in, 16-aligned; its scales are 48
    # bytes in, aligned too; row 1 of the scale is 16 bytes in.
    assert tq.w4a16_path(x, p[3:], s[3:], group) == tq.W4A16_MMA
    assert tq.w4a16_path(_aligned((2, k), torch.bfloat16, 1), p, s,
                         group) == tq.W4A16_SCALAR
    assert tq.w4a16_path(x, _aligned((40, k // 2), torch.uint8, 8), s,
                         group) == tq.W4A16_SCALAR
    assert tq.w4a16_path(x, p, _aligned((40, k // group), torch.float32, 2),
                         group) == tq.W4A16_SCALAR
    wide = _aligned((2, 2 * k), torch.bfloat16)
    assert tq.w4a16_path(wide[:, :k], p, s, group) == tq.W4A16_SCALAR
    wide_p = _aligned((40, k), torch.uint8)
    assert tq.w4a16_path(x, wide_p[:, :k // 2], s, group) == tq.W4A16_SCALAR


# ----- the mma kernel's arithmetic, emulated -----

def _bf16_rne(a):
    """float32 values rounded to bf16 (round to nearest even), as float32:
    what cvt.rn.bf16x2.f32 computes, in integer arithmetic."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _dequant_words(words, sc, rnd):
    """The kernel's dequant8 on uint32 words (any shape) with float32
    scales of the same shape: (..., 8) values, element i is k 8w + i."""
    words = np.asarray(words, np.uint32)
    lo = (words & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    hi = ((words >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    out = np.empty(words.shape + (8,), np.float32)
    with np.errstate(over="ignore"):
        for b in range(4):
            for i, plane in ((2 * b, lo), (2 * b + 1, hi)):
                byte = (plane >> np.uint32(8 * b)) & np.uint32(0xFF)
                f = ((np.uint32(0x4B000000) | byte).view(np.float32)
                     - np.float32(8388616.0))
                out[..., i] = rnd(f * np.asarray(sc, np.float32))
    return out


def _words(packed):
    """(N, K/2) uint8 -> (N, K/8) little-endian uint32 words."""
    return np.ascontiguousarray(packed).view("<u4")


def test_the_bit_trick_matches_dequantize_bit_for_bit():
    """All 16 nibbles in every position of a word against scales of 1.0,
    the smallest normal and two subnormal float32 values, large values
    (products overflow to inf), and seeded random scales."""
    rng = np.random.default_rng(0)
    group = 16
    special = np.array([1.0, 2.0 ** -126, 2.0 ** -140, 1.4e-45, 3.0e38, 1e38,
                        -5e37, 65504.0, 0.0, 1.0 / 7.0], np.float32)
    scales = np.concatenate(
        [special, (rng.standard_normal(54) * 10.0 ** rng.integers(
            -30, 30, 54)).astype(np.float32)])
    n = scales.size
    # Row r, group j: the 16 nibbles rotated by r + j, so each nibble meets
    # each position.
    nib = (np.arange(16)[None, None, :] + np.arange(n)[:, None, None]
           + np.arange(4)[None, :, None]) % 16
    nib = nib.reshape(n, 64)
    packed = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8)
    scale = np.repeat(scales[:, None], 4, axis=1).astype(np.float32)
    scale[:, 1::2] *= np.float32(-1.0)
    words = _words(packed)
    sc = scale[:, (8 * np.arange(words.shape[1])) // group]
    got = _dequant_words(words, sc, _bf16_rne).reshape(n, 64)
    want = tq.dequantize_kernel_int4(torch.from_numpy(packed),
                                     torch.from_numpy(scale), group,
                                     torch.bfloat16)
    got_bits = torch.from_numpy(got).bfloat16().view(torch.int16)
    assert torch.equal(got_bits, want.view(torch.int16))
    # And in float32 (no rounding) the trick gives nibble * scale exactly.
    f32 = tq.dequantize_kernel_int4(torch.from_numpy(packed),
                                    torch.from_numpy(scale), group,
                                    torch.float32)
    exact = _dequant_words(words, sc, lambda v: v).reshape(n, 64)
    assert np.array_equal(exact.view(np.uint32), f32.numpy().view(np.uint32))


KC, COLS, SPAN = 512, 16, 128  # the kernel's stage, block and super-span


def _mma_rows(m):
    """Activation rows a block holds (the launcher's choice)."""
    return next(r for r in (1, 2, 4, 8, 16) if m <= r or r == 16)


def _emulate(x, packed, scale, group, rnd):
    """The mma kernel's sums before the output rounding, (M, N) float32:
    x (M, K) float32 values (already in the compute type), the weight
    dequantized and rounded by `rnd`."""
    m_all, k_all = x.shape
    n_all, ng = packed.shape[0], scale.shape[1]
    words = _words(packed)
    mr = _mma_rows(m_all)
    nt = (mr + 7) // 8
    out = np.zeros((m_all, n_all), np.float32)
    for n0 in range(0, n_all, COLS):
        for m0 in range(0, m_all, mr):
            red = np.zeros((4, 2, nt, COLS, 8), np.float32)  # two chains
            for kc in range(0, k_all, KC):
                for warp in range(4):
                    if kc + SPAN * warp >= k_all:
                        continue
                    a = np.zeros((8, 16, 16), np.float32)   # (k16 step, A)
                    b = np.zeros((nt, 8, 16, 8), np.float32)
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        kl = kc + SPAN * warp + 32 * t
                        for row in (g, g + 8):
                            n = n0 + row
                            for q in range(4):
                                k = kl + 8 * q
                                ok = n < n_all and k < k_all
                                w = words[n, k // 8] if ok else 0
                                sc = (scale[n, min(kl + 16 * (q // 2),
                                                   k_all - 16) // group]
                                      if n < n_all else 0.0)
                                v = _dequant_words(w, sc, rnd)
                                for s in range(2):  # a0/a1, then a2/a3
                                    a[2 * q + s, row, 2 * t:2 * t + 2] = \
                                        v[4 * s:4 * s + 2]
                                    a[2 * q + s, row, 2 * t + 8:2 * t + 10] = \
                                        v[4 * s + 2:4 * s + 4]
                        for j in range(nt):
                            r = 8 * j + g
                            for q in range(4):
                                k = kl + 8 * q
                                xs = (x[m0 + r, k:k + 8] if r < mr
                                      and m0 + r < m_all and k < k_all
                                      else np.zeros(8, np.float32))
                                for s in range(2):  # b0, b1
                                    b[j, 2 * q + s, 2 * t:2 * t + 2, g] = \
                                        xs[4 * s:4 * s + 2]
                                    b[j, 2 * q + s, 2 * t + 8:2 * t + 10,
                                      g] = xs[4 * s + 2:4 * s + 4]
                    for step in range(8):  # word q = step // 2, chain q % 2
                        for j in range(nt):
                            red[warp, step // 2 % 2, j] += a[step] @ b[j, step]
            tiles = red[:, 0] + red[:, 1]
            c = ((tiles[0] + tiles[1]) + tiles[2]) + tiles[3]
            cols = min(COLS, n_all - n0)
            for j in range(nt):
                rows = min(8, mr - 8 * j, m_all - m0 - 8 * j)
                if rows > 0:
                    out[m0 + 8 * j:m0 + 8 * j + rows, n0:n0 + cols] = \
                        c[j].T[:rows, :cols]
    return out


@pytest.mark.parametrize("m,k,n,group", [
    (3, 1152, 20, 48),   # last stage 128 K: warps 1-3 idle there
    (20, 576, 24, 16),   # last super-span half past K; two M tiles of 16
])
def test_fragment_product_matches_plain_and_pallas(m, k, n, group):
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    p_t, s_t = tq.quantize_kernel_int4(torch.from_numpy(w.T.copy()), group)
    packed, scale = p_t.numpy(), s_t.numpy()
    xt = torch.from_numpy(x)
    x_bf = xt.bfloat16()
    assert tq.w4a16_path(x_bf, p_t, s_t, group) == tq.W4A16_MMA

    # bf16, as the card runs it: the sums against the float32 product of
    # the same rounded values, the rounded outputs against the plain version.
    got = _emulate(x_bf.float().numpy(), packed, scale, group, _bf16_rne)
    wd = tq.dequantize_kernel_int4(p_t, s_t, group, torch.bfloat16).float()
    np.testing.assert_allclose(got, (x_bf.float() @ wd.T).numpy(), **F32)
    plain = tq.int4_matmul_plain(x_bf, p_t, s_t, group, torch.bfloat16)
    ulp = torch.from_numpy(got).bfloat16().float() - plain.float()
    assert (ulp.abs() <= 1e-3 + 2.0 ** -7 * plain.float().abs()).all()

    # The same fragments without the bf16 rounding against haff_tpu's
    # Pallas kernel at float32 (interpret mode), and at bf16.
    pj, sj = jq.quantize_kernel_int4(jnp.asarray(w), group)
    assert np.array_equal(np.asarray(pj).T, packed)
    ref32 = jq.pallas_int4_matmul(jnp.asarray(x), pj, sj, group=group,
                                  dtype=jnp.float32, interpret=True)
    got32 = _emulate(x, packed, scale, group, lambda v: v)
    np.testing.assert_allclose(got32, np.asarray(ref32), **F32)
    np.testing.assert_allclose(
        got32, tq.int4_matmul_plain(xt, p_t, s_t, group, torch.float32),
        **F32)
    ref16 = jq.pallas_int4_matmul(jnp.asarray(x).astype(jnp.bfloat16), pj, sj,
                                  group=group, dtype=jnp.bfloat16,
                                  interpret=True)
    np.testing.assert_allclose(
        torch.from_numpy(got).bfloat16().float().numpy(),
        np.asarray(ref16, np.float32), **BF16)
