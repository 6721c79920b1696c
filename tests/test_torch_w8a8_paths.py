"""The W8A8 product's paths (haff_tpu_torch/nn/quant.py `w8a8_path`,
csrc/w8a8_matmul.cu), checked on the CPU before the card sees them:

* the pure path function: with K % 16 == 0 (TMA's stride rule) and
  16-byte aligned row-major operands, M <= 16 takes the streamed skinny
  kernel and M > 16 the int8 tensor cores; the rest (odd K, a base off 16
  bytes, a strided view) the dp4a scalar kernels. Every product of the
  7b preset's W8A8 evaluate is on the skinny path or the tensor cores;
* `int8_matmul` at the tensor-core tile's ragged geometry (M = 130 and
  N = 200 are not multiples of its 128 x 128 tile) and at a K the tile
  kernel takes, bit for bit at float32 against haff_tpu's
  `pallas_int8_matmul` in interpret mode on the same quantized operands
  (the int32 sum is exact and both scale it by sx then sw).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.nn import quant as jq
from haff_tpu_torch.nn import quant as tq


def _operands(m, k, n, offset=0):
    """int8 xq (M, K) starting `offset` bytes into its storage, and an
    aligned int8 weight (N, K)."""
    buf = torch.zeros(m * k + offset + 16, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16  # the storage's first 16-byte boundary
    xq = buf[base + offset:base + offset + m * k].view(m, k)
    return xq, torch.zeros(n, k, dtype=torch.int8)


# (M, K, N) of every W8A8 product of the 7b evaluate: LLaMA-7B's seven
# projections and lm_head at prefill (2 x 575 tokens) and decode (2), SAM
# ViT-H's qkv, proj and MLP over 14 x 14 windows (25 x 196 x 2 = 9800
# rows) and the 64 x 64 global grid (8192 rows).
SEVEN_B = [(1150, 4096, 4096), (1150, 4096, 11008), (1150, 11008, 4096),
           (1150, 4096, 32004), (2, 4096, 4096), (2, 11008, 4096),
           (2, 4096, 32004), (9800, 1280, 3840), (9800, 1280, 1280),
           (9800, 1280, 5120), (9800, 5120, 1280), (8192, 1280, 3840),
           (8192, 5120, 1280)]


@pytest.mark.parametrize("m,k,n", SEVEN_B)
def test_seven_b_products_take_the_tensor_cores(m, k, n):
    """Contiguous operands of the 7b shapes (meta tensors: the path reads
    shapes, pointers and strides only)."""
    xq, q = (torch.empty(r, k, dtype=torch.int8, device="meta")
             for r in (m, n))
    want = tq.W8A8_SKINNY if m <= 16 else tq.W8A8_WGMMA
    assert tq.w8a8_path(xq, q) == want


@pytest.mark.parametrize("m,k,offset,path", [
    (16, 4096, 0, tq.W8A8_SKINNY),   # the largest skinny M
    (17, 4096, 0, tq.W8A8_WGMMA),    # the smallest tensor-core M
    (17, 40, 0, tq.W8A8_SCALAR),     # K % 16 != 0 (tiny preset widths)
    (300, 52, 0, tq.W8A8_SCALAR),
    (16, 37, 0, tq.W8A8_SCALAR),     # odd K: the first skinny kernel
    (130, 256, 1, tq.W8A8_SCALAR),   # a base 1 byte off 16
    (130, 256, 16, tq.W8A8_WGMMA),
], ids=["m16", "m17", "k40", "k52", "m16-k37", "misaligned-base",
        "aligned-offset"])
def test_w8a8_path(m, k, offset, path):
    xq, q = _operands(m, k, 7, offset)
    assert tq.w8a8_path(xq, q) == path
    assert tq.W8A8_PATH_NAMES[path] in ("scalar", "wgmma", "skinny")


def test_an_unaligned_row_block_takes_the_tile_kernel():
    """An output-column split of a weight (rows 3.. of (50, K)) whose first
    row is not 16-byte aligned, and a strided view of the activations."""
    xq, q = _operands(20, 40, 50)
    assert tq.w8a8_path(xq, q[3:]) == tq.W8A8_SCALAR
    xq, q = _operands(20, 64, 50)
    assert tq.w8a8_path(xq, q[3:]) == tq.W8A8_WGMMA  # 3 x 64 bytes in
    wide = torch.zeros(20, 128, dtype=torch.int8)
    assert tq.w8a8_path(wide[:, :64], q) == tq.W8A8_SCALAR


@pytest.mark.parametrize("m,k,n", [(130, 256, 200), (130, 48, 200),
                                   (17, 4096, 33)])
def test_int8_matmul_equals_pallas_bit_for_bit(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[5] = 0.0  # an all-zero token: activation scale 1
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    q, s = tq.quantize_kernel(torch.from_numpy(w))
    got = tq.int8_matmul(torch.from_numpy(x), q, s)
    xq, sx = tq.quantize_activation(torch.from_numpy(x))
    ref = jq.pallas_int8_matmul(jnp.asarray(xq.numpy()),
                                jnp.asarray(q.numpy().T),
                                jnp.asarray(sx.numpy()), jnp.asarray(s.numpy()),
                                dtype=jnp.float32, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, tq.int8_matmul_plain(xq, q, sx[:, 0], s,
                                                 torch.float32))
