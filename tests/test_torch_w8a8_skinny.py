"""The streamed skinny W8A8 path of the port (csrc/w8a8_matmul.cu's
`w8a8_stream_kernel`, chosen by haff_tpu_torch/nn/quant.py `w8a8_path`),
checked on the CPU before the card sees it:

* every LLaMA-7B decode product (q/k/v/o 4096 x 4096, gate/up 11008 x
  4096, down 4096 x 11008, lm_head 32004 x 4096) at M = 1..16 takes the
  skinny path, as do narrow and ragged weights; odd K and an unaligned
  base take the scalar kernels;
* the function the kernel computes, the whole int32 sum rescaled once (sx,
  then sw), is bit-equal at float32 between the port's entry point, its
  plain version and haff_tpu's `pallas_int8_matmul` in interpret mode at
  skinny shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.nn import quant as jq
from haff_tpu_torch.nn import quant as tq

# (K, N) of each LLaMA-7B decode product: q/k/v/o, gate/up, down, lm_head.
SEVEN_B_DECODE = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32004)]


@pytest.mark.parametrize("m", range(1, 17))
@pytest.mark.parametrize("k,n", SEVEN_B_DECODE)
def test_seven_b_decode_products_take_the_skinny_path(m, k, n):
    """Meta tensors: the path reads shapes, pointers and strides only."""
    xq, q = (torch.empty(r, k, dtype=torch.int8, device="meta")
             for r in (m, n))
    assert tq.w8a8_path(xq, q) == tq.W8A8_SKINNY


def _operands(m, k, n, offset=0):
    """int8 xq (M, K) starting `offset` bytes into its storage, and an
    aligned int8 weight (N, K)."""
    buf = torch.zeros(m * k + offset + 16, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16
    xq = buf[base + offset:base + offset + m * k].view(m, k)
    return xq, torch.zeros(n, k, dtype=torch.int8)


@pytest.mark.parametrize("m,k,offset,path", [
    (2, 4096, 0, tq.W8A8_SKINNY),
    (16, 4096, 0, tq.W8A8_SKINNY),
    (2, 4112, 0, tq.W8A8_SKINNY),   # K % 16 == 0, not a multiple of 512
    (2, 4100, 0, tq.W8A8_SCALAR),   # odd K: the first skinny kernel
    (16, 37, 0, tq.W8A8_SCALAR),
    (2, 4096, 1, tq.W8A8_SCALAR),   # a base 1 byte off 16
    (2, 4096, 8, tq.W8A8_SCALAR),
    (2, 4096, 32, tq.W8A8_SKINNY),
], ids=["m2", "m16", "k4112", "k4100", "k37", "base+1", "base+8",
        "base+32"])
def test_skinny_path_needs_what_16_byte_copies_read(m, k, offset, path):
    xq, q = _operands(m, k, 7, offset)
    assert tq.w8a8_path(xq, q) == path


def test_row_blocks_and_strided_operands():
    """An output-column split of a weight (rows 3.. of (50, 64)) starts 192
    bytes in: still aligned. A weight 8 bytes off 16 and a strided view of
    the activations take the scalar kernels."""
    xq, q = _operands(2, 64, 50)
    assert tq.w8a8_path(xq, q[3:]) == tq.W8A8_SKINNY
    buf = torch.zeros(50 * 64 + 32, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16 + 8
    assert tq.w8a8_path(xq, buf[base:base + 50 * 64].view(50, 64)) == \
        tq.W8A8_SCALAR
    wide = torch.zeros(2, 128, dtype=torch.int8)
    assert tq.w8a8_path(wide[:, :64], q) == tq.W8A8_SCALAR


@pytest.mark.parametrize("n,k", [(1, 64), (7, 4096), (64, 4096), (33, 2080),
                                 (1000, 1040), (256, 11008), (2048, 4096),
                                 (4224, 4096), (4096, 4096), (5, 16)])
def test_narrow_and_ragged_weights_take_the_skinny_path(n, k):
    """The path reads K and the operands' layout, never N: a weight of
    any width, ragged against the kernel's 16 columns a block, streams."""
    for m in (1, 2, 16):
        xq, q = (torch.empty(r, k, dtype=torch.int8, device="meta")
                 for r in (m, n))
        assert tq.w8a8_path(xq, q) == tq.W8A8_SKINNY


def _pallas(xq, q, sx, s):
    return np.asarray(jq.pallas_int8_matmul(
        jnp.asarray(xq.numpy()), jnp.asarray(q.numpy().T),
        jnp.asarray(sx.numpy()), jnp.asarray(s.numpy()), dtype=jnp.float32,
        interpret=True))


@pytest.mark.parametrize("m,k,n", [
    (2, 4096, 64),
    (16, 2080, 33),     # K not a multiple of the kernel's 512-byte stage
    (5, 1040, 200),
    (1, 4096, 7),
    (3, 1536, 40),
], ids=["m2-k4096", "m16-k2080", "m5-k1040", "m1-k4096", "m3-k1536"])
def test_skinny_shapes_are_bit_equal_to_plain_and_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :5] = 40.0  # a large activation: a wide int32 sum
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    q, s = tq.quantize_kernel(torch.from_numpy(w))
    xq, sx = tq.quantize_activation(torch.from_numpy(x))
    assert tq.w8a8_path(xq, q) == tq.W8A8_SKINNY
    got = tq.int8_matmul_plain(xq, q, sx[:, 0], s, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), _pallas(xq, q, sx, s))
    # The entry point on the CPU takes the plain version: the same numbers.
    assert torch.equal(tq.int8_matmul(torch.from_numpy(x), q, s), got)
