"""The matmul probe of `haff_tpu_torch.tools.bench_kernels` (the port of
root tools/bench_kernels.py's `mm_kernel`, inside `cmd_int8mxu`), checked
on the CPU before the card sees it:

* `tools/probe_ab.py`, which times the probe against its library call
  from one tree or another: its arguments, its cases and the operands it
  builds;
* `matmul_probe_plain` (the wrapper's route for CPU tensors and the
  card's oracle) against `jax.lax.dot_general(...,
  preferred_element_type=int32 / float32)`, the operation `mm_kernel`'s
  body runs, at ragged shapes: exact for int8;
* the index arithmetic of csrc/matmul_probe.cu's epilogue, emulated lane
  by lane: the wgmma accumulator layout through the swizzled staging area
  back out as whole rows is the identity, and no two lanes of a phase
  meet on a shared-memory bank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu_torch.tools import bench_kernels as bk
from haff_tpu_torch.tools import probe_ab


def test_probe_ab_arguments_and_cases():
    args = probe_ab.parse(["--label", "new", "--iters", "5"])
    assert (args.label, args.iters) == ("new", 5)
    assert (probe_ab.parse([]).label, probe_ab.parse([]).iters) == ("", 20)
    assert probe_ab.CASES == (("2048^3 int8", 2048, 2048, 2048, "int8"),
                              ("2048^3 bfloat16", 2048, 2048, 2048, "bfloat16"),
                              ("4096^3 int8", 4096, 4096, 4096, "int8"),
                              ("4096^3 bfloat16", 4096, 4096, 4096, "bfloat16"),
                              ("8192^3 int8", 8192, 8192, 8192, "int8"),
                              ("8192^3 bfloat16", 8192, 8192, 8192, "bfloat16"))
    # Every case suits the kernel: K % 32 == 0, both operands one type.
    assert all(c[2] % 32 == 0 for c in probe_ab.CASES)
    gen = torch.Generator().manual_seed(0)
    a, b = probe_ab.operands(("small", 5, 64, 3, "int8"), gen, device="cpu")
    assert a.shape == (5, 64) and b.shape == (3, 64)
    assert a.dtype == b.dtype == torch.int8
    assert int(a.min()) >= -127 and int(b.min()) >= -127
    a, b = probe_ab.operands(("small", 5, 64, 3, "bfloat16"), gen, device="cpu")
    assert a.dtype == b.dtype == torch.bfloat16 and b.shape == (3, 64)
    assert torch.equal(bk.matmul_probe(a, b), bk.matmul_probe_plain(a, b))
    if not torch.cuda.is_available():
        assert probe_ab.main([]) == 2


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(33, 64, 17), (129, 160, 257), (1, 32, 1),
                                   (70, 96, 130), (256, 384, 65)])
def test_probe_plain_matches_dot_general(dtype, m, k, n):
    """The port keeps B as (N, K); `mm_kernel` contracts a (M, K) with
    b (K, N): the same product of b's transpose. int8 sums are exact
    int32 on both sides; bf16 operands are exact in float32 and so are
    their products, so the two float32 sums differ by summation order."""
    rng = np.random.default_rng(m * n + k)
    if dtype == "int8":
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (n, k), dtype=np.int8)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ja, jb, acc = jnp.asarray(a), jnp.asarray(b.T), jnp.int32
    else:
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((n, k)).astype(np.float32)
        ta, tb = (torch.from_numpy(x).bfloat16() for x in (a, b))
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b.T, jnp.bfloat16)
        acc = jnp.float32
    ref = np.asarray(jax.lax.dot_general(ja, jb, (((1,), (0,)), ((), ())),
                                         preferred_element_type=acc))
    for got in (bk.matmul_probe_plain(ta, tb), bk.matmul_probe(ta, tb)):
        if dtype == "int8":
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * k ** 0.5)


# csrc/matmul_probe.cu's epilogue constants.
SROW = 128           # staged columns a row
BN = 256             # tile columns


def _wgmma_owner(row, col):
    """Lane and accumulator index holding (row, col) of a warp's 16 x BN
    block in the m64nN wgmma layout: lane 4 g + t holds rows g, g + 8 and
    columns 8 n + 2 t, + 1 as d[4 n + 2 hf + j]."""
    hf, g = divmod(row, 8)
    n, rest = divmod(col, 8)
    t, j = divmod(rest, 2)
    return 4 * g + t, 4 * n + 2 * hf + j


def test_epilogue_staging_is_a_conflict_free_permutation():
    block = np.arange(16 * BN, dtype=np.int64).reshape(16, BN)
    acc = np.zeros((32, BN // 2), np.int64)
    for r in range(16):
        for c in range(BN):
            lane, i = _wgmma_owner(r, c)
            acc[lane, i] = block[r, c]
    out = np.full_like(block, -1)
    for hf in range(2):
        for half in range(BN // SROW):
            stage = np.full(8 * SROW, -1, np.int64)
            for n in range(SROW // 8):  # one 8-byte write a lane
                banks = []
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    q = (2 * n + (t >> 1)) ^ (2 * g)
                    w = g * SROW + 4 * q + 2 * (t & 1)
                    for j in range(2):
                        stage[w + j] = acc[lane, 4 * (n + half * SROW // 8)
                                           + 2 * hf + j]
                    banks.append((w % 32, w % 32 + 1))
                for phase in range(2):  # 16 lanes x 8 bytes a phase
                    seen = [b for pair in banks[16 * phase:16 * phase + 16]
                            for b in pair]
                    assert len(set(seen)) == 32, (n, phase)
            assert (stage >= 0).all()
            for r in range(8):  # one 16-byte read a lane, a row a warp
                words = [r * SROW + 4 * (lane ^ (2 * r)) for lane in range(32)]
                for phase in range(4):  # 8 lanes x 16 bytes a phase
                    seen = {(w + j) % 32 for w in words[8 * phase:8 * phase + 8]
                            for j in range(4)}
                    assert len(seen) == 32, (r, phase)
                for lane in range(32):
                    col = half * SROW + 4 * lane
                    out[8 * hf + r, col:col + 4] = stage[words[lane]:
                                                         words[lane] + 4]
    np.testing.assert_array_equal(out, block)
