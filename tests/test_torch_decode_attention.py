"""Decode attention of the port (haff_tpu_torch/kernels/decode_attention.py)
against haff_tpu/kernels/decode_attention.py on the same seeded numpy
inputs, float32 on the CPU: the plain version (what CPU tensors run, and
the oracle of the CUDA kernel) against JAX's XLA path and against its
Pallas streaming kernel in interpret mode, at cache lengths the Pallas
kernel takes (1024, 2048).

Tolerances as tests/test_decode_attention.py: 2e-5 for a float cache, 2e-4
for an int8 cache (JAX's XLA path multiplies each int8 value by its scale
before the dot; summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.kernels import decode_attention as jda
from haff_tpu.nn import quant as jq
from haff_tpu_torch.kernels import _build
from haff_tpu_torch.kernels import decode_attention as da
from haff_tpu_torch.nn import quant as tq

FP = dict(rtol=2e-5, atol=2e-5)
INT8 = dict(rtol=2e-4, atol=2e-4)


def make_inputs(lmax, nh, nkv, lengths, hd=128, seed=0):
    rng = np.random.RandomState(seed)
    b = len(lengths)
    q = rng.randn(b, nh, hd).astype(np.float32) * 0.3
    k = rng.randn(b, lmax, nkv, hd).astype(np.float32) * 0.3
    v = rng.randn(b, lmax, nkv, hd).astype(np.float32)
    mask = (np.arange(lmax)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    return q, k, v, mask


def _port(q, k, v, mask, quant):
    q, k, v, mask = map(torch.from_numpy, (q, k, v, mask))
    if quant:
        k, v = tq.quantize_activation(k), tq.quantize_activation(v)
    before = dict(_build.LAUNCHES)
    out = da.flash_decode_attention(q, k, v, mask)
    assert dict(_build.LAUNCHES) == before  # CPU tensors: the plain version
    return out.numpy()


def _jax(q, k, v, mask, quant, use_kernel):
    q, k, v, mask = map(jnp.asarray, (q, k, v, mask))
    if quant:
        k, v = jq.quantize_activation(k), jq.quantize_activation(v)
    if use_kernel:
        return np.asarray(jda.flash_decode_attention(
            q, k, v, mask, use_kernel=True, interpret=True))
    return np.asarray(jda._xla_path(q, k, v, mask, q.shape[-1] ** -0.5))


CASES = [
    # lmax, nh, nkv, live lengths (ragged; whole 512-key blocks masked)
    (1024, 8, 4, (515, 1017)),
    (1024, 4, 4, (515, 1017)),
    (2048, 8, 4, (10, 1500)),
    (2048, 8, 8, (2048, 1)),
]


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["xla_path", "pallas_interpret"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("lmax,nh,nkv,lengths", CASES)
def test_plain_version_matches_jax(lmax, nh, nkv, lengths, quant, use_kernel):
    args = make_inputs(lmax, nh, nkv, lengths, seed=lmax + nh)
    ref = _jax(*args, quant, use_kernel)
    got = _port(*args, quant)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **(INT8 if quant else FP))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_short_cache_and_small_heads_match_xla_path(quant):
    """Geometries below the Pallas kernel's guards (Lmax 9, head_dim 16)."""
    args = make_inputs(9, 4, 2, (9, 4), hd=16, seed=4)
    np.testing.assert_allclose(_port(*args, quant),
                               _jax(*args, quant, False),
                               **(INT8 if quant else FP))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_fully_masked_row_gives_zero(quant):
    """As the Pallas kernel (its denominator is clamped); JAX's XLA path
    gives NaN there."""
    q, k, v, mask = make_inputs(1024, 8, 4, (0, 700), seed=9)
    got = _port(q, k, v, mask, quant)
    assert np.isfinite(got).all()
    assert not got[0].any() and got[1].any()
    ref = _jax(q, k, v, mask, quant, use_kernel=True)
    np.testing.assert_allclose(got, ref, **(INT8 if quant else FP))


def test_int8_dequantization_is_not_rounded_to_the_query_dtype():
    """A bfloat16 query over an int8 cache: the cache is dequantized to
    float32 (value times scale), as the Pallas kernel does, not rounded to
    bfloat16 first."""
    q, k, v, mask = make_inputs(64, 4, 4, (64, 30), hd=32, seed=2)
    tk, tv = (tq.quantize_activation(torch.from_numpy(a)) for a in (k, v))
    qb = torch.from_numpy(q).bfloat16()
    got = da.flash_decode_attention(qb, tk, tv, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    exact = da.decode_attention_plain(
        qb.float(), da.dequantize_cache(tk), da.dequantize_cache(tv),
        torch.from_numpy(mask), 32 ** -0.5)
    assert torch.equal(got, exact.bfloat16())


def test_kernel_wrapper_refuses_cpu_tensors_and_mixed_caches():
    q, k, v, mask = map(torch.from_numpy, make_inputs(16, 4, 4, (16, 3),
                                                      hd=16))
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_kernel(q, k, v, mask, 0.25)
    with pytest.raises(TypeError, match="different kinds"):
        da.decode_attention_kernel(q, tq.quantize_activation(k), v, mask, 0.25)
    with pytest.raises(RuntimeError, match="forward-only"):
        da.decode_attention_kernel(q.requires_grad_(), k, v, mask, 0.25)
