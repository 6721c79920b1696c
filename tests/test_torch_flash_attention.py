"""The plain version of the port's flash-prefill kernel
(haff_tpu_torch/kernels/flash_attention.py) against the JAX Pallas
`flash_attention._fwd_kernel` it replaces, run in interpret mode: causal
masking, ragged right-padded segment ids (one row padded by more than a
tile), a fully-masked query row, an additive bias, and the lse.

float32 on both sides; tolerance 2e-5 abs + rel (summation order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu_torch.kernels import flash_attention as tfa

# haff_tpu.kernels re-exports the function under the module's name.
jfa = importlib.import_module("haff_tpu.kernels.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, l, h, d, seed, lengths):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    seg = (np.arange(l)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, seg


@pytest.mark.parametrize("causal,with_bias", [(True, False), (True, True),
                                              (False, False)])
def test_plain_matches_pallas_fwd_with_lse(causal, with_bias):
    b, l, h, d, blk = 3, 32, 2, 16, 8
    # Row 1 is padded by 13 > one 8-row tile; row 2 ends in padding, and its
    # pad queries are fully masked (segment 0 sees nothing).
    q, k, v, seg = _inputs(b, l, h, d, 0, lengths=[32, 19, 30])
    bias = None
    if with_bias:
        bias = (0.5 * np.random.default_rng(1).standard_normal(
            (1, h, l, l))).astype(np.float32)
    out, lse = jfa._fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.broadcast_to(jnp.asarray(bias),
                                                   (b, h, l, l)),
        jnp.asarray(seg), jnp.asarray(seg), causal, d ** -0.5, blk, blk, True)
    got, got_lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias),
        q_segment_ids=torch.from_numpy(seg), causal=causal, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse).reshape(b, h, l), **TOL)
    # Fully-masked query rows: output 0 and lse 0.
    assert not got[1, 19:].any() and not got_lse[1, :, 19:].any()


@pytest.mark.parametrize("l", [5, 23])
def test_plain_matches_public_flash_attention_ragged(l):
    """Lengths below 8 and off the tile (the JAX entry point falls back or
    pads; the port's kernel masks the ragged edge itself)."""
    b, h, d = 2, 4, 16
    q, k, v, seg = _inputs(b, l, h, d, l, lengths=[l, l - 2])
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_segment_ids=jnp.asarray(seg), causal=True,
                              interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              q_segment_ids=torch.from_numpy(seg), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_causal_offset_for_shorter_queries():
    """Lq < Lk: query i sees keys up to i + (Lk - Lq), as JAX mha_reference."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 3, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 7, 2, 8)).astype(np.float32)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    got = tfa.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_version():
    before = dict(tfa._build.LAUNCHES)
    x = torch.zeros(1, 4, 2, 8)
    assert tfa.flash_attention(x, x, x, causal=True).shape == x.shape
    assert dict(tfa._build.LAUNCHES) == before
