"""The backward of the port's flash attention
(haff_tpu_torch/kernels/flash_attention.py: `attention_bwd_plain` behind
`FlashAttentionFn`, the CPU route of the `flash_bwd_dq` / `flash_bwd_dkv`
kernels) against the JAX package's gradients:

* `jax.grad` of the Pallas `flash_attention` (its `_bwd_dq_kernel` /
  `_bwd_dkv_kernel`, interpret mode) at aligned lengths, causal and not,
  with right-padded segment ids and a constant bias;
* `jax.grad` of `mha_reference` at ragged lengths (5, 9, 70), where the
  JAX entry point pads or falls back and the port masks the edge itself;
* the autograd rule against torch autograd through `attention_plain`.

float32 on both sides; tolerance 1e-4 abs + rel (summation order over up
to 128 keys).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("haff_tpu.kernels.flash_attention")

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, l, h, d, seed, lengths, bias):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, l, h, d)).astype(np.float32)
                  for _ in range(4))
    seg = (np.arange(l)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    bias_arr = ((0.5 * rng.standard_normal((1, h, l, l))).astype(np.float32)
                if bias else None)
    return q, k, v, g, seg, bias_arr


def _port_grads(q, k, v, g, seg, bias, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(
        qt, kt, vt, bias=None if bias is None else torch.from_numpy(bias),
        q_segment_ids=None if seg is None else torch.from_numpy(seg),
        causal=causal)
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))


def _jax_grads(fn, q, k, v, g):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * g)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("l,d,causal,bias", [(64, 16, True, False),
                                             (128, 32, True, True),
                                             (64, 32, False, True),
                                             (128, 16, False, False)])
def test_grads_match_pallas_backward(l, d, causal, bias):
    b, h = 2, 2
    # Row 1 is right-padded by 19 tokens: its pad queries are fully masked.
    q, k, v, g, seg, bias_arr = _inputs(b, l, h, d, l + d, [l, l - 19], bias)

    def jfn(q, k, v):
        return jfa.flash_attention(
            q, k, v, bias=None if bias_arr is None else jnp.asarray(bias_arr),
            q_segment_ids=jnp.asarray(seg), causal=causal, interpret=True)

    ref = _jax_grads(jfn, q, k, v, g)
    got = _port_grads(q, k, v, g, seg, bias_arr, causal)
    for name, r, t in zip("qkv", ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
    # Pad queries see nothing: exactly-zero dq; pad keys: zero dk, dv.
    assert not got[0][1, l - 19:].any()
    assert not got[1][1, l - 19:].any() and not got[2][1, l - 19:].any()


@pytest.mark.parametrize("l", [5, 9, 70])
def test_grads_match_reference_ragged(l):
    b, h, d = 2, 3, 16
    q, k, v, g, seg, _ = _inputs(b, l, h, d, l, [l, max(l - 3, 1)], False)

    def jfn(q, k, v):
        return jfa.mha_reference(q, k, v, q_segment_ids=jnp.asarray(seg),
                                 kv_segment_ids=jnp.asarray(seg), causal=True)

    ref = _jax_grads(jfn, q, k, v, g)
    got = _port_grads(q, k, v, g, seg, None, True)
    for name, r, t in zip("qkv", ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal,seg,bias", [(True, True, True),
                                             (False, False, False),
                                             (True, False, False)])
def test_autograd_rule_matches_torch_autograd(causal, seg, bias):
    """Lq < Lk exercises the causal offset; torch autograd through the
    plain forward is the oracle (float64 inputs, float32 arithmetic)."""
    rng = np.random.default_rng(11)
    b, lq, lk, h, d = 2, 7, 12, 2, 8
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s)).requires_grad_()
    q, k, v = mk(b, lq, h, d), mk(b, lk, h, d), mk(b, lk, h, d)
    qs = ks = None
    if seg:
        qs = torch.ones(b, lq, dtype=torch.int32)
        ks = torch.ones(b, lk, dtype=torch.int32)
        qs[1, 5:] = 0
        ks[1, 9:] = 0
    bias_t = torch.from_numpy(rng.standard_normal((1, h, 1, lk))) if bias else None
    g = torch.from_numpy(rng.standard_normal((b, lq, h, d)))
    out = tfa.flash_attention(q, k, v, bias_t, qs, ks, causal)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), g)
    ref_out = tfa.attention_plain(q, k, v, bias_t, qs, ks, causal)[0]
    ref = torch.autograd.grad(ref_out, (q, k, v), g)
    for name, r, t in zip("qkv", ref, got):
        torch.testing.assert_close(t, r, rtol=1e-5, atol=1e-5, msg=name)


def test_no_grad_mode_skips_the_autograd_rule():
    x = torch.zeros(1, 4, 2, 8, requires_grad=True)
    with torch.no_grad():
        assert tfa.flash_attention(x, x, x, causal=True).grad_fn is None
    assert tfa.flash_attention(x.detach(), x.detach(), x.detach()).grad_fn is None


@pytest.mark.parametrize("causal", [True, False])
def test_per_kernel_plain_versions_split_the_backward(causal):
    """`attention_bwd_dq_plain` and `attention_bwd_dkv_plain`, the plain
    versions of the two kernels, give exactly the three gradients of
    `attention_bwd_plain`."""
    q, k, v, g, seg, bias = (None if x is None else torch.from_numpy(x)
                             for x in _inputs(2, 9, 2, 8, 5, [9, 6], True))
    out, lse = tfa.attention_plain(q, k, v, bias, seg, seg, causal)
    args = (q, k, v, bias, seg, seg, out, lse, g, causal)
    dq, dk, dv = tfa.attention_bwd_plain(*args)
    assert torch.equal(tfa.attention_bwd_dq_plain(*args), dq)
    got_dk, got_dv = tfa.attention_bwd_dkv_plain(*args)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
