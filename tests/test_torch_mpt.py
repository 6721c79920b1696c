"""The port's MPT decoder (haff_tpu_torch/nn/mpt.py) against
haff_tpu/nn/mpt.py at the tiny preset in float32, with the same seeded
weights (bridged) and inputs, as the cases of tests/test_mpt.py: the
ALiBi slopes (a power of two and 12 heads), the column bias against the
full bias under softmax, prefill and one-token decode with and without
multi-query attention, clip_qkv and qk_ln, prefix-LM, attn_impl "torch"
against "flash", and the decode attention's plain version with slopes
against JAX's decode step (`mha_reference` with the column bias over the
cache). JAX runs its Pallas flash kernel in interpret mode on the CPU.

Tolerance 1e-4 abs + rel (float32, summation order) unless a case says
otherwise; the slopes within 1e-6 (float32 pow on both sides).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.kernels.flash_attention import mha_reference as jmha
from haff_tpu.nn import mpt as jmpt
from haff_tpu.nn import quant as jq
from haff_tpu_torch.kernels import _build
from haff_tpu_torch.kernels import decode_attention as da
from haff_tpu_torch.nn import mpt as tmpt
from haff_tpu_torch.nn import quant as tq
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from test_torch_bridge import random_like

TOL = dict(rtol=1e-4, atol=1e-4)
B, L = 2, 12


def both(seed=0, **knobs):
    """(JAX model, its seeded params, the port's model with them), tiny."""
    jcfg = dataclasses.replace(jmpt.MptConfig.preset("tiny"), **knobs)
    jmodel = jmpt.MptForCausalLM(cfg=jcfg)
    ids = jnp.zeros((1, L), jnp.int32)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, ids, method="init_all"),
        jax.random.PRNGKey(0))
    params = random_like(fnn.unbox(shapes)["params"], seed)
    port = tmpt.MptForCausalLM(dataclasses.replace(
        tmpt.MptConfig.preset("tiny"), **knobs))
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    return jmodel, {"params": params}, port


def ids_for(cfg, seed=0, b=B, n=L):
    return np.random.RandomState(seed).randint(2, cfg.vocab_size, (b, n))


def jax_forward(jmodel, params, ids, **kw):
    emb = jmodel.apply(params, jnp.asarray(ids, jnp.int32), method="embed")
    logits, hidden, _ = jmodel.apply(params, emb, **kw)
    return np.asarray(logits), np.asarray(hidden)


@torch.inference_mode()
def port_forward(port, ids, **kw):
    logits, hidden, _ = port(port.embed(torch.as_tensor(ids)), **kw)
    return logits.numpy(), hidden.numpy()


@pytest.mark.parametrize("nh", [8, 12, 32])
def test_alibi_slopes(nh):
    got = tmpt.alibi_slopes(nh).numpy()
    np.testing.assert_allclose(got, np.asarray(jmpt.alibi_slopes(nh)),
                               rtol=1e-6, atol=0)
    if nh == 8:
        np.testing.assert_array_equal(got, 2.0 ** -np.arange(1, 9))


def test_column_bias_equals_full_bias_under_softmax():
    nh, n = 4, 16
    col = tmpt.alibi_column_bias(nh, n)
    assert col.shape == (1, nh, 1, n)
    np.testing.assert_allclose(col.numpy(),
                               np.asarray(jmpt.alibi_column_bias(nh, n)),
                               rtol=1e-6, atol=1e-6)
    slopes = tmpt.alibi_slopes(nh)
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(nh, n, n).astype(np.float32))
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    full = logits - slopes[:, None, None] * (i - j)
    causal = j <= i
    pa = torch.softmax(torch.where(causal, full, -1e9), -1)
    pb = torch.softmax(torch.where(causal, logits + col[0], -1e9), -1)
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("multiquery", [False, True])
def test_prefill_and_decode_match_jax(multiquery):
    """The full forward against JAX's; then a prefill of 8 tokens into a
    cache and 4 one-token decode steps (the decode attention's plain
    version with the slopes), each step's logits against JAX's own
    decode step and against the full forward's row."""
    jmodel, params, port = both(multiquery=multiquery)
    ids = ids_for(port.cfg)
    ref, ref_h = jax_forward(jmodel, params, ids,
                             segment_ids=jnp.ones((B, L), jnp.int32))
    got, got_h = port_forward(port, ids, segment_ids=torch.ones(B, L))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got_h, ref_h, **TOL)

    p, max_len = 8, L
    jemb = jmodel.apply(params, jnp.asarray(ids, jnp.int32), method="embed")
    jcaches = jmodel.apply(params, B, max_len, jnp.float32,
                           method="init_kv_caches")
    _, _, jcaches = jmodel.apply(params, jemb[:, :p], None,
                                 jnp.ones((B, p), jnp.int32),
                                 kv_caches=jcaches,
                                 cache_index=jnp.zeros((B,), jnp.int32))
    caches = port.init_kv_caches(B, max_len, torch.float32)
    nkv = 1 if multiquery else port.cfg.n_heads
    assert caches[0][0].shape == (B, max_len, nkv, port.cfg.head_dim)
    emb = port.embed(torch.as_tensor(ids))
    with torch.inference_mode():
        port(emb[:, :p], None, torch.ones(B, p), caches,
             torch.zeros(B, dtype=torch.long))
        kv_seg = (torch.arange(max_len)[None] < p).int().repeat(B, 1)
        before = dict(_build.LAUNCHES)
        for t in range(p, L):
            kv_seg[:, t] = 1
            lg, _, _ = port(emb[:, t:t + 1], None, None, caches,
                            torch.full((B,), t), kv_seg)
            jl, _, jcaches = jmodel.apply(
                params, jemb[:, t:t + 1], None, None, kv_caches=jcaches,
                cache_index=jnp.full((B,), t, jnp.int32),
                cache_kv_segment_ids=jnp.asarray(kv_seg.numpy()))
            np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(jl[:, 0]),
                                       **TOL)
            np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, t],
                                       rtol=3e-4, atol=3e-4)
        assert dict(_build.LAUNCHES) == before  # CPU: plain versions only


@pytest.mark.parametrize("knobs", [dict(clip_qkv=0.05), dict(clip_qkv=1e6),
                                   dict(qk_ln=True)],
                         ids=["clip_qkv_tight", "clip_qkv_loose", "qk_ln"])
def test_attn_config_knobs_match_jax(knobs):
    jmodel, params, port = both(seed=1, **knobs)
    if knobs.get("qk_ln"):
        assert {"q_ln", "k_ln"} <= set(params["params"]["blocks_0"]["attn"])
    ids = ids_for(port.cfg, seed=1)
    ref, _ = jax_forward(jmodel, params, ids)
    got, _ = port_forward(port, ids)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_prefix_lm_matches_jax():
    jmodel, params, port = both(seed=2, prefix_lm=True, attn_impl="torch")
    ids = ids_for(port.cfg, seed=2, b=1, n=10)
    prefix = np.zeros((1, 10), np.int32)
    prefix[:, :4] = 1
    ref, _ = jax_forward(jmodel, params, ids, prefix_mask=jnp.asarray(prefix))
    got, _ = port_forward(port, ids, prefix_mask=torch.from_numpy(prefix))
    np.testing.assert_allclose(got, ref, **TOL)
    causal, _ = port_forward(port, ids)
    assert not np.allclose(got[0, :3], causal[0, :3])  # the prefix is seen
    zero, _ = port_forward(port, ids, prefix_mask=torch.zeros(1, 10))
    np.testing.assert_allclose(zero, causal, rtol=2e-5, atol=2e-5)


def test_attn_impl_torch_matches_flash():
    jmodel, params, port = both(seed=3)
    ids = ids_for(port.cfg, seed=3, n=16)
    flash, _ = port_forward(port, ids)
    port.cfg = dataclasses.replace(port.cfg, attn_impl="torch")
    for block in port.blocks:
        block.attn.cfg = port.cfg
    dense, _ = port_forward(port, ids)
    np.testing.assert_allclose(dense, flash, rtol=2e-4, atol=2e-4)
    ref, _ = jax_forward(jmodel, params, ids)
    np.testing.assert_allclose(flash, ref, **TOL)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_decode_plain_with_slopes_matches_jax_step(kind):
    """One MPT decode step's attention: JAX's `mha_reference` with the
    column bias over the (dequantized) cache and the live-slot mask,
    against the port's plain version and its split algorithm with the
    slopes (what the kernel computes), 12 heads (interleaved slopes),
    ragged live lengths, a row with no live slot giving 0."""
    rng = np.random.RandomState(5)
    b, lmax, nh, hd = 3, 40, 12, 32
    q = rng.randn(b, nh, hd).astype(np.float32) * 0.5
    k = rng.randn(b, lmax, nh, hd).astype(np.float32) * 0.5
    v = rng.randn(b, lmax, nh, hd).astype(np.float32)
    mask = (np.arange(lmax)[None] < np.array([[40], [17], [0]])).astype(
        np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "int8":
        qk, qv = jq.quantize_activation(jk), jq.quantize_activation(jv)
        jk = jq.dequantize_activation(qk, jnp.float32)
        jv = jq.dequantize_activation(qv, jnp.float32)
        tk, tv = tq.quantize_activation(tk), tq.quantize_activation(tv)
        np.testing.assert_array_equal(tk.values.numpy(), np.asarray(qk.values))
    ref = np.asarray(jmha(
        jnp.asarray(q)[:, None], jk, jv,
        bias=jmpt.alibi_column_bias(nh, lmax),
        q_segment_ids=jnp.ones((b, 1), jnp.int32),
        kv_segment_ids=jnp.asarray(mask), causal=False))[:, 0]
    slopes = tmpt.alibi_slopes(nh)
    tq_, tmask = torch.from_numpy(q), torch.from_numpy(mask)
    got = da.flash_decode_attention(tq_, tk, tv, tmask, slopes=slopes).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[2].any()
    split = da.decode_attention_split(tq_, tk, tv, tmask, hd ** -0.5,
                                      plan=(4, 10), slopes=slopes)
    np.testing.assert_allclose(split.numpy(), ref, **TOL)
    plain = da.decode_attention_plain(tq_, tk, tv, tmask, hd ** -0.5)
    assert not np.allclose(plain.numpy()[:2], ref[:2])  # the slopes matter
