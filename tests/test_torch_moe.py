"""The port's MoE decoder MLP (haff_tpu_torch/nn/moe.py) against
haff_tpu's (haff_tpu/nn/moe.py) on the CPU in float32: the same seeded
inputs, the JAX module's initialized weights carried into the port by the
bridge's rule (tools/bridge.py), every case of tests/test_moe.py but the
expert-parallel one (the port runs on one card):

* the per-token brute-force oracle at top-2 and top-1, both modules;
* E = 1 equal to the dense LlamaMLP;
* capacity overflow dropping tokens to the residual;
* the Switch aux term 1.0 at zero input, and against JAX's sown value;
* router and expert gradients against `jax.grad`;
* per-row `no_drop` independent of the co-batch, and equal to the oracle
  without capacity;
* `token_mask`: padding takes no slot, gets zero output, and leaves the
  live tokens' outputs alone;
* a long row (l > 64) routed per row with the capacity factor.

Tolerances: outputs 1e-5 abs + 1e-4 rel, gradients 1e-4, aux 1e-6.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import LlamaConfig as JaxLlamaConfig
from haff_tpu.nn.moe import MoEMLP as JaxMoEMLP
from haff_tpu_torch.core.config import LlamaConfig
from haff_tpu_torch.nn.llama import LlamaMLP
from haff_tpu_torch.nn.moe import MoEMLP, moe_layers
from haff_tpu_torch.tools.bridge import flax_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-5)


def _kw(**kw):
    base = dict(hidden_size=8, intermediate_size=16, num_layers=2,
                num_heads=2, num_kv_heads=2, head_dim=4, vocab_size=64,
                max_seq_len=32, moe_num_experts=4, moe_top_k=2,
                moe_capacity_factor=2.0)
    base.update(kw)
    return base


def _pair(b=2, l=8, seed=0, **kw):
    """(JAX cfg, JAX module, params, port module, x as numpy)."""
    jcfg = JaxLlamaConfig(**_kw(**kw))
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, l, jcfg.hidden_size)).astype(np.float32)
    jmod = JaxMoEMLP(cfg=jcfg)
    params = jax.tree_util.tree_map(np.asarray, fnn.unbox(
        jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]))
    port = MoEMLP(LlamaConfig(**_kw(**kw)))
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    return jcfg, jmod, params, port, x


def _port(port, x, mask=None, no_drop=False):
    m = None if mask is None else torch.from_numpy(np.asarray(mask))
    y, aux = port(torch.from_numpy(x), m, no_drop=no_drop)
    return y.detach().numpy(), float(aux.detach())


def _jax(jmod, params, x, mask=None, no_drop=False):
    mod = jmod.clone(no_drop=no_drop)
    y, mut = mod.apply({"params": params}, jnp.asarray(x),
                       None if mask is None else jnp.asarray(mask),
                       mutable=("moe_aux",))
    return np.asarray(y), float(jax.tree_util.tree_leaves(mut["moe_aux"])[0])


def _brute_force(cfg, params, x, capacity=True):
    """Per-token numpy oracle, k-major priority; `capacity` False is the
    no-drop routing of a short row."""
    d = cfg.hidden_size
    E, K = cfg.moe_num_experts, min(cfg.moe_top_k, cfg.moe_num_experts)
    xt = np.asarray(x, np.float64).reshape(-1, d)
    n = xt.shape[0]
    logits = xt @ np.asarray(params["router"]["kernel"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :K]
    gates = np.take_along_axis(probs, idx, axis=-1)
    if K > 1:
        gates = gates / (gates.sum(-1, keepdims=True) + 1e-9)
    cap = (max(1, int(np.ceil(K * n / E * cfg.moe_capacity_factor)))
           if capacity else n)
    counts = np.zeros(E, np.int64)
    wg, wu, wd = (np.asarray(params[k], np.float64)
                  for k in ("gate_proj", "up_proj", "down_proj"))
    y = np.zeros_like(xt)
    for k in range(K):
        for t in range(n):
            e = idx[t, k]
            if counts[e] < cap:
                counts[e] += 1
                g = xt[t] @ wg[e]
                h = g / (1 + np.exp(-g)) * (xt[t] @ wu[e])
                y[t] += gates[t, k] * (h @ wd[e])
    return y.reshape(x.shape)


def test_bridge_loads_the_flax_moe_leaves():
    _, _, params, port, _ = _pair()
    sd = flax_to_state_dict(params)
    assert set(sd) == {"router.weight", "gate_proj", "up_proj", "down_proj"}
    np.testing.assert_array_equal(port.router.weight.detach().numpy(),
                                  params["router"]["kernel"].T)
    for k in ("gate_proj", "up_proj", "down_proj"):
        np.testing.assert_array_equal(getattr(port, k).detach().numpy(),
                                      params[k])


@pytest.mark.parametrize("kw,b,l,seed", [
    (dict(), 2, 8, 0),
    (dict(moe_top_k=1, moe_num_experts=3, moe_capacity_factor=1.5), 1, 12, 3),
], ids=["top2", "top1"])
def test_moe_matches_jax_and_bruteforce(kw, b, l, seed):
    cfg, jmod, params, port, x = _pair(b, l, seed, **kw)
    got, aux = _port(port, x)
    ref, jaux = _jax(jmod, params, x)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, _brute_force(cfg, params, x), **TOL)
    np.testing.assert_allclose(aux, jaux, rtol=0, atol=1e-6)


def test_single_expert_equals_dense_mlp():
    _, jmod, params, port, x = _pair(moe_num_experts=1, moe_top_k=1,
                                     moe_capacity_factor=100.0)
    dense = LlamaMLP(LlamaConfig(**_kw()))
    dense.load_state_dict({f"{k}.weight": torch.tensor(params[k][0].T)
                           for k in ("gate_proj", "up_proj", "down_proj")})
    want = dense(torch.from_numpy(x)).detach().numpy()
    got, _ = _port(port, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax(jmod, params, x)[0], **TOL)


def test_capacity_overflow_drops_tokens():
    # One slot an expert: of 16 top-1 tokens over 2 experts at most 2 get
    # expert output, the rest exactly zero (residual pass-through).
    _, jmod, params, port, x = _pair(moe_num_experts=2, moe_top_k=1,
                                     moe_capacity_factor=2 / 16)
    got, _ = _port(port, x)
    nonzero = int((np.abs(got.reshape(-1, 8)).sum(-1) > 0).sum())
    assert 0 < nonzero <= 2, nonzero
    np.testing.assert_allclose(got, _jax(jmod, params, x)[0], **TOL)


def test_aux_is_one_at_zero_input():
    # Uniform router probabilities: E * sum(f_e / E) = 1 at any tie-break.
    _, jmod, params, port, x = _pair()
    x0 = np.zeros_like(x)
    _, aux = _port(port, x0)
    np.testing.assert_allclose(aux, 1.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux, _jax(jmod, params, x0)[1], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("no_drop", [False, True], ids=["pooled", "per_row"])
def test_gradients_match_jax(no_drop):
    _, jmod, params, port, x = _pair()
    mod = jmod.clone(no_drop=no_drop)

    def loss(p, xx):
        y, mut = mod.apply({"params": p}, xx, mutable=("moe_aux",))
        aux = jax.tree_util.tree_leaves(mut["moe_aux"])[0]
        return jnp.sum(y ** 2) + 0.5 * aux

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = port(xt, no_drop=no_drop)
    ((y ** 2).sum() + 0.5 * aux).backward()
    ref = flax_to_state_dict(gp)
    for name, p in port.named_parameters():
        r = ref[name].numpy()
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)


def test_per_row_no_drop_is_co_batch_independent():
    cfg, jmod, params, port, x = _pair(b=3, l=6)
    y_all, _ = _port(port, x, no_drop=True)
    for r in range(3):
        y_one, _ = _port(port, x[r:r + 1], no_drop=True)
        np.testing.assert_allclose(y_all[r], y_one[0], rtol=1e-5, atol=1e-6,
                                   err_msg=f"row {r} depends on co-batch")
    np.testing.assert_allclose(y_all, _jax(jmod, params, x, no_drop=True)[0],
                               **TOL)
    np.testing.assert_allclose(y_all, _brute_force(cfg, params, x, False),
                               **TOL)


@pytest.mark.parametrize("no_drop", [False, True], ids=["pooled", "per_row"])
def test_token_mask_excludes_padding(no_drop):
    _, jmod, params, port, x = _pair(moe_capacity_factor=0.6)
    mask = np.array([[1, 1, 1, 1, 1, 0, 0, 0],
                     [1, 1, 1, 0, 0, 0, 0, 0]]) > 0
    y1, aux = _port(port, x, mask, no_drop)
    ref, jaux = _jax(jmod, params, x, mask, no_drop)
    np.testing.assert_allclose(y1, ref, **TOL)
    np.testing.assert_allclose(aux, jaux, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y1[~mask], np.zeros_like(y1[~mask]))
    noise = np.random.default_rng(9).standard_normal(x.shape) * 10
    x2 = np.where(mask[..., None], x, x + noise).astype(np.float32)
    y2, aux2 = _port(port, x2, mask, no_drop)
    np.testing.assert_allclose(y1[mask], y2[mask], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, aux2, rtol=0, atol=1e-6)
    _, aux_full = _port(port, x, np.ones_like(mask), no_drop)
    assert np.isfinite(aux) and aux > 0 and aux != aux_full


def test_long_row_uses_the_capacity_factor():
    cfg, jmod, params, port, _ = _pair(b=1, l=8)
    x = np.random.default_rng(3).standard_normal(
        (2, 96, cfg.hidden_size)).astype(np.float32)
    y_all, _ = _port(port, x, no_drop=True)
    y_one, _ = _port(port, x[:1], no_drop=True)
    np.testing.assert_allclose(y_all[0], y_one[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y_all, _jax(jmod, params, x, no_drop=True)[0],
                               **TOL)
    # capacity ceil(2 * 96 / 4 * 2.0) = 96 = l: nothing drops here; at
    # factor 0.5 (24 slots) some tokens do, deterministically per row.
    port.cfg = LlamaConfig(**_kw(moe_capacity_factor=0.5))
    jmod = jmod.clone(cfg=JaxLlamaConfig(**_kw(moe_capacity_factor=0.5)))
    y_tight, _ = _port(port, x, no_drop=True)
    np.testing.assert_allclose(y_tight, _jax(jmod, params, x,
                                             no_drop=True)[0], **TOL)
    assert not np.allclose(y_tight, y_all)


@pytest.mark.parametrize("every,want", [(1, (0, 1, 2, 3)), (2, (1, 3)),
                                        (3, (2,))])
def test_moe_layers_interleave(every, want):
    cfg = LlamaConfig(**_kw(num_layers=4, moe_every=every))
    assert moe_layers(cfg) == want
    assert moe_layers(LlamaConfig(**_kw(moe_num_experts=0))) == ()
